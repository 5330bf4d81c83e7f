"""The port's cross-silo federation against the JAX package's, and its own
invariants.

Parity: the LR on ``blob`` (dim 256, 10 classes, 8 clients, 4 silos,
shuffle off, so no RNG stream enters local training) through the JAX
package's ``run_fedavg_cross_silo`` and the port's, from the same
(converted) initial weights, 3 rounds, under ``none`` and ``topk_ef``
(neither draws random bits). Tolerance atol 1e-5: the sums are taken in
another order (torch vs XLA matmuls, a fold vs XLA's fused fold). Under
``topk_ef`` a near-tie in |delta| could flip the top-k selection between
the two; the test reports such a flip as its failure message.

No round-level parity under int8: flax orders leaves by name and keeps a
Dense kernel ``[in, out]``, while the port's state dict keeps ``[out,
in]``, so the 512-value blocks hold different values. Instead a replay
test pins the threaded federation to a hand-written loop of the port's own
steps, bit for bit, under ``delta_int8`` and ``topk_ef_int8``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg_cross_silo import \
    run_fedavg_cross_silo as jax_run_cross_silo
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.comm.compression import (compress_for_policy,
                                              decompress, is_compressed,
                                              to_numpy, tree_to_device)
from fedml_tpu_torch.comm.policy import resolve_compression
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.sampling import (derive_seed, make_generator,
                                           round_keys, sample_clients)
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops import quantize as tq
from fedml_tpu_torch.ops import sparsify as tsp
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule,
                                                make_local_train)
from fedml_tpu_torch.utils.convert import flax_to_state_dict
from fedml_tpu_torch.utils.metrics import read_metrics
from fedml_tpu_torch.utils.tracing import RoundTimer

BLOB = dict(client_num=8, dim=256, class_num=10, seed=2)
TRAIN = dict(epochs=1, batch_size=16, lr=0.1, shuffle=False)
SILOS, ROUNDS = 4, 3


def _lr(ds):
    return create_model("lr", ds.class_num,
                        input_shape=ds.train_data_global[0].shape[1:])


def _jax_run(policy):
    jds = jax_blob(**BLOB)
    flax_model = FlaxLR(num_classes=jds.class_num)
    init = flax_model.init(jax.random.key(0),
                           jnp.asarray(jds.train_data_global[0][:1]),
                           train=False)
    model, history = jax_run_cross_silo(
        jds, flax_model, worker_num=SILOS, comm_round=ROUNDS,
        train_cfg=JaxTrainConfig(**TRAIN), compression=policy,
        join_timeout_s=300)
    return init, model, history


@pytest.mark.parametrize("policy", ["none", "topk_ef"])
def test_federation_matches_jax_cross_silo(policy):
    jinit, jmodel, jhist = _jax_run(policy)
    ds = make_blob_federated(**BLOB)
    model = _lr(ds)
    init = flax_to_state_dict(jax.tree.map(np.asarray, jinit), model)
    final, hist = cs.run_fedavg_cross_silo(
        ds, model, worker_num=SILOS, comm_round=ROUNDS,
        train_cfg=TrainConfig(**TRAIN), compression=policy, device="cpu",
        init_variables=init, join_timeout_s=300)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jmodel), model)
    assert [r["round"] for r in hist] == [r["round"] for r in jhist] == [
        0, 1, 2]
    for k in want:
        diff = float((final[k] - want[k]).abs().max())
        assert diff <= 1e-5, (
            f"{k}: max abs diff {diff:.3g} under {policy}"
            + (": a near-tie in |delta| flipped the top-k selection between "
               "the two packages" if policy == "topk_ef" and diff > 1e-3
               else ""))
    for got, exp in zip(hist, jhist):
        # the loss is ~1e-4 on this separable blob: an absolute bound
        np.testing.assert_allclose(got["test_loss"], exp["test_loss"],
                                   rtol=1e-5, atol=1e-7)
        assert got["test_acc"] == pytest.approx(exp["test_acc"], abs=1e-9)


def _replay(ds, model, policy_name, rounds, silos, seed=0):
    """The federation written out as a plain loop of the port's own steps:
    broadcast (full, then the mirror delta), each silo's apply, local
    train and uplink encode, the server's decode against the mirror and the
    fold in ascending worker order."""
    pol = resolve_compression(policy_name)
    cfg = TrainConfig(**TRAIN)
    local_train = make_local_train(model, "classification", cfg)
    n_pad = ds.padded_len(cfg.batch_size)
    glob = cs._initial_model(model, seed, torch.device("cpu"), None)
    mirror, held, residual = None, {}, {}
    for r in range(rounds):
        idxs = sample_clients(r, ds.client_num, silos)
        if r == 0:
            payload = to_numpy(glob)
            mirror = glob
        else:
            gen = make_generator(derive_seed(cs.DOWNLINK_SEED_TAG, r))
            payload, _ = compress_for_policy(glob, mirror, None, gen, pol)
            mirror = decompress(payload, mirror)
        replies = []
        for rank in range(1, silos + 1):
            held[rank] = (decompress(payload, held[rank])
                          if is_compressed(payload)
                          else tree_to_device(payload, torch.device("cpu")))
            c = int(idxs[rank - 1])
            x, y, mask = ds.pack_clients([c], cfg.batch_size, n_pad=n_pad)
            _, (s,), _ = round_keys(seed, r, [c])
            sched = make_batch_schedule(n_pad, cfg.epochs, cfg.batch_size,
                                        cfg.shuffle, s, mask[0])
            new, _ = local_train(held[rank], torch.from_numpy(x[0]),
                                 torch.from_numpy(y[0]),
                                 torch.from_numpy(mask[0]), s,
                                 schedule=sched)
            gen = make_generator(derive_seed(cs.UPLINK_SEED_TAG, r, rank))
            up, residual[rank] = compress_for_policy(
                new, held[rank], residual.get(rank), gen, pol)
            replies.append((decompress(up, mirror),
                            np.float32(ds.train_data_local_num_dict[c])))
        acc = pt.tree_weighted_fold_init(*replies[0])
        total = replies[0][1]
        for m, w in replies[1:]:
            acc = pt.tree_weighted_fold_step(acc, m, w)
            total = np.float32(total + w)
        glob = pt.tree_fold_finish(acc, total)
    return glob


@pytest.mark.parametrize("policy", ["delta_int8", "topk_ef_int8:0.05"])
def test_threaded_federation_equals_its_step_by_step_replay(policy):
    ds = make_blob_federated(**BLOB)
    final, _ = cs.run_fedavg_cross_silo(
        ds, _lr(ds), worker_num=SILOS, comm_round=ROUNDS,
        train_cfg=TrainConfig(**TRAIN), compression=policy, device="cpu",
        join_timeout_s=300)
    want = _replay(ds, _lr(ds), policy, ROUNDS, SILOS)
    assert list(final) == list(want)
    for k in want:
        assert torch.equal(final[k].view(torch.int32),
                           want[k].view(torch.int32)), k


def test_many_silos_on_a_short_switch_interval_equal_the_replay():
    """Stress: more silo threads than cores, the interpreter switching
    threads every microsecond; the result is still the replay's, bit for
    bit (arrival order never reaches the fold)."""
    import sys
    ds = make_blob_federated(client_num=20, dim=64, class_num=4, seed=3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        final, _ = cs.run_fedavg_cross_silo(
            ds, _lr(ds), worker_num=16, comm_round=2,
            train_cfg=TrainConfig(**TRAIN), compression="delta_int8",
            device="cpu", join_timeout_s=120)
    finally:
        sys.setswitchinterval(old)
    want = _replay(ds, _lr(ds), "delta_int8", 2, 16)
    for k in want:
        assert torch.equal(final[k].view(torch.int32),
                           want[k].view(torch.int32)), k


def _count_calls(monkeypatch):
    """Count the quantize/dequantize wrapper calls (on the CPU they run the
    plain versions, which do not count as launches)."""
    calls = {"q": 0, "dq": 0}

    def wrap(fn, key):
        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return counted
    quant = wrap(tq.quantize_int8, "q")
    dequant = wrap(tq.dequantize_int8, "dq")
    for mod in (tq, tsp):
        monkeypatch.setattr(mod, "quantize_int8", quant)
        monkeypatch.setattr(mod, "dequantize_int8", dequant)
    return calls


def _quant_calls(r, w):
    return r * w + (r - 1)


@pytest.mark.parametrize("policy, quant, dequant", [
    ("delta_int8", _quant_calls, lambda r, w: r * w + (r - 1) * (w + 1)),
    ("topk_ef_int8:0.05", _quant_calls,
     lambda r, w: r * w + (r - 1) * (w + 1)),
    ("topk_ef", lambda r, w: 0, lambda r, w: 0)])
def test_kernel_calls_follow_the_schedule(monkeypatch, policy, quant,
                                          dequant):
    """Quantize: one per reply and one per compressed broadcast (rounds
    1..R-1). Dequantize: the server's decode of every reply, then per
    compressed broadcast the server's mirror advance and each silo's apply;
    under top-k + int8 the quantize launch also writes the error-feedback
    residual of the kept values (ops/sparsify.py), so no encode launches a
    dequantize. At R = 3 and W = 10 that is 32 quantize and 52 dequantize
    launches under both policies, what chip_smoke.py asserts on the card
    (54 and 94 at R = 5)."""
    calls = _count_calls(monkeypatch)
    ds = make_blob_federated(**BLOB)
    rounds = 3
    cs.run_fedavg_cross_silo(ds, _lr(ds), worker_num=SILOS,
                             comm_round=rounds,
                             train_cfg=TrainConfig(**TRAIN),
                             compression=policy, device="cpu",
                             join_timeout_s=300)
    assert calls["q"] == quant(rounds, SILOS)
    assert calls["dq"] == dequant(rounds, SILOS)


def test_federation_equals_the_simulation_without_compression():
    """The actor protocol and FedAvgAPI run the same rounds (seeds,
    sampling, local training); they differ only in the sum's order (a fold
    vs a stacked mean)."""
    ds = make_blob_federated(**BLOB)
    sim = FedAvgAPI(ds, _lr(ds), device="cpu", config=FedAvgConfig(
        comm_round=ROUNDS, client_num_per_round=SILOS, prefetch_depth=0,
        train=TrainConfig(**TRAIN)))
    for r in range(ROUNDS):
        sim.run_round(r)
    final, _ = cs.run_fedavg_cross_silo(
        ds, _lr(ds), worker_num=SILOS, comm_round=ROUNDS,
        train_cfg=TrainConfig(**TRAIN), device="cpu")
    for k in final:
        torch.testing.assert_close(final[k], sim.variables[k], rtol=1e-5,
                                   atol=1e-6)


def test_wire_bytes_and_compressed_broadcasts():
    ds = make_blob_federated(**BLOB)
    sizes = {}
    for policy in ("none", "delta_int8", "topk_ef_int8:0.05"):
        timer = RoundTimer()
        cs.run_fedavg_cross_silo(
            ds, _lr(ds), worker_num=SILOS, comm_round=2,
            train_cfg=TrainConfig(**TRAIN), compression=policy,
            device="cpu", timer=timer)
        sizes[policy] = (timer.comm_bytes_up, timer.comm_bytes_down)
        recs = timer.round_records()
        assert [r["round"] for r in recs] == [0, 1]
        assert all(r["reported"] == list(range(SILOS)) for r in recs)
    d = 256 * 10 + 10
    # every reply frame carries at least its arrays
    assert sizes["none"][0] > 2 * SILOS * 4 * d
    assert sizes["delta_int8"][0] < sizes["none"][0] / 3
    assert sizes["topk_ef_int8:0.05"][0] < sizes["delta_int8"][0] / 2
    # round 0 broadcasts full precision under every policy, round 1 the
    # compressed mirror delta
    assert sizes["delta_int8"][1] < sizes["none"][1]


def test_aggregator_fold_is_arrival_order_invariant_and_keeps_signed_zero():
    rng = np.random.RandomState(0)
    models = [{"w": torch.from_numpy(rng.randn(7).astype(np.float32))}
              for _ in range(4)]
    models[0]["w"][0] = -0.0
    for m in models[1:]:
        m["w"][0] = -0.0
    weights = [3.0, 5.0, 0.0, 2.0]
    outs = []
    for order in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 0, 1]):
        agg = cs.FedAvgAggregator(4)
        for i in order:
            agg.add_local_trained_result(i, models[i], weights[i])
        assert agg.check_whether_all_receive()
        outs.append(agg.aggregate()["w"])
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int32), outs[0].view(torch.int32))
    assert np.signbit(outs[0][0].item())  # -0.0 survives the fold
    # every reporter with an empty shard: the uniform mean, not 0/0
    agg = cs.FedAvgAggregator(2)
    agg.add_local_trained_result(1, models[1], 0.0)
    agg.add_local_trained_result(0, models[0], 0.0)
    torch.testing.assert_close(agg.aggregate()["w"],
                               (models[0]["w"] + models[1]["w"]) / 2)
    with pytest.raises(ValueError, match="empty round"):
        cs.FedAvgAggregator(2).aggregate()


NOT_PORTED = [
    ("server_checkpoint_dir", "/tmp/x"),
    ("checkpoint_sync", True), ("pace_steering", True),
    ("join_rate_limit", 2.0),
    ("serve_port", 8000), ("serving", object()), ("comm_factory", print),
    ("device_gate", object())]


#: item 23's control plane, ported since these cases were written: each
#: option now runs, and on a healthy fleet gives the bits of a run without
CONTROL_PLANE = ("server_checkpoint_dir", "checkpoint_sync",
                 "pace_steering", "join_rate_limit")

#: item 22g's hooks, ported since too: a shared fabric's channels and an
#: interleaver's gate (not the case's value) give the plain run's bits
SCHEDULER = ("comm_factory", "device_gate")


@pytest.mark.parametrize("name, value", NOT_PORTED)
def test_unported_options_raise_and_name_their_item(name, value, tmp_path):
    ds = make_blob_federated(**BLOB)
    if name in SCHEDULER:
        from fedml_tpu_torch.sched import RoundInterleaver, SharedFabric
        run = dict(worker_num=2, comm_round=2,
                   train_cfg=TrainConfig(**TRAIN), device="cpu",
                   join_timeout_s=60)
        plain, plain_hist = cs.run_fedavg_cross_silo(ds, _lr(ds), **run)
        fabric = SharedFabric("INPROC", 3)
        timer = RoundTimer()
        opts = ({"comm_factory": fabric.comm_factory("job")}
                if name == "comm_factory" else
                {"device_gate": RoundInterleaver().gate("job",
                                                        timer=timer)})
        try:
            final, hist = cs.run_fedavg_cross_silo(ds, _lr(ds),
                                                   timer=timer, **opts,
                                                   **run)
        finally:
            fabric.stop()
        assert hist == plain_hist
        for k in plain:
            torch.testing.assert_close(final[k], plain[k], rtol=0, atol=0)
        assert (timer.counters.get("sched_device_acquires", 0) > 0) == (
            name == "device_gate")
        return
    if name not in CONTROL_PLANE:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cs.run_fedavg_cross_silo(ds, _lr(ds), device="cpu",
                                     **{name: value})
        return
    ck = str(tmp_path / "ck")  # not the case's value, a path outside
    opts = {"server_checkpoint_dir": {"server_checkpoint_dir": ck},
            "checkpoint_sync": {"server_checkpoint_dir": ck,
                                "checkpoint_sync": True},
            "pace_steering": {"pace_steering": True,
                              "round_deadline_s": 30.0},
            "join_rate_limit": {"join_rate_limit": value}}[name]
    run = dict(worker_num=2, comm_round=2, train_cfg=TrainConfig(**TRAIN),
               device="cpu", join_timeout_s=60)
    plain, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), **run)
    timer = RoundTimer()
    final, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), timer=timer, **opts,
                                        **run)
    for k in plain:
        torch.testing.assert_close(final[k], plain[k], rtol=0, atol=0)
    assert timer.counters["cp_checkpoints"] == (2 if "server_checkpoint_dir"
                                                in opts else 0)


@pytest.mark.parametrize("name", ["checkpoint_dir", "resume", "token",
                                  "server_optimizer", "obs_dir", "job_id",
                                  "round_deadline_s", "heartbeat_s",
                                  "fault_plan", "wan_trace", "wan_profiles",
                                  "wan"])
def test_formerly_refused_options_now_run(name, tmp_path):
    """The options the port ran without before: round checkpoints, resume,
    the routed transport's token, the FedOpt server, the flight recorder
    with its job id (a pure observer: the same bits), the fault
    tolerance of deadline rounds, heartbeats and a fault plan that never
    fires (the same bits when no silo misses a deadline), and the WAN
    world under a trace that keeps every device online (the cohort draw
    over all clients is the seeded stream's; profiles only delay)."""
    from fedml_tpu_torch import native
    ds = make_blob_federated(**BLOB)
    run = dict(worker_num=2, comm_round=1, train_cfg=TrainConfig(**TRAIN),
               device="cpu", join_timeout_s=60, compression="topk_ef")
    plain, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), **run)
    if name == "checkpoint_dir":
        final, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), checkpoint_dir=str(
            tmp_path), **run)
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "round_00000001", "round_00000001.json", "silo_1", "silo_2"]
    elif name == "resume":
        cs.run_fedavg_cross_silo(ds, _lr(ds), checkpoint_dir=str(tmp_path),
                                 **run)
        final, hist = cs.run_fedavg_cross_silo(
            ds, _lr(ds), checkpoint_dir=str(tmp_path), resume=True, **run)
        assert hist == []  # the checkpoint's run had finished
    elif name == "token":
        with native.NativeRouter(token=b"t") as router:
            final, _ = cs.run_fedavg_cross_silo(
                ds, _lr(ds), backend="ROUTED", token=b"t",
                addresses={"router": ("127.0.0.1", router.port)}, **run)
    elif name in ("obs_dir", "job_id"):
        from fedml_tpu_torch.obs import read_flight_log
        job = {"job_id": "j"} if name == "job_id" else {}
        final, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), obs_dir=str(
            tmp_path), **job, **run)
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "flight_rank0.jsonl", "flight_rank1.jsonl", "flight_rank2.jsonl"]
        ids = {r["job_id"] for rank in range(3) for r in read_flight_log(
            str(tmp_path / f"flight_rank{rank}.jsonl"))}
        assert ids == {"j"} if name == "job_id" else len(ids) == 1
    elif name in ("wan_trace", "wan_profiles", "wan"):
        from fedml_tpu_torch.wan import WanWorld
        flat = "seed=1;peak=1.0;trough=1.0;duty_jitter=0.0"
        opts = {"wan_trace": {"wan_trace": flat},
                "wan_profiles": {"wan_trace": flat, "wan_profiles":
                                 "seed=5;compute_median_s=0.01"},
                "wan": {"wan": WanWorld(trace=flat)}}[name]
        timer = RoundTimer()
        final, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), timer=timer,
                                            **opts, **run)
        assert timer.counters["wan_offline_drops"] == 0
        assert (timer.counters["wan_delay_injected_ms"] > 0) == (
            name == "wan_profiles")
    elif name in ("round_deadline_s", "heartbeat_s", "fault_plan"):
        value = {"round_deadline_s": 30.0, "heartbeat_s": 0.05,
                 "fault_plan": "seed=3;drop:p=0.0"}[name]
        final, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), **{name: value},
                                            **run)
    else:
        # one round of server SGD at lr 1 lands on FedAvg's average
        final, _ = cs.run_fedavg_cross_silo(ds, _lr(ds),
                                            server_optimizer="sgd",
                                            server_lr=1.0, **run)
    atol = 1e-6 if name == "server_optimizer" else 0.0
    for k in plain:
        torch.testing.assert_close(final[k], plain[k], rtol=0, atol=atol)


def test_object_hand_off_is_not_ported():
    """Every message crosses the in-process router as an encoded frame, so
    the wire bytes are always counted; the JAX package's object hand-off
    (``wire_codec=False``) raises."""
    ds = make_blob_federated(**BLOB)
    with pytest.raises(NotImplementedError, match="wire_codec"):
        cs.run_fedavg_cross_silo(ds, _lr(ds), device="cpu", wire_codec=False)


def test_a_federation_past_its_join_timeout_raises(monkeypatch):
    init = cs.FedAvgClientManager.handle_message_init

    def slow(self, msg):
        time.sleep(1.5)
        return init(self, msg)
    monkeypatch.setattr(cs.FedAvgClientManager, "handle_message_init", slow)
    ds = make_blob_federated(**BLOB)
    with pytest.raises(RuntimeError, match="did not finish within"):
        cs.run_fedavg_cross_silo(ds, _lr(ds), device="cpu",
                                 join_timeout_s=0.5)


@pytest.mark.parametrize("backend", ["TCP", "GRPC", "MQTT"])
def test_socket_transports_need_addresses(backend):
    """The socket transports run (tests/test_torch_transports.py) once
    they are given addresses; without, they refuse before any endpoint
    exists."""
    ds = make_blob_federated(**BLOB)
    with pytest.raises(ValueError, match="needs"):
        cs.run_fedavg_cross_silo(ds, _lr(ds), device="cpu", backend=backend)


def test_a_failing_silo_stops_the_federation_and_raises(monkeypatch):
    def boom(self, msg):
        raise RuntimeError(f"silo {self.rank} failed")
    monkeypatch.setattr(cs.FedAvgClientManager, "handle_message_init", boom)
    ds = make_blob_federated(**BLOB)
    with pytest.raises(RuntimeError, match="silo . failed"):
        cs.run_fedavg_cross_silo(ds, _lr(ds), device="cpu",
                                 join_timeout_s=60)


def test_init_variables_are_checked():
    ds = make_blob_federated(**BLOB)
    bad = {k: torch.zeros(3) for k in ("linear.weight", "linear.bias")}
    with pytest.raises(KeyError, match="init_variables"):
        cs.run_fedavg_cross_silo(ds, _lr(ds), device="cpu",
                                 init_variables={"x": bad["linear.bias"]})
    model = _lr(ds)
    with pytest.raises(ValueError, match="init_variables"):
        cs.run_fedavg_cross_silo(ds, model, device="cpu",
                                 init_variables=bad)


def test_cli_runs_the_cross_silo_backend_on_the_cpu(tmp_path):
    final = main_fedavg.main([
        "--backend", "inproc", "--device", "cpu", "--dataset", "blob",
        "--client_num_in_total", "6", "--client_num_per_round", "3",
        "--comm_round", "2", "--batch_size", "16", "--lr", "0.1",
        "--compression", "topk_ef_int8:0.1", "--run_dir", str(tmp_path)])
    assert final["round"] == 1
    recs = read_metrics(str(tmp_path))
    assert [r["round"] for r in recs if "round" in r] == [0, 1]
    summary = recs[-1]
    assert summary["summary"] == "cross_silo" and summary["rounds"] == 2
    assert summary["comm_bytes_up"] > 0 and summary["comm_bytes_down"] > 0
    assert summary["phase_train_ms"] > 0


@pytest.mark.parametrize("backend", ["spmd"])
def test_cli_unported_backends_raise(backend, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main_fedavg.main(["--backend", backend, "--device", "cpu",
                          "--run_dir", str(tmp_path)])


@pytest.mark.parametrize("backend", ["tcp", "grpc"])
def test_cli_runs_the_socket_backends(backend, tmp_path, monkeypatch):
    """``--backend tcp|grpc`` on the CLI's fixed loopback ports (29500 +
    rank, the JAX CLI's map; no other test binds them), ending on the
    in-process router's model; the join is cut to 60 s so a wedged run
    fails fast."""
    import functools
    run = cs.run_fedavg_cross_silo
    monkeypatch.setattr(cs, "run_fedavg_cross_silo",
                        functools.partial(run, join_timeout_s=60))
    finals = {}
    for name in ("inproc", backend):
        seen = []
        monkeypatch.setattr(cs, "run_fedavg_cross_silo", functools.partial(
            lambda *a, **kw: seen.append(run(*a, **kw)) or seen[-1],
            join_timeout_s=60))
        final = main_fedavg.main([
            "--backend", name, "--device", "cpu", "--dataset", "blob",
            "--client_num_in_total", "6", "--client_num_per_round", "3",
            "--comm_round", "2", "--batch_size", "16", "--lr", "0.1",
            "--compression", "topk_ef_int8:0.1",
            "--run_dir", str(tmp_path / name)])
        assert final["round"] == 1
        finals[name] = seen[0][0]
    for k in finals["inproc"]:
        assert torch.equal(finals[backend][k], finals["inproc"][k]), k
    summary = read_metrics(str(tmp_path / backend))[-1]
    assert summary["comm_bytes_up"] > 0 and summary["comm_bytes_down"] > 0
