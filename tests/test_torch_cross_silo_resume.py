"""The cross-silo server's round state: checkpoint and resume, the FedOpt
server and the buffered close, against the JAX package and within the
port.

- The FedOpt cross-silo server (adam; sgd with momentum) against JAX's
  ``run_fedavg_cross_silo(server_optimizer=...)``, set up as
  ``test_torch_cross_silo.py`` sets up FedAvg: LR on ``blob`` from the
  converted initial weights, ``shuffle=False``, under ``none`` (and
  ``topk_ef`` for SGD: see the test for why not Adam); the params and
  the optimizer state within atol 1e-5. Both optimizers are also held at
  the server's close itself, on a top-k-shaped average.
- The buffered close (``FedAvgAggregator(aggregate_fn=...)``) against the
  JAX aggregator with ``tree_weighted_mean`` (atol 1e-6 of f32 sums in
  another order), and in a federation with the aggregation kernel's front
  end within 1e-6 of the streaming fold.
- The port's ``ClientStateStore`` and ``SiloResidualStore`` read a
  directory the JAX package wrote, array for array, and the other way
  round; the JAX package's older flax-msgpack residual layout raises.
- Resume: a run stopped after 2 rounds and resumed for 2 more equals the
  4-round run bit for bit (the server's model and optimizer state, every
  silo's residual), for the actor protocol (uplink ``topk_ef_int8``, the
  downlink uncompressed: a resumed federation has no mirror) and for the
  simulation's ``--checkpoint_dir`` / ``--resume``.
- ``CheckpointManager``'s garbage collection leaves only complete
  checkpoints after a crash mid-save.

The JAX side is imported inside the tests that use it, so the gpu tests
collect without it.
"""

import json
import os

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.comm.policy import CompressionPolicy
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops.aggregate import tree_weighted_mean_fused
from fedml_tpu_torch.state import (ClientStateStore, LegacyResidualLayout,
                                   SiloResidualStore)
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.checkpoint import CheckpointManager

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLOB = dict(client_num=8, dim=256, class_num=10, seed=2)
TRAIN = dict(epochs=1, batch_size=16, lr=0.1, shuffle=False)
SILOS, ROUNDS = 4, 3
SMALL = dict(client_num=6, dim=32, class_num=4, seed=7)
#: uplink top-k + int8 with its residual, downlink uncompressed
RESUMABLE = CompressionPolicy("topk_ef_int8", topk_frac=0.1, downlink=False)


def _lr(ds):
    return create_model("lr", ds.class_num,
                        input_shape=ds.train_data_global[0].shape[1:])


def _capture(monkeypatch, module):
    """Record every FedOptServerManager the module's launcher builds."""
    made = []

    class Recorded(module.FedOptServerManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(module, "FedOptServerManager", Recorded)
    return made


# -- the FedOpt cross-silo server against the JAX package --------------------

@pytest.mark.parametrize("server_optimizer, extra, policy", [
    ("adam", {}, "none"), ("sgd", {"server_momentum": 0.9}, "none"),
    ("sgd", {"server_momentum": 0.9}, "topk_ef")],
    ids=["adam-none", "sgd-momentum-none", "sgd-momentum-topk_ef"])
def test_fedopt_server_matches_jax(monkeypatch, server_optimizer, extra,
                                   policy):
    """Adam is held under ``none`` only. Under top-k most coordinates of
    the average are their base's, folded from identical values, and the
    two packages round that fold an ulp apart; Adam's ``m_hat /
    (sqrt(v_hat) + 1e-8)`` turns a pseudo-gradient of an ulp (~7e-9 at
    0.1) into a step of a sizeable fraction of lr where the other package
    steps 0 (0.12 apart after 3 rounds at lr 0.05). SGD steps in
    proportion to the pseudo-gradient and holds under both. The next test
    holds Adam's close under a top-k-shaped average."""
    import jax
    import jax.numpy as jnp
    from fedml_tpu.algorithms import fedavg_cross_silo as jcs
    from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
    from fedml_tpu.models.lr import LogisticRegression as FlaxLR
    from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
    from fedml_tpu_torch.utils.convert import (flax_to_state_dict,
                                               optax_state_to_port)

    opt = dict(server_optimizer=server_optimizer, server_lr=0.05, **extra)
    jservers, servers = _capture(monkeypatch, jcs), _capture(monkeypatch, cs)
    jds = jax_blob(**BLOB)
    flax_model = FlaxLR(num_classes=jds.class_num)
    jinit = flax_model.init(jax.random.key(0),
                            jnp.asarray(jds.train_data_global[0][:1]),
                            train=False)
    jmodel, jhist = jcs.run_fedavg_cross_silo(
        jds, flax_model, worker_num=SILOS, comm_round=ROUNDS,
        train_cfg=JaxTrainConfig(**TRAIN), compression=policy,
        join_timeout_s=300, **opt)
    ds = make_blob_federated(**BLOB)
    model = _lr(ds)
    final, hist = cs.run_fedavg_cross_silo(
        ds, model, worker_num=SILOS, comm_round=ROUNDS,
        train_cfg=TrainConfig(**TRAIN), compression=policy, device="cpu",
        init_variables=flax_to_state_dict(
            jax.tree.map(np.asarray, jinit), model),
        join_timeout_s=300, **opt)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jmodel), model)
    for k in want:
        diff = float((final[k] - want[k]).abs().max())
        assert diff <= 1e-5, f"{k}: max abs diff {diff:.3g}"
    assert [r["round"] for r in hist] == [r["round"] for r in jhist]
    want_state = optax_state_to_port(jservers[0].server_opt_state, model)
    got_state = servers[0].server_opt_state
    assert sorted(got_state) == sorted(want_state)
    for k, v in want_state.items():
        if torch.is_tensor(v):
            assert torch.equal(got_state[k], v), k
        else:
            for a, b in zip(got_state[k], v):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                           rtol=0, err_msg=k)


class _Averaged:
    """An aggregator that closes every round on a given average."""

    avg = None

    def aggregate(self):
        return self.avg


@pytest.mark.parametrize("server_optimizer, extra", [
    ("adam", {}), ("sgd", {"server_momentum": 0.9})],
    ids=["adam", "sgd-momentum"])
def test_fedopt_server_step_matches_jax_on_a_topk_shaped_average(
        server_optimizer, extra):
    """The server's close at the seam where no fold rounds: each package's
    ``_aggregate_round`` gets an average in which nine coordinates in ten
    equal that package's own model exactly, as under top-k, and the rest
    have moved by the same seeded deltas. The pseudo-gradient is then
    exactly 0 on the same coordinates in both, and Adam's ``m_hat /
    (sqrt(v_hat) + 1e-8)`` is held where it bites, over 3 rounds: params
    and optimizer state within atol 1e-5."""
    import jax.numpy as jnp
    from fedml_tpu.algorithms import fedavg_cross_silo as jcs
    from fedml_tpu.comm.inproc import InProcCommManager as JaxInProc
    from fedml_tpu.comm.inproc import InProcRouter as JaxRouter
    from fedml_tpu_torch.comm.inproc import InProcCommManager, InProcRouter
    from fedml_tpu_torch.utils.convert import (flax_to_state_dict,
                                               optax_state_to_port)

    model = create_model("lr", 10, input_shape=(256,))
    rng = np.random.RandomState(3)
    old = {"params": {"Dense_0": {
        "kernel": rng.randn(256, 10).astype(np.float32) * 0.1,
        "bias": rng.randn(10).astype(np.float32) * 0.1}}}
    opt = dict(server_optimizer=server_optimizer, server_lr=0.05, **extra)
    jagg, agg = _Averaged(), _Averaged()
    jserver = jcs.FedOptServerManager(
        0, 2, JaxInProc(JaxRouter(), 0, 2), jagg, 3, 2,
        {"params": {"Dense_0": {k: jnp.asarray(v) for k, v
                                in old["params"]["Dense_0"].items()}}},
        **opt)
    server = cs.FedOptServerManager(
        0, 2, InProcCommManager(InProcRouter(), 0, 2), agg, 3, 2,
        flax_to_state_dict(old, model),
        param_names=[n for n, _ in model.named_parameters()], **opt)
    for _ in range(3):
        delta = {k: np.where(rng.rand(*v.shape) < 0.1,
                             rng.randn(*v.shape) * 0.01, 0).astype(np.float32)
                 for k, v in old["params"]["Dense_0"].items()}
        jbase = jserver.global_model["params"]["Dense_0"]
        jagg.avg = {"params": {"Dense_0": {
            k: jnp.where(d != 0, jbase[k] + d, jbase[k])
            for k, d in delta.items()}}}
        pdelta = flax_to_state_dict({"params": {"Dense_0": delta}}, model)
        agg.avg = {k: torch.where(d != 0, server.global_model[k] + d,
                                  server.global_model[k])
                   for k, d in pdelta.items()}
        jserver.global_model = jserver._aggregate_round()
        server.global_model = server._aggregate_round()
        want = flax_to_state_dict(
            {"params": {"Dense_0": {k: np.asarray(v) for k, v in
                                    jserver.global_model["params"][
                                        "Dense_0"].items()}}}, model)
        for k in want:
            torch.testing.assert_close(server.global_model[k], want[k],
                                       rtol=0, atol=1e-5)
    want_state = optax_state_to_port(jserver.server_opt_state, model)
    got_state = server.server_opt_state
    assert sorted(got_state) == sorted(want_state)
    for k, v in want_state.items():
        if torch.is_tensor(v):
            assert torch.equal(got_state[k], v), k
        else:
            for a, b in zip(got_state[k], v):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                           rtol=0, err_msg=k)


def test_server_sgd_at_lr_1_is_fedavg():
    """w - 1.0 * (w - avg) is avg to an ulp of w."""
    ds = make_blob_federated(**SMALL)
    run = dict(worker_num=3, comm_round=1, train_cfg=TrainConfig(**TRAIN),
               device="cpu", join_timeout_s=60)
    sgd, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), server_optimizer="sgd",
                                      server_lr=1.0, **run)
    avg, _ = cs.run_fedavg_cross_silo(ds, _lr(ds), **run)
    for k in avg:
        torch.testing.assert_close(sgd[k], avg[k], rtol=0, atol=1e-6)


def test_fedopt_keeps_the_plain_average_of_buffers():
    """A BN model's statistics take FedAvg's average; its params move by
    the server step."""
    from fedml_tpu_torch.data.synthetic import make_image_blob_federated
    from fedml_tpu_torch.models.resnet import CifarResNet
    ds = make_image_blob_federated(client_num=2, samples_per_client=8,
                                   image_size=8)
    run = dict(worker_num=2, comm_round=1,
               train_cfg=TrainConfig(batch_size=4, lr=0.1), device="cpu",
               join_timeout_s=120)
    opt, _ = cs.run_fedavg_cross_silo(
        ds, CifarResNet([1, 1, 1], ds.class_num), server_optimizer="adam",
        server_lr=0.01, **run)
    avg, _ = cs.run_fedavg_cross_silo(
        ds, CifarResNet([1, 1, 1], ds.class_num), **run)
    model = CifarResNet([1, 1, 1], ds.class_num)
    params = {n for n, _ in model.named_parameters()}
    buffers = [k for k in avg if k not in params]
    assert buffers and any("running_var" in k for k in buffers)
    for k in buffers:
        assert torch.equal(opt[k], avg[k]), k
    assert any(not torch.equal(opt[k], avg[k]) for k in params)


# -- the buffered close ------------------------------------------------------

def _reports(n, seed):
    rng = np.random.RandomState(seed)
    return [(i, {"w": rng.randn(5, 3).astype(np.float32),
                 "b": rng.randn(3).astype(np.float32)},
             float(rng.randint(0, 50))) for i in range(n)]


def _port_agg(n, reports, order, fn=pt.tree_weighted_mean, close="aggregate"):
    agg = cs.FedAvgAggregator(n, aggregate_fn=fn)
    by_idx = {i: (m, w) for i, m, w in reports}
    for i in order:
        m, w = by_idx[i]
        agg.add_local_trained_result(
            i, {k: torch.from_numpy(v) for k, v in m.items()}, w)
    assert agg.received_count() == len(order)
    assert all(agg.has_reported(i) for i in order)
    assert agg.reported_set() == set(order)
    return getattr(agg, close)()


@pytest.mark.parametrize("order", [[0, 1, 2, 3, 4], [4, 2, 0, 3, 1]])
@pytest.mark.parametrize("zero_weights", [False, True])
def test_buffered_close_matches_jax(order, zero_weights):
    import jax
    from fedml_tpu.algorithms.fedavg_cross_silo import \
        FedAvgAggregator as JaxAggregator
    from fedml_tpu.core import pytree as jpt
    n = len(order)
    reports = _reports(n, seed=11)
    if zero_weights:  # every reporter with an empty shard: uniform mix
        reports = [(i, m, 0.0) for i, m, _ in reports]
    ref = JaxAggregator(n, aggregate_fn=jpt.tree_weighted_mean)
    for i, m, w in reports:
        ref.add_local_trained_result(i, m, w)
    want = jax.tree.map(np.asarray, ref.aggregate())
    got = _port_agg(n, reports, order)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    # the kernel's front end (its plain version on the CPU) and the fold
    fused = _port_agg(n, reports, order, fn=tree_weighted_mean_fused)
    fold = _port_agg(n, reports, order, fn=None)
    for k in want:
        np.testing.assert_allclose(fused[k].numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(fold[k].numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_buffered_partial_close_matches_jax():
    import jax
    from fedml_tpu.algorithms.fedavg_cross_silo import \
        FedAvgAggregator as JaxAggregator
    from fedml_tpu.core import pytree as jpt
    reports = [r for r in _reports(6, seed=13) if r[0] in (1, 3, 4)]
    ref = JaxAggregator(6, aggregate_fn=jpt.tree_weighted_mean)
    for i, m, w in reports:
        ref.add_local_trained_result(i, m, w)
    want = jax.tree.map(np.asarray, ref.aggregate_available())
    got = _port_agg(6, reports, [4, 1, 3], close="aggregate_available")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="empty round"):
        cs.FedAvgAggregator(2, aggregate_fn=pt.tree_weighted_mean
                            ).aggregate_available()


def _buffered_federation(ds, fn, rounds=2, **kw):
    def server_factory(size, com, aggregator, global_model, on_round_done):
        return cs.FedAvgServerManager(
            0, size, com, cs.FedAvgAggregator(size - 1, aggregate_fn=fn),
            rounds, ds.client_num, global_model,
            on_round_done=on_round_done)
    return cs.launch_federation(
        ds, _lr(ds), "classification", 3, TrainConfig(**TRAIN),
        server_factory, join_timeout_s=60, **kw)


def test_buffered_close_in_a_federation_is_the_fold_within_1e_6():
    ds = make_blob_federated(**SMALL)
    fold, fold_hist, _ = _buffered_federation(ds, None, device="cpu")
    fused, hist, _ = _buffered_federation(ds, tree_weighted_mean_fused,
                                          device="cpu")
    assert [r["round"] for r in hist] == [r["round"] for r in fold_hist]
    for k in fold:
        torch.testing.assert_close(fused[k], fold[k], rtol=0, atol=1e-6)


# -- stores written by the other package -------------------------------------

def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {cid: rng.randn(7).astype(np.float32) for cid in (0, 3, 9, 300)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_client_state_store_reads_the_other_packages_directory(tmp_path,
                                                               writer):
    from fedml_tpu.state.store import ClientStateStore as JaxStore
    w_cls, r_cls = ((JaxStore, ClientStateStore) if writer == "jax"
                    else (ClientStateStore, JaxStore))
    data = {"residual": _arrays(0), "data_idx": {
        cid: np.arange(cid, cid + 4, dtype=np.int64) for cid in (1, 2, 700)}}
    store = w_cls(str(tmp_path), shard_clients=4, cache_clients=8)
    for field, entries in data.items():
        for cid, arr in entries.items():
            store.put(field, cid, arr)
    store.flush()
    reader = r_cls(str(tmp_path), shard_clients=99)  # store.json wins
    assert reader.shard_clients == 4
    for field, entries in data.items():
        assert list(reader.known_ids(field)) == sorted(entries)
        for cid, arr in entries.items():
            got = reader.get(field, cid)
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_silo_residuals_read_the_other_packages_directory(tmp_path, writer):
    from fedml_tpu.state.residuals import SiloResidualStore as JaxResiduals
    w_cls, r_cls = ((JaxResiduals, SiloResidualStore) if writer == "jax"
                    else (SiloResidualStore, JaxResiduals))
    rng = np.random.RandomState(1)
    saved = {r: rng.randn(11).astype(np.float32) for r in range(1, 6)}
    store = w_cls(str(tmp_path))
    for r, arr in saved.items():
        store.save(r, arr)
    store.close()
    reader = r_cls(str(tmp_path))
    assert reader.latest_round() == 5
    for r in (3, 4, 5):  # keep_last_n = 3
        np.testing.assert_array_equal(reader.load(r, 11), saved[r])
    assert reader.load(2, 11) is None
    assert reader.load(5, 12) is None  # another model: start from zero


def test_the_legacy_msgpack_residual_layout_raises(tmp_path):
    """The JAX package's older per-round msgpack files need flax; the port
    names the layout instead of starting error feedback over."""
    from fedml_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
    JaxCkpt(str(tmp_path)).save(2, {"residual": np.ones(5, np.float32)})
    store = SiloResidualStore(str(tmp_path))
    with pytest.raises(LegacyResidualLayout, match="flax-msgpack"):
        store.load(2, 5)
    assert store.load(3, 5) is None


# -- checkpoints -------------------------------------------------------------

def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"variables": {"linear.weight": torch.randn(3, 4, generator=g),
                          "linear.bias": torch.randn(3, generator=g)},
            "server_opt": {"count": torch.tensor(seed, dtype=torch.int32),
                           "mu": [torch.randn(3, 4, generator=g),
                                  torch.randn(3, generator=g)]}}


def _same_nest(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_nest(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_nest(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_round_trip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for r in range(1, 5):
        mgr.save(r, _state(r), metadata={"tag": r})
    assert sorted(os.listdir(tmp_path)) == [
        "round_00000003", "round_00000003.json", "round_00000004",
        "round_00000004.json"]
    state, meta = mgr.restore_latest(_state(0))
    assert meta == {"round_idx": 4, "tag": 4}
    _same_nest(state, _state(4))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(4, {"variables": {"linear.weight": torch.zeros(2),
                                      "linear.bias": torch.zeros(3)}})
    with pytest.raises(KeyError, match="no entry"):
        mgr.restore(4, {"extra": torch.zeros(1)})


def test_gc_leaves_only_complete_checkpoints_after_a_crash(tmp_path):
    """A crash mid-save leaves a .tmp blob, or a blob without its sidecar:
    restore skips them, and the next save sweeps them."""
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for r in (1, 2):
        mgr.save(r, _state(r))
    (tmp_path / "round_00000003.tmp").write_bytes(b"torn")
    (tmp_path / "round_00000003").write_bytes(b"no sidecar")
    (tmp_path / "round_00000004.json.tmp").write_text("{")
    assert mgr.latest_round() == 2
    state, meta = mgr.restore_latest(_state(0))
    assert meta["round_idx"] == 2
    _same_nest(state, _state(2))
    mgr.save(5, _state(5))
    assert sorted(os.listdir(tmp_path)) == [
        "round_00000002", "round_00000002.json", "round_00000005",
        "round_00000005.json"]


# -- resume equals an uninterrupted run --------------------------------------

def _silo_run(ds, ckpt, rounds, resume=False, device="cpu", **kw):
    return cs.run_fedavg_cross_silo(
        ds, _lr(ds), worker_num=3, comm_round=rounds,
        train_cfg=TrainConfig(**TRAIN), compression=RESUMABLE,
        device=device, checkpoint_dir=str(ckpt), resume=resume,
        join_timeout_s=60, **kw)


def _blob_of(ckpt, round_idx):
    with np.load(os.path.join(ckpt, f"round_{round_idx:08d}")) as z:
        return {k: z[k] for k in z.files}


def _residuals(ckpt, round_idx, d):
    return [SiloResidualStore(os.path.join(ckpt, f"silo_{r}")).load(
        round_idx, d) for r in (1, 2, 3)]


@pytest.mark.parametrize("server", [{}, {"server_optimizer": "adam",
                                         "server_lr": 0.05}],
                         ids=["fedavg", "fedopt-adam"])
def test_resume_equals_an_uninterrupted_run(tmp_path, server):
    ds = make_blob_federated(**SMALL)
    whole, whole_hist = _silo_run(ds, tmp_path / "a", 4, **server)
    _, first = _silo_run(ds, tmp_path / "b", 2, **server)
    resumed, rest = _silo_run(ds, tmp_path / "b", 4, resume=True, **server)
    assert [r["round"] for r in first + rest] == [0, 1, 2, 3]
    assert first + rest == whole_hist
    for k in whole:
        assert torch.equal(resumed[k].view(torch.int32),
                           whole[k].view(torch.int32)), k
    # the checkpoints: model, server optimizer state and residuals alike
    a, b = _blob_of(tmp_path / "a", 4), _blob_of(tmp_path / "b", 4)
    assert list(a) == list(b)
    assert any(k.startswith("server_opt/") for k in a) == bool(server)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    d = sum(v.numel() for v in whole.values())
    for ra, rb in zip(_residuals(tmp_path / "a", 4, d),
                      _residuals(tmp_path / "b", 4, d)):
        assert ra is not None
        np.testing.assert_array_equal(ra, rb)


def test_resuming_a_finished_run_returns_its_model(tmp_path):
    ds = make_blob_federated(**SMALL)
    done, hist = _silo_run(ds, tmp_path, 2)
    again, more = _silo_run(ds, tmp_path, 2, resume=True)
    assert more == []
    for k in done:
        assert torch.equal(again[k], done[k]), k


def test_resume_without_a_checkpoint_starts_from_round_0(tmp_path):
    ds = make_blob_federated(**SMALL)
    fresh, hist = _silo_run(ds, tmp_path / "a", 2)
    resumed, rhist = _silo_run(ds, tmp_path / "b", 2, resume=True)
    assert rhist == hist
    for k in fresh:
        assert torch.equal(resumed[k], fresh[k]), k


SIM = ["--device", "cpu", "--dataset", "blob", "--client_num_in_total", "6",
       "--client_num_per_round", "3", "--batch_size", "16", "--lr", "0.1",
       "--frequency_of_the_test", "1"]


def test_simulation_resume_equals_an_uninterrupted_run(tmp_path):
    main_fedavg.main(SIM + ["--comm_round", "4", "--checkpoint_dir",
                            str(tmp_path / "a"),
                            "--run_dir", str(tmp_path / "ra")])
    main_fedavg.main(SIM + ["--comm_round", "2", "--checkpoint_dir",
                            str(tmp_path / "b"),
                            "--run_dir", str(tmp_path / "rb")])
    final = main_fedavg.main(SIM + ["--comm_round", "4", "--checkpoint_dir",
                                    str(tmp_path / "b"), "--resume",
                                    "--run_dir", str(tmp_path / "rc")])
    assert final["round"] == 3
    a, b = _blob_of(tmp_path / "a", 4), _blob_of(tmp_path / "b", 4)
    assert list(a) == list(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "b" / "round_00000004.json") as f:
        assert json.load(f) == {"round_idx": 4}


def test_cli_checkpoint_refuses_fused_rounds(tmp_path):
    with pytest.raises(ValueError, match="fused"):
        main_fedavg.main(SIM + ["--comm_round", "2", "--fused_rounds", "2",
                                "--checkpoint_dir", str(tmp_path / "c"),
                                "--run_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the aggregation and int8 kernels "
                    "run only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_buffered_close_launches_the_kernel_once_a_round(cuda_device):
    from fedml_tpu_torch.ops import aggregate
    ds = make_blob_federated(**SMALL)
    fold, _, _ = _buffered_federation(ds, None, device="cuda")
    before = aggregate.weighted_mean_flat.launches
    fused, _, _ = _buffered_federation(ds, tree_weighted_mean_fused,
                                       device="cuda")
    assert aggregate.weighted_mean_flat.launches - before == 2
    for k in fold:
        torch.testing.assert_close(fused[k], fold[k], rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_resume_on_the_card_equals_an_uninterrupted_run(cuda_device,
                                                        tmp_path):
    ds = make_blob_federated(**SMALL)
    run = dict(device="cuda", server_optimizer="adam")
    whole, _ = _silo_run(ds, tmp_path / "a", 4, **run)
    _silo_run(ds, tmp_path / "b", 2, **run)
    resumed, _ = _silo_run(ds, tmp_path / "b", 4, resume=True, **run)
    for k in whole:
        assert torch.equal(resumed[k].cpu(), whole[k].cpu()), k
