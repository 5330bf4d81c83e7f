"""Server failover in the port: kill the cross-silo server mid-schedule,
restart it, and the resumed run matches the unkilled one
(``fedml_tpu_torch/control/failover_harness.py``, the counterpart of
``TestServerFailoverResumeParity``, ``tests/test_control_plane.py:525-601``).

Within the port, over the in-process router and loopback TCP, the
restored run's ledger (round, cohort, reporters) and final model equal
the unkilled run's bit for bit. Across the packages, on the JAX harness's
fixture with its initialization carried across and shuffling off (the
port's batch orders come from its own seed chain), the ledger schedule is
equal and the final model agrees at the cross-silo files' tolerance
(rtol 1e-5, atol 1e-6). The default async writer is in every run, so a
restore may land a boundary early and replay forward to the same ledger.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.control import failover_harness as jfh
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.comm.compression import is_compressed
from fedml_tpu_torch.control import ServerControlCheckpointer
from fedml_tpu_torch.control import checkpoint as ck
from fedml_tpu_torch.control import failover_harness as fh
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)


def _same_bits(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    model, ledger, _ = fh.run_simulated_failover(
        str(tmp_path_factory.mktemp("ref")), rounds=6,
        crash_at_round=10**9, device="cpu")
    return model, ledger


@pytest.mark.parametrize("backend", ["INPROC", "TCP"])
def test_kill_restore_resume_parity(tmp_path, reference, backend):
    ref_model, ref_ledger = reference
    port = fh.free_port_base(fh.DEFAULT_WORKERS + 1) \
        if backend == "TCP" else None
    model, ledger, s2 = fh.run_simulated_failover(
        str(tmp_path / "kill"), rounds=6, crash_at_round=3,
        backend=backend, port_base=port, device="cpu")
    assert s2.cp_counters["restores"] == 1
    assert fh.ledger_schedule(ledger) == fh.ledger_schedule(ref_ledger)
    assert [r["reported"] for r in ledger] == \
        [r["reported"] for r in ref_ledger]
    assert [r["round"] for r in ledger] == list(range(6))
    _same_bits(model, ref_model)


@pytest.mark.parametrize("sync", [False, True])
def test_failover_follows_jax(tmp_path, monkeypatch, sync):
    """The JAX harness's kill (round 3 of 6) and the port's: the same
    schedule, the final models at the tolerance."""
    jds, jmod, jcfg = jfh.build_fixture(fh.DEFAULT_WORKERS)
    jcfg = dataclasses.replace(jcfg, shuffle=False)
    # flax modules hold no state: every JAX process part may share one
    monkeypatch.setattr(jfh, "build_fixture",
                        lambda workers=3: (jds, jmod, jcfg))
    jmodel, jledger, js2 = jfh.run_simulated_failover(
        str(tmp_path / "jax"), rounds=6, crash_at_round=3,
        checkpoint_sync=sync)
    init = jmod.init(jax.random.key(fh.MODEL_SEED),
                     jnp.asarray(jds.train_data_global[0][:1]),
                     train=False)

    def fixture(workers):
        ds, module, cfg = fh.build_fixture(workers)
        return ds, module, dataclasses.replace(cfg, shuffle=False)
    model_t = fixture(3)[1]
    init = flax_to_state_dict(jax.tree.map(np.asarray, init), model_t)
    model, ledger, s2 = fh.run_simulated_failover(
        str(tmp_path / "port"), rounds=6, crash_at_round=3, device="cpu",
        init_variables=init, fixture=fixture, checkpoint_sync=sync)
    assert js2.cp_counters["restores"] == s2.cp_counters["restores"] == 1
    assert fh.ledger_schedule(ledger) == jfh.ledger_schedule(jledger)
    assert [r["reported"] for r in ledger] == \
        [r["reported"] for r in jledger]
    want = flax_to_state_dict(jax.tree.map(np.asarray, jmodel), model_t)
    for k, v in want.items():
        np.testing.assert_allclose(model[k], v.numpy(), **TOL, err_msg=k)


def test_the_first_broadcast_after_a_restore_is_full_precision(
        tmp_path, monkeypatch):
    """With ``delta_int8`` both ways, the restored server forgets every
    silo's reported base, so its first broadcast rebases at full
    precision; the later ones compress again, and the ledger is still
    the unkilled run's."""
    bcasts = []
    encode = cs.FedAvgServerManager._encode_broadcast

    def record(self):
        out = encode(self)
        bcasts.append((id(self), self.round_idx, is_compressed(out)))
        return out
    monkeypatch.setattr(cs.FedAvgServerManager, "_encode_broadcast", record)
    _, ref_ledger, ref = fh.run_simulated_failover(
        str(tmp_path / "ref"), rounds=6, crash_at_round=10**9,
        device="cpu", compression="delta_int8")
    ref_bcasts = [(r, c) for s, r, c in bcasts if s == id(ref)]
    assert ref_bcasts == [(0, False)] + [(r, True) for r in range(1, 6)]
    bcasts.clear()
    _, ledger, s2 = fh.run_simulated_failover(
        str(tmp_path / "kill"), rounds=6, crash_at_round=3, device="cpu",
        compression="delta_int8")
    restored = [(r, c) for s, r, c in bcasts if s == id(s2)]
    assert s2.cp_counters["restores"] == 1
    assert restored[0][1] is False  # the rebase
    assert all(c for _, c in restored[1:]) and len(restored) >= 3
    assert fh.ledger_schedule(ledger) == fh.ledger_schedule(ref_ledger)
    assert [r["reported"] for r in ledger] == \
        [r["reported"] for r in ref_ledger]


class _RecordingCom:
    """A stub endpoint: keeps every sent message."""

    def __init__(self):
        self.sent = []
        self.bytes_sent = self.bytes_received = 0

    def add_observer(self, obs):
        pass

    def send_message(self, msg):
        self.sent.append(msg)

    def broadcast(self, msgs, on_error=None):
        self.sent.extend(msgs)

    def stop_receive_message(self):
        pass


def _fixture_model():
    ds, module, _ = fh.build_fixture(3)
    return ds, module, cs._initial_model(module, 0, torch.device("cpu"),
                                         None)


def test_fedopt_state_survives_a_snapshot():
    """FedOpt's persistent Adam state rides the snapshot: capture on one
    server, through the blob, restored into a fresh one, bit for bit."""
    ds, module, gm = _fixture_model()
    names = [n for n, _ in module.named_parameters()]

    def fedopt():
        return cs.FedOptServerManager(
            0, 4, _RecordingCom(), cs.FedAvgAggregator(3), 4, ds.client_num,
            {k: v.clone() for k, v in gm.items()}, param_names=names,
            server_optimizer="adam", server_lr=0.05)
    a = fedopt()
    a.aggregator.add_local_trained_result(
        0, {k: v + 0.1 for k, v in gm.items()}, 1.0)
    a.global_model = a._aggregate_round(partial=True)
    state = a._capture_control_state()
    b = fedopt()
    b._restore_control_state(ck.decode_state(ck.encode_state(state)))
    assert int(b.server_opt_state["count"]) == 1
    assert b.server_opt_state["count"].dtype == torch.int32
    for key in ("mu", "nu"):
        for x, y in zip(a.server_opt_state[key], b.server_opt_state[key]):
            assert torch.equal(x, y)
    _same_bits(a.global_model, b.global_model)
    # and the restored server steps on as the first would
    for s in (a, b):
        s.aggregator.add_local_trained_result(
            1, {k: v - 0.2 for k, v in gm.items()}, 2.0)
        s.global_model = s._aggregate_round(partial=True)
    _same_bits(a.global_model, b.global_model)


def test_a_quorum_servers_snapshot_carries_its_partial_rounds(tmp_path):
    """The quorum server rides the same control plane: a snapshot a
    round, with its partial rounds and quorum, restored into a fresh
    quorum server."""
    from fedml_tpu_torch.algorithms.fedavg_async import (
        QuorumFedAvgServerManager, run_fedavg_async)
    from fedml_tpu_torch.utils.tracing import RoundTimer
    ds, module, tcfg = fh.build_fixture(3)
    timer = RoundTimer()
    _, history, server = run_fedavg_async(
        ds, module, worker_num=3, mode="quorum", comm_round=3, quorum=2,
        round_deadline_s=0.5, train_cfg=tcfg, timer=timer, device="cpu",
        server_checkpoint_dir=str(tmp_path / "q"), join_timeout_s=60,
        fault_plan="drop:direction=send,sender=3,msg_type=4,after=1,"
                   "max_count=1")
    assert server.round_idx == 3 and server.partial_rounds == [1]
    assert timer.counters["cp_checkpoints"] == 3
    snap = ServerControlCheckpointer(str(tmp_path / "q")).load_latest()
    assert snap["round_idx"] == 3 and snap["quorum"] == 2
    assert snap["evict_on_deadline"] is False
    assert snap["partial_rounds"] == [1]
    _, _, gm = _fixture_model()
    fresh = QuorumFedAvgServerManager(
        0, 4, _RecordingCom(), cs.FedAvgAggregator(3), 3, ds.client_num,
        gm, quorum=2, round_deadline_s=0.5)
    fresh._restore_control_state(snap)
    assert fresh.partial_rounds == [1] and fresh.round_idx == 3
    _same_bits(fresh.global_model, {k: v for k, v in server.global_model
                                    .items()})


def test_a_snapshot_of_another_schedule_is_refused(tmp_path):
    ds, _, gm = _fixture_model()
    a = cs.FedAvgServerManager(0, 4, _RecordingCom(), cs.FedAvgAggregator(3),
                               8, ds.client_num, gm, round_deadline_s=30.0)
    state = a._capture_control_state()
    for size, rounds in ((3, 8), (4, 6)):
        other = cs.FedAvgServerManager(
            0, size, _RecordingCom(), cs.FedAvgAggregator(size - 1), rounds,
            ds.client_num, gm)
        with pytest.raises(ValueError, match="refusing"):
            other._restore_control_state(state)
    # the launcher's restore path raises it too, before any broadcast
    ckp = ServerControlCheckpointer(str(tmp_path))
    ckp.save(state)
    s = cs.FedAvgServerManager(0, 3, _RecordingCom(),
                               cs.FedAvgAggregator(2), 8, ds.client_num, gm,
                               server_ckpt=ckp)
    with pytest.raises(ValueError, match="refusing"):
        s.send_init_msg()
    assert not s.com_manager.sent


def test_a_restored_finished_schedule_only_finishes(tmp_path):
    """A snapshot of a completed schedule: the restored server FINISHes
    every silo and broadcasts nothing."""
    ds, _, gm = _fixture_model()
    done = cs.FedAvgServerManager(0, 4, _RecordingCom(),
                                  cs.FedAvgAggregator(3), 2, ds.client_num,
                                  gm)
    done.round_idx = 2
    ckp = ServerControlCheckpointer(str(tmp_path))
    ckp.save(done._capture_control_state())
    s = cs.FedAvgServerManager(0, 4, _RecordingCom(), cs.FedAvgAggregator(3),
                               2, ds.client_num, gm, server_ckpt=ckp)
    s.send_init_msg()
    assert s.cp_counters["restores"] == 1
    assert [m.get_type() for m in s.com_manager.sent] == \
        [cs.MSG_TYPE_S2C_FINISH] * 3


def test_the_flight_log_merges_against_the_ledger(tmp_path):
    """The flight recorder's round records and the control plane's ledger
    tell one story: ``obs merge --ledger`` finds no mismatch, through the
    port's tools and the JAX package's alike."""
    import fedml_tpu.obs as jobs
    import fedml_tpu_torch.obs as pobs
    ds, module, tcfg = fh.build_fixture(3)
    cs.run_fedavg_cross_silo(
        ds, module, worker_num=3, comm_round=3, train_cfg=tcfg,
        device="cpu", round_deadline_s=30.0, join_timeout_s=60,
        server_checkpoint_dir=str(tmp_path / "ck"),
        obs_dir=str(tmp_path / "obs"))
    ledger = ServerControlCheckpointer(str(tmp_path / "ck")).read_ledger()
    assert [r["round"] for r in ledger] == [0, 1, 2]
    for obs in (pobs, jobs):
        merged = obs.merge_flight_logs([str(tmp_path / "obs")])
        assert [r["round"] for r in merged["rounds"]] == [0, 1, 2]
        assert obs.check_against_ledger(merged, ledger) == []
