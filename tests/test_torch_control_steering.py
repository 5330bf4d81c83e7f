"""Pace steering, JOIN admission and the extension cap in the port's
cross-silo server, against the JAX package where a run or a scripted
sequence is deterministic (``TestControlPlaneParity``,
``TestJoinFloodThrottling``, ``TestDeadlineExtensionCap`` and
``TestServerKillScenario`` of ``tests/test_control_plane.py``).

The JOIN flood is scripted against both packages' servers on one fake
clock, so the admitted resyncs, the BACKPRESSURE replies, their retry
windows and the throttle counts are compared exactly."""

import time

import jax
import jax.numpy as jnp
import pytest
import torch

from fedml_tpu.algorithms import fedavg_cross_silo as jcs
from fedml_tpu.comm import Message as JMessage
from fedml_tpu.control import JoinAdmissionController as JAdmission
from fedml_tpu.control.failover_harness import build_fixture as jfixture
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.comm.faults import server_kill_plan
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.control import (JoinAdmissionController, PaceSteerer,
                                     SchedulingStallError,
                                     ServerControlCheckpointer)
from fedml_tpu_torch.control.failover_harness import build_fixture
from fedml_tpu_torch.utils.tracing import RoundTimer

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _RecordingCom:
    """A stub endpoint of either package: keeps every sent message."""

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


def _stub_server(**kw):
    ds, module, _ = build_fixture(3)
    gm = cs._initial_model(module, 0, torch.device("cpu"), None)
    com = _RecordingCom()
    server = cs.FedAvgServerManager(0, 4, com, cs.FedAvgAggregator(3), 8,
                                    ds.client_num, gm, round_deadline_s=30.0,
                                    **kw)
    return server, com


def _jax_stub_server(**kw):
    ds, module, _ = jfixture(3)
    gm = module.init(jax.random.key(0),
                     jnp.asarray(ds.train_data_global[0][:1]), train=False)
    com = _RecordingCom()
    server = jcs.FedAvgServerManager(0, 4, com, jcs.FedAvgAggregator(3), 8,
                                     ds.client_num, gm, round_deadline_s=30.0,
                                     **kw)
    return server, com


def _run(tmp_path=None, **kw):
    ds, module, tcfg = build_fixture(3)
    timer = RoundTimer()
    model, history = cs.run_fedavg_cross_silo(
        ds, module, worker_num=3, comm_round=3, train_cfg=tcfg, timer=timer,
        device="cpu", join_timeout_s=60, **kw)
    return model, history, timer


# -- steering ---------------------------------------------------------------

def test_steering_on_a_healthy_fleet_is_bit_exact(tmp_path):
    """A generous base keeps the steered deadline (clamped at base/4) far
    above the rounds' walls: no eviction fires, and the trajectory is the
    static schedule's, bit for bit. Snapshots are a pure observer."""
    clean, hist_c, timer_c = _run()
    steered, hist_s, timer = _run(round_deadline_s=60.0, pace_steering=True,
                                  server_checkpoint_dir=str(tmp_path / "ck"))
    for k in clean:
        assert torch.equal(clean[k], steered[k]), k
    assert hist_c == hist_s
    assert timer.counters["cp_deadline_adjustments"] >= 1
    assert timer.counters["cp_checkpoints"] == 3
    assert 0 < timer.gauges["cp_steered_deadline_s"] <= 60.0
    snap = ServerControlCheckpointer(str(tmp_path / "ck")).load_latest()
    assert snap["pace"] is not None and snap["round_idx"] == 3
    assert len(snap["latency_window"]) >= 3
    assert snap["round_deadline_s"] == timer.gauges["cp_steered_deadline_s"]


def _two_of_three_reported(server):
    for w in (0, 1):
        server.aggregator.add_local_trained_result(
            w, {k: v.clone() for k, v in server.global_model.items()}, 1.0)


def _timeout_msg(mod):
    m = mod(cs.MSG_TYPE_ROUND_TIMEOUT, 0, 0)
    m.add(cs.MSG_ARG_KEY_ROUND, 0)
    return m


def test_the_steered_quorum_never_demands_every_live_silo():
    """``ceil(0.9 * 3) == 3``: with steering on the requirement is capped
    at live - 1 and the round closes partial; the static flags keep their
    meaning and extend."""
    steered, _ = _stub_server(
        min_quorum_frac=0.9,
        pace=PaceSteerer(base_deadline_s=30.0, quorum_floor=0.9))
    _two_of_three_reported(steered)
    steered.handle_round_timeout(_timeout_msg(Message))
    steered._cancel_deadline(final=True)
    assert steered.round_idx == 1
    assert steered.ft_counters["partial_rounds"] == 1
    assert steered.ft_counters["deadline_extensions"] == 0
    static, _ = _stub_server(min_quorum_frac=0.9)
    _two_of_three_reported(static)
    static.handle_round_timeout(_timeout_msg(Message))
    static._cancel_deadline(final=True)
    assert static.round_idx == 0
    assert static.ft_counters["deadline_extensions"] == 1


# -- JOIN admission -----------------------------------------------------------

def _join(server, msg_cls, rank):
    msg = msg_cls(cs.MSG_TYPE_C2S_JOIN, rank, 0)
    msg.add(cs.MSG_ARG_KEY_ROUNDS_COMPLETED, 0)
    server.handle_message_join(msg)


def _flood(server, com, msg_cls, now):
    """A healed partition: every silo JOINs at once, then one retries
    after a token refilled. Returns what the server sent and did."""
    for w in range(3):
        server.liveness.evict(w)
    com.sent.clear()
    trace = []
    for step, rank in ((0.0, 1), (0.0, 2), (0.0, 3), (0.3, 3), (1.1, 3),
                       (0.0, 2), (0.6, 1)):
        now[0] += step
        _join(server, msg_cls, rank)
        trace.append((rank, [(m.get_type(), m.get_receiver_id(),
                              m.get_params().get(cs.MSG_ARG_KEY_RETRY_AFTER))
                             for m in com.sent],
                      sorted(server.liveness.live_workers()),
                      int(server.cp_counters["joins_throttled"])))
        com.sent.clear()
    return trace


def test_the_join_flood_is_token_bucketed_as_jax():
    now_p, now_j = [0.0], [0.0]
    ours, com = _stub_server(join_admission=JoinAdmissionController(
        rate_per_s=1.0, burst=2, clock=lambda: now_p[0]))
    ours.send_init_msg()  # the first broadcast: JOINs resync after it
    theirs, jcom = _jax_stub_server(join_admission=JAdmission(
        rate_per_s=1.0, burst=2, clock=lambda: now_j[0]))
    got, want = _flood(ours, com, Message, now_p), _flood(
        theirs, jcom, JMessage, now_j)
    ours._cancel_deadline(final=True)
    assert got == want
    kinds = [t for _, sent, _, _ in got for t, _, _ in sent]
    # the second JOIN of a resynced silo spends a token and waits for
    # its reply (one resync a round)
    assert kinds.count(cs.MSG_TYPE_S2C_SYNC_MODEL) == 3
    assert kinds.count(cs.MSG_TYPE_S2C_JOIN_BACKPRESSURE) == 3
    retry = [r for _, sent, _, _ in got for t, _, r in sent
             if t == cs.MSG_TYPE_S2C_JOIN_BACKPRESSURE]
    assert all(r > 0 for r in retry)
    assert ours.cp_counters["joins_throttled"] == 3
    # the throttled silo stayed evicted until its admitted retry
    assert got[2][2] == [0, 1] and got[4][2] == [0, 1, 2]


def test_no_admission_controller_admits_everything():
    server, com = _stub_server()
    server.send_init_msg()
    for w in range(3):
        server.liveness.evict(w)
    com.sent.clear()
    for rank in (1, 2, 3):
        _join(server, Message, rank)
    server._cancel_deadline(final=True)
    assert server.liveness.live_workers() == {0, 1, 2}
    assert [m.get_type() for m in com.sent] == [cs.MSG_TYPE_S2C_SYNC_MODEL] * 3


def test_a_join_before_the_first_broadcast_is_proof_of_life_only():
    """A restored server holds the mirror of the round before its restore
    until it broadcasts: a JOIN then re-admits without a resync (the
    coming broadcast reaches the silo)."""
    server, com = _stub_server()
    server.liveness.evict(1)
    _join(server, Message, 2)
    assert server.liveness.is_live(1) and not com.sent
    assert server.ft_counters["join_resyncs"] == 0


def test_a_backpressured_silo_defers_its_join():
    ds, module, tcfg = build_fixture(3)
    silo = cs.FedAvgClientManager(1, 4, _RecordingCom(), ds, module,
                                  "classification", tcfg, heartbeat_s=0.0,
                                  prefetch_depth=0, device="cpu")
    msg = Message(cs.MSG_TYPE_S2C_JOIN_BACKPRESSURE, 0, 1)
    msg.add(cs.MSG_ARG_KEY_RETRY_AFTER, 5.0)
    silo._handle_join_backpressure(msg)
    assert silo._join_backoff_until > time.monotonic() + 4.0


# -- the extension cap --------------------------------------------------------

def test_the_extension_cap_raises_after_a_snapshot(tmp_path):
    """A silo whose replies never arrive under a full-participation
    quorum: the round extends, spends its budget and fails loudly with
    the final mid-round state snapshotted (the streaming fold's prefix
    in it)."""
    ck = str(tmp_path / "ck")
    with pytest.raises(SchedulingStallError, match="below quorum"):
        _run(round_deadline_s=0.4, min_quorum_frac=1.0,
             max_deadline_extensions=2, server_checkpoint_dir=ck,
             fault_plan="seed=3;drop:p=1.0,direction=send,sender=3,"
                        "msg_type=4")
    snap = ServerControlCheckpointer(ck).load_latest()
    assert snap["round_idx"] == 0
    assert snap["extensions_this_round"] >= 3
    fold = snap["agg_fold"]
    reported = sorted(set(range(int(fold["next"])))
                      | {int(w) for w in snap["pending_models"]})
    assert reported == [0, 1]
    assert int(fold["count"]) == 2 and fold["acc"] is not None
    assert len(ServerControlCheckpointer(ck).read_ledger()) == 0


def test_a_boundary_snapshot_resets_the_extension_budget(tmp_path):
    server, _ = _stub_server(
        server_ckpt=ServerControlCheckpointer(str(tmp_path)))
    server._extensions_this_round = 7  # a rough round closing
    for w in range(3):
        server.aggregator.add_local_trained_result(
            w, {k: v.clone() for k, v in server.global_model.items()}, 1.0)
    server._close_round()
    server._cancel_deadline(final=True)
    snap = ServerControlCheckpointer(str(tmp_path)).load_latest()
    assert snap["round_idx"] == 1 and snap["extensions_this_round"] == 0
    assert ServerControlCheckpointer(str(tmp_path)).read_ledger()[0][
        "reported"] == [0, 1, 2]


def test_the_extension_counter_still_counts_below_the_cap():
    server, _ = _stub_server(max_deadline_extensions=5)
    assert not server._note_deadline_extension()
    assert server.ft_counters["deadline_extensions"] == 1
    unbounded, _ = _stub_server(max_deadline_extensions=None)
    for _ in range(500):
        assert not unbounded._note_deadline_extension()


# -- the server-coma plan -----------------------------------------------------

def test_the_server_coma_plan_recovers_through_a_join_resync():
    """``comm/faults.server_kill_plan``: the server's endpoint goes dark
    mid-broadcast (the fleet's view of a crash, its state intact); the
    silos that missed the broadcast JOIN after the silence and the round
    is driven again, so the schedule completes."""
    plan = server_kill_plan(seed=5, after_broadcasts=1, down_ms=1500)
    assert plan.rules[0].op == "disconnect"
    _, history, timer = _run(fault_plan=plan, round_deadline_s=0.8,
                             min_quorum_frac=0.5, heartbeat_s=0.25)
    assert history and history[-1]["round"] == 2
    assert timer.counters["ft_faults_injected"] >= 1
    assert (timer.counters["ft_deadline_extensions"]
            + timer.counters["ft_join_resyncs"]) >= 1


# -- the registry's cp_* names ------------------------------------------------

def test_a_control_plane_run_emits_every_cp_name(tmp_path, monkeypatch):
    """Every ``cp_*`` counter and gauge the JAX registry names lands in the
    timer of one run: a restored schedule (six rounds, its newest
    snapshot at round 2) with steering, admission and a writer slowed so
    that its newest-wins slot coalesces."""
    from fedml_tpu.obs import registry as jregistry
    from fedml_tpu_torch.control import checkpoint as ckm
    ck = str(tmp_path / "ck")
    # a killed schedule's newest snapshot: round 2 of 6
    stub, _ = _stub_server()
    stub.comm_round, stub.round_idx = 6, 2
    ServerControlCheckpointer(ck).save(stub._capture_control_state())
    ds, module, tcfg = build_fixture(3)
    kw = dict(worker_num=3, comm_round=6, train_cfg=tcfg, device="cpu",
              join_timeout_s=60, server_checkpoint_dir=ck,
              round_deadline_s=30.0, pace_steering=True, join_rate_limit=5.0)
    save = ckm.ServerControlCheckpointer.save

    def slow_save(self, state, versions=None):
        time.sleep(0.3)
        return save(self, state, versions=versions)
    monkeypatch.setattr(ckm.ServerControlCheckpointer, "save", slow_save)
    timer = RoundTimer()
    _, history = cs.run_fedavg_cross_silo(ds, module, timer=timer, **kw)
    assert [r["round"] for r in history] == [2, 3, 4, 5]
    names = {n for n in jregistry.METRICS if n.startswith("cp_")}
    assert len(names) == 11
    got = {n for n in list(timer.counters) + list(timer.gauges)
           if n.startswith("cp_")}
    assert got == names
    assert timer.counters["cp_restores"] == 1
    assert timer.counters["cp_checkpoints"] == 4  # rounds 2-5
    assert timer.counters["cp_writer_queue_coalesced"] >= 1
    assert timer.counters["cp_fsync_total"] >= \
        timer.counters["cp_ledger_fsyncs"] >= 1


def test_a_run_without_the_control_plane_counts_cp_at_zero():
    """As the JAX roll-up: the five ``cp_*`` counters are there at zero, no
    ``cp_*`` gauge."""
    from fedml_tpu.algorithms.fedavg_cross_silo import \
        run_fedavg_cross_silo as jrun
    from fedml_tpu.utils.tracing import RoundTimer as JTimer
    _, _, timer = _run()
    jds, jmod, jcfg = jfixture(3)
    jtimer = JTimer()
    jrun(jds, jmod, worker_num=3, comm_round=1, train_cfg=jcfg,
         timer=jtimer)
    ours = {k: v for k, v in timer.counters.items() if k.startswith("cp_")}
    theirs = {k: v for k, v in jtimer.counters.items()
              if k.startswith("cp_")}
    assert ours == theirs == {
        f"cp_{k}": 0 for k in ("checkpoints", "restores",
                               "deadline_adjustments", "joins_throttled",
                               "resync_latency_skips")}
    assert not [k for k in timer.gauges if k.startswith("cp_")]
    assert not [k for k in jtimer.gauges if k.startswith("cp_")]
