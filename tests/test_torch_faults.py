"""The port's fault tolerance against the JAX package's: the seeded fault
plan, deadline rounds with eviction, heartbeats and JOIN.

Runs are held to the JAX package where the fault plan makes them
deterministic. A ``drop`` of a silo's round-1 reply with no heartbeats
gives one schedule whatever the timing: the round closes at its deadline
over exactly the other silos (no close can happen before it; the quorum
can only be met by them), and the evicted silo never comes back. There the
partial round's model and the final model match JAX's at the cross-silo
files' tolerance (rtol 1e-5, atol 1e-6), and ``partial_rounds`` and
``deadline_extensions`` are equal. A JOIN sent while its silo is still live
(its reply lost, three heartbeats before the deadline) is resynced into
the same round: the schedule is again fixed, and equals the fault-free
one. Where heartbeat timing decides the round an evicted silo rejoins in,
the test compares invariants instead: every silo is live at the end, one
eviction and one rejoin on both sides, each partial round is the weighted
mean of exactly its reporters, and ``deadline_extensions`` is equal.

Every deadline is 0.5 s or less, and the paced run delays broadcasts by
0.15 s; the JAX side runs one LR configuration, so its local train
compiles once for the file.
"""

import dataclasses
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg_cross_silo as jcs
from fedml_tpu.comm import faults as jfaults
from fedml_tpu.comm.message import Message as JMessage
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu.utils import watchdog as jwatchdog
from fedml_tpu.utils.tracing import RoundTimer as JaxRoundTimer
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.comm import faults
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.control import SchedulingStallError
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import read_flight_log
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils import watchdog
from fedml_tpu_torch.utils.convert import flax_to_state_dict
from fedml_tpu_torch.utils.tracing import RoundTimer

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLOB = dict(client_num=6, dim=32, class_num=4, seed=2)
TRAIN = dict(epochs=1, batch_size=16, lr=0.1, shuffle=False)
SILOS = 3
TOL = dict(rtol=1e-5, atol=1e-6)
#: silo 3 loses its round-1 reply (its endpoint's second reply)
DROP_R1 = "seed=1;drop:direction=send,sender=3,msg_type=4,after=1,max_count=1"

# -- the plan: parsing, streams, the fault engine -----------------------------

PLANS = [
    # tests/test_faults.py:52-88
    "seed=7;drop:p=0.1,msg_type=4;delay:p=0.2,delay_ms=50;"
    "duplicate:after=2,max_count=3",
    '{"seed": 3, "rules": [{"op": "corrupt", "p": 0.5}]}',
    '[{"op": "drop"}]',
    "",
    "   ",
    # every key of a rule
    "seed=4;disconnect:direction=recv,receiver=3,msg_type=2,after=0,"
    "max_count=1,duration_ms=2000;delay:sender=0,delay_ms=400,"
    "include_self=1;corrupt:p=0.25,include_self=no",
]


def _rules(plan):
    return None if plan is None else (plan.seed, [
        dataclasses.asdict(r) for r in plan.rules])


@pytest.mark.parametrize("spec", PLANS)
def test_parse_fault_plan_gives_jax_rules(spec):
    seed = 9 if spec.startswith("[") else 0
    assert _rules(faults.parse_fault_plan(spec, seed=seed)) == _rules(
        jfaults.parse_fault_plan(spec, seed=seed))


def test_parse_fault_plan_reads_a_file_and_refuses_as_jax(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 5, "rules": [
        {"op": "delay", "delay_ms": 20, "msg_type": 2}]}))
    assert _rules(faults.parse_fault_plan(str(path))) == _rules(
        jfaults.parse_fault_plan(str(path)))
    for bad, match in (("explode:p=0.1", "unknown fault op"),
                       ("drop:probability=0.1", "unknown fault-rule key"),
                       ("drop:p=2", "fault p must be"),
                       ("drop:direction=up", "fault direction")):
        for mod in (faults, jfaults):
            with pytest.raises(ValueError, match=match):
                mod.parse_fault_plan(bad)
    with pytest.raises(FileNotFoundError):
        faults.parse_fault_plan(str(tmp_path / "missing.json"))


@pytest.mark.parametrize("seed", [0, 11, 123456])
def test_rng_for_draws_the_jax_stream(seed):
    for rank in range(4):
        a = faults.FaultPlan(seed=seed).rng_for(rank)
        b = jfaults.FaultPlan(seed=seed).rng_for(rank)
        assert [a.random() for _ in range(16)] == [b.random()
                                                   for _ in range(16)]
        assert [a.randrange(1000) for _ in range(16)] == [
            b.randrange(1000) for _ in range(16)]
    assert faults.FaultPlan(seed).rng_for(2).random() != faults.FaultPlan(
        seed).rng_for(3).random()


def test_merge_plans_and_server_kill_plan_match_jax():
    a, b = "seed=3;drop:p=0.5", "seed=8;delay:delay_ms=5;duplicate"
    assert _rules(faults.merge_plans(a, b)) == _rules(
        jfaults.merge_plans(a, b))
    assert _rules(faults.merge_plans(None, b)) == _rules(
        jfaults.merge_plans(None, b))
    assert faults.merge_plans(None, "") is None
    extra = (faults.FaultRule(op="duplicate", p=0.3),)
    jextra = (jfaults.FaultRule(op="duplicate", p=0.3),)
    assert _rules(faults.server_kill_plan(4, 3, 500.0, extra)) == _rules(
        jfaults.server_kill_plan(4, 3, 500.0, jextra))


class _Wire:
    """A stub inner backend: records what reaches the transport and
    delivers inbound messages to its observers."""

    def __init__(self):
        self.sent, self._observers = [], []
        self.counters = {"retries": 2}
        self.bytes_sent = self.bytes_received = 0

    def add_observer(self, obs):
        self._observers.append(obs)

    def send_message(self, msg):
        self.sent.append((msg.get_type(), msg.get_receiver_id(),
                          msg.get("k")))

    def deliver(self, msg):
        for obs in self._observers:
            obs.receive_message(msg.get_type(), msg)

    def stop_receive_message(self):
        pass


def _engine_trace(mod, msg_cls, plan_spec):
    """A scripted stream through one package's FaultyCommManager: the
    sends that reached the wire, the inbound messages its observer saw,
    and the fault counters."""
    wire = _Wire()
    com = mod.FaultyCommManager(wire, mod.parse_fault_plan(plan_spec), 1)
    seen = []

    class Obs:
        def receive_message(self, t, m):
            seen.append((t, m.get("k")))
    com.add_observer(Obs())
    for k in range(60):
        msg = msg_cls(4 if k % 3 else 10, 1, 0 if k % 5 else 1)
        msg.add("k", k)
        com.send_message(msg)
        inbound = msg_cls(2 if k % 2 else 3, 0, 1)
        inbound.add("k", 100 + k)
        wire.deliver(inbound)
    return wire.sent, seen, dict(com.all_counters())


def test_fault_engine_replays_the_jax_stream():
    """Every probabilistic rule draws from the rank's stream in the JAX
    package's order: the same messages are dropped, duplicated and let
    through, both ways, with the same counters."""
    spec = ("seed=21;drop:p=0.3,msg_type=4;duplicate:p=0.5,receiver=0;"
            "drop:direction=recv,p=0.4,msg_type=2,after=3;"
            "duplicate:direction=recv,p=0.5,max_count=4;"
            "drop:p=0.2,include_self=1")
    assert _engine_trace(faults, Message, spec) == _engine_trace(
        jfaults, JMessage, spec)


def test_corrupt_and_disconnect_behave_as_jax():
    rng = faults.FaultPlan(seed=2).rng_for(1)
    msg = Message(4, 1, 0)
    msg.add("model_params", {"w": np.arange(256, dtype=np.float32)})
    msg.add("num_samples", 7.0)
    bad = faults._corrupt_frame(msg, rng)
    assert bad.get("num_samples") == 7.0  # the header is intact
    assert not np.array_equal(bad.get("model_params")["w"],
                              msg.get("model_params")["w"])
    assert faults._corrupt_frame(Message(10, 1, 0), rng) is None
    wire = _Wire()
    com = faults.FaultyCommManager(wire, faults.parse_fault_plan(
        "disconnect:msg_type=10,duration_ms=150"), 1)
    for k in range(3):
        m = Message(10 if k == 0 else 4, 1, 0)
        m.add("k", k)
        com.send_message(m)
    tick = Message(9, 0, 0)  # self-addressed: never lost to a partition
    tick.add("k", 9)
    com.send_message(tick)
    time.sleep(0.2)
    late = Message(4, 1, 0)
    late.add("k", 3)
    com.send_message(late)
    assert wire.sent == [(9, 0, 9), (4, 0, 3)]
    assert com.all_counters()["fault_disconnect"] == 1
    assert com.all_counters()["retries"] == 2  # the inner backend's


def test_delayed_sends_are_flushed_at_stop():
    """No delay timer outlives its endpoint: a stop sends what still
    waits, in order, so a delayed FINISH still reaches its silo."""
    wire = _Wire()
    com = faults.FaultyCommManager(wire, faults.parse_fault_plan(
        "delay:delay_ms=30000"), 1)
    for k in range(3):
        m = Message(3, 0, k + 1)
        m.add("k", k)
        com.send_message(m)
    assert wire.sent == []
    timers = [t for t, _ in com._pending.values()]
    assert len(timers) == 3 and all(t.is_alive() for t in timers)
    com.stop_receive_message()
    assert wire.sent == [(3, 1, 0), (3, 2, 1), (3, 3, 2)]
    assert not com._pending and not any(t.is_alive() for t in timers)


# -- liveness and the stall watchdog ------------------------------------------

def test_liveness_table_follows_jax():
    ours, theirs = (watchdog.SiloLivenessTable(range(3)),
                    jwatchdog.SiloLivenessTable(range(3)))
    ops = [("evict", 1), ("evict", 1), ("admit", 1), ("admit", 1),
           ("evict", 0), ("admit", 5), ("evict", 2), ("admit", 0)]
    for op, w in ops:
        assert getattr(ours, op)(w) == getattr(theirs, op)(w)
        assert ours.live_workers() == theirs.live_workers()
    assert (ours.evictions, ours.rejoins) == (theirs.evictions,
                                              theirs.rejoins) == (3, 3)
    for w, lat in ((0, 0.5), (0, 0.25), (1, 2.0)):
        ours.observe_report_latency(w, lat)
        theirs.observe_report_latency(w, lat)
    assert ours.report_latencies.count() == \
        theirs.report_latencies.count() == 3
    for q in (0.1, 0.5, 0.9):
        assert ours.report_latencies.quantile(q) == pytest.approx(
            theirs.report_latencies.quantile(q), abs=0)
    snap, jsnap = ours.snapshot(), theirs.snapshot()
    assert {w: {k: v for k, v in r.items() if k != "silent_s"}
            for w, r in snap.items()} == {
        w: {k: v for k, v in r.items() if k != "silent_s"}
        for w, r in jsnap.items()}
    assert snap[0]["report_p50_s"] == 0.375 and snap[2]["live"] is False
    # silent_s is rounded to 1 ms: worker 0's beat must come well after the
    # table's construction (worker 1's last-seen time) to be ordered by it
    time.sleep(0.02)
    ours.beat(0)
    time.sleep(0.05)
    ours.beat(5)
    snap = ours.snapshot()
    assert snap[0]["silent_s"] < snap[1]["silent_s"]
    assert snap[5]["silent_s"] < snap[2]["silent_s"]


def test_watchdog_records_a_stall(tmp_path):
    from fedml_tpu_torch.obs import build_observability
    obs = build_observability(str(tmp_path), job_id="j", rank=0,
                              role="silo")
    stalls = []
    table = watchdog.SiloLivenessTable(range(2))
    dog = watchdog.RoundWatchdog(0.05, on_stall=lambda r, s: stalls.append(
        r), poll_s=0.02, liveness=table, obs=obs)
    with dog:
        dog.wrap()(3, None)
        time.sleep(0.2)
    obs.close()
    assert dog.stall_count >= 1 and stalls[0] == 3
    recs = read_flight_log(str(tmp_path / "flight_rank0.jsonl"))
    assert [r["reason"] for r in recs if r["kind"] == "anomaly"][0] == "stall"


# -- deadline rounds against the JAX package ----------------------------------

class _RecordingAggregator(cs.FedAvgAggregator):
    """Keeps every report of the open round as it arrives (the streaming
    fold consumes them) and each close's reporters, for the numpy
    oracle."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.closes, self._models, self._weights = [], {}, {}

    def add_local_trained_result(self, worker_idx, model_params, n):
        self._models[worker_idx] = {k: v.clone()
                                    for k, v in model_params.items()}
        self._weights[worker_idx] = n
        super().add_local_trained_result(worker_idx, model_params, n)

    def _snap(self):
        self.closes.append((dict(self._models), dict(self._weights)))
        self._models, self._weights = {}, {}

    def aggregate(self):
        self._snap()
        return super().aggregate()

    def aggregate_available(self):
        self._snap()
        return super().aggregate_available()


@pytest.fixture(autouse=True)
def _jax_idle_clock_starts_at_run(monkeypatch):
    """The JAX silo starts its idle clock at construction, and the JAX
    launcher's warm-up compile runs between construction and the silo
    threads: a warm-up longer than three heartbeats reads as server
    silence, and every silo JOINs in round 0. The port starts the clock
    in ``run()``; so does the JAX side here, or its schedule would depend
    on its compile time."""
    run = jcs.FedAvgClientManager.run

    def run_from_now(self):
        self._last_s2c = time.monotonic()
        run(self)
    monkeypatch.setattr(jcs.FedAvgClientManager, "run", run_from_now)


def _jax_run(plan, rounds, heartbeat_s=0.0, **server_kw):
    """JAX's launch_federation with its deadline server; returns the
    initial weights, each round's model, the final model and the server."""
    jds = jax_blob(**BLOB)
    module = FlaxLR(num_classes=jds.class_num)
    init = module.init(jax.random.key(0),
                       jnp.asarray(jds.train_data_global[0][:1]),
                       train=False)
    models = {}

    def factory(size, com, aggregator, global_model, on_round_done):
        def hook(r, model):
            models[r] = jax.tree.map(np.asarray, model)
            on_round_done(r, model)
        return jcs.FedAvgServerManager(
            0, size, com, aggregator, rounds, jds.client_num, global_model,
            on_round_done=hook, **server_kw)
    timer = JaxRoundTimer()
    final, _, server = jcs.launch_federation(
        jds, module, "classification", SILOS, JaxTrainConfig(**TRAIN),
        factory, wire_codec=True, heartbeat_s=heartbeat_s, fault_plan=plan,
        timer=timer, join_timeout_s=60.0, raise_on_timeout=True)
    return init, models, jax.tree.map(np.asarray, final), server, timer


def _port_run(plan, rounds, init=None, heartbeat_s=0.0, obs_dir=None,
              backend="INPROC", addresses=None, **server_kw):
    ds = make_blob_federated(**BLOB)
    model = create_model("lr", ds.class_num,
                         input_shape=ds.train_data_global[0].shape[1:])
    if init is not None:
        init = flax_to_state_dict(jax.tree.map(np.asarray, init), model)
    models = {}

    def factory(size, com, aggregator, global_model, on_round_done):
        def hook(r, m):
            models[r] = {k: v.clone() for k, v in m.items()}
            on_round_done(r, m)
        return cs.FedAvgServerManager(
            0, size, com, _RecordingAggregator(size - 1), rounds,
            ds.client_num, global_model, on_round_done=hook, **server_kw)
    timer = RoundTimer()
    final, _, server = cs.launch_federation(
        ds, model, "classification", SILOS, TrainConfig(**TRAIN), factory,
        backend=backend, addresses=addresses, heartbeat_s=heartbeat_s,
        fault_plan=plan, timer=timer, join_timeout_s=60.0,
        obs_dir=obs_dir, device="cpu", init_variables=init)
    return model, models, final, server, timer


def _close(ours, theirs_flax, model):
    want = flax_to_state_dict(theirs_flax, model)
    for k in want:
        np.testing.assert_allclose(ours[k].numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


def _live_rows(server):
    return [(h["round"], h["reported"], h["live"], h["partial"])
            for h in server.live_history]


def test_a_dropped_reply_evicts_at_the_deadline_as_jax():
    jinit, jmodels, jfinal, jserver, jtimer = _jax_run(
        DROP_R1, 4, round_deadline_s=0.4)
    model, models, final, server, timer = _port_run(
        DROP_R1, 4, init=jinit, round_deadline_s=0.4)
    assert _live_rows(server) == _live_rows(jserver) == [
        (0, [0, 1, 2], [0, 1, 2], False), (1, [0, 1], [0, 1], True),
        (2, [0, 1], [0, 1], True), (3, [0, 1], [0, 1], True)]
    _close(models[1], jmodels[1], model)  # the partial round's model
    _close(final, jfinal, model)
    for key in ("ft_partial_rounds", "ft_deadline_extensions",
                "ft_evictions", "ft_rejoins", "ft_faults_injected",
                "ft_stale_replies"):
        assert timer.counters[key] == jtimer.counters[key], key
    assert timer.counters["ft_partial_rounds"] == 3
    # the partial close is the weighted mean of exactly its reporters
    reports, weights = server.aggregator.closes[1]
    assert sorted(reports) == [0, 1]
    total = sum(weights.values())
    for k in final:
        want = sum(weights[w] * reports[w][k].double() for w in reports)
        torch.testing.assert_close(models[1][k], (want / total).float(),
                                   **TOL)


def test_a_join_before_the_deadline_resyncs_into_the_round_as_jax():
    """The silo's reply is lost, it JOINs three heartbeats later while
    still live, and the server resyncs it into the open round: the round
    closes in full and the run equals the fault-free one. The live silos
    idle as long while they wait, and JOIN too; the server ignores a live
    silo that has reported, but a JOIN that lands just after the close,
    before its sender got the next broadcast, is resynced into the next
    round as well (in both packages). Timing decides how often that
    happens, so the resyncs are compared as an invariant: at least the
    lost reply's, and never a partial round or an eviction."""
    jinit, _, jfinal, jserver, jtimer = _jax_run(
        DROP_R1, 3, heartbeat_s=0.05, round_deadline_s=0.5)
    model, _, final, server, timer = _port_run(
        DROP_R1, 3, init=jinit, heartbeat_s=0.05, round_deadline_s=0.5)
    _, _, clean, _, _ = _port_run(None, 3, init=jinit)
    _close(final, jfinal, model)
    for k in final:
        assert torch.equal(final[k], clean[k]), k
    for tm in (timer, jtimer):
        assert tm.counters["ft_join_resyncs"] >= 1
        for key in ("ft_partial_rounds", "ft_evictions",
                    "ft_deadline_extensions"):
            assert tm.counters[key] == 0, key
    assert server.liveness.live_workers() == {0, 1, 2}


def test_eviction_and_rejoin_keep_the_jax_invariants():
    """Timing decides which round the evicted silo rejoins in (its JOIN
    waits for three silent heartbeats), so the two runs are compared by
    their invariants, not their bits. A live silo that idles three beats
    may JOIN just as the next broadcast lands and be resynced as well, so
    the resyncs are at least the rejoin's."""
    # every broadcast (a resync too) lands 0.15 s late, so a round takes
    # ~0.15 s; the deadline (0.5 s) leaves a rejoined silo's resync time to
    # report, and live silos never idle for three beats (0.75 s) waiting
    # for a broadcast, so only the evicted silo JOINs, ~0.9-1.15 s after
    # round 1 opened, some rounds before the last
    plan = ("seed=5;delay:direction=send,sender=0,msg_type=2,delay_ms=150;"
            + DROP_R1.split(";", 1)[1])
    _, _, _, jserver, jtimer = _jax_run(plan, 10, heartbeat_s=0.25,
                                        round_deadline_s=0.5)
    model, models, final, server, timer = _port_run(
        plan, 10, heartbeat_s=0.25, round_deadline_s=0.5)
    for srv, tm in ((server, timer), (jserver, jtimer)):
        rows = _live_rows(srv)
        assert srv.round_idx == 10
        assert srv.liveness.live_workers() == {0, 1, 2}
        assert rows[1] == (1, [0, 1], [0, 1], True)
        partial = [r for r in rows if r[3]]
        assert all(2 not in r[1] for r in partial)
        assert rows[-1][1] == [0, 1, 2]  # the rejoined silo reports again
        assert tm.counters["ft_evictions"] == tm.counters["ft_rejoins"] == 1
        assert tm.counters["ft_join_resyncs"] >= 1
    assert timer.counters["ft_deadline_extensions"] == \
        jtimer.counters["ft_deadline_extensions"] == 0
    for r, (reports, weights) in enumerate(server.aggregator.closes):
        total = sum(weights.values())
        for k in final:
            want = sum(weights[w] * reports[w][k].double() for w in reports)
            torch.testing.assert_close(models[r][k], (want / total).float(),
                                       **TOL)


def test_below_quorum_hits_the_extension_cap_as_jax(tmp_path):
    """Every silo's replies after round 0 are lost: round 1 extends its
    deadline twice, writing a ``deadline_extension`` anomaly each time,
    then fails loudly, as in the JAX package."""
    plan = "seed=2;drop:direction=send,msg_type=4,after=1"
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    from fedml_tpu.control import SchedulingStallError as JaxStall

    def jax_side():
        jds = jax_blob(**BLOB)

        def factory(size, com, aggregator, global_model, on_round_done):
            return jcs.FedAvgServerManager(
                0, size, com, aggregator, 3, jds.client_num, global_model,
                on_round_done=on_round_done, round_deadline_s=0.1,
                max_deadline_extensions=2)
        jcs.launch_federation(
            jds, FlaxLR(num_classes=jds.class_num), "classification",
            SILOS, JaxTrainConfig(**TRAIN), factory, wire_codec=True,
            fault_plan=plan, obs_dir=str(jdir), job_id="j",
            join_timeout_s=60.0, raise_on_timeout=True)
    with pytest.raises(JaxStall, match="below quorum"):
        jax_side()
    with pytest.raises(SchedulingStallError, match="below quorum") as err:
        _port_run(plan, 3, round_deadline_s=0.1, max_deadline_extensions=2,
                  obs_dir=str(pdir))
    assert "0/3 reports, need 2" in str(err.value)

    def anomalies(d):
        return [(r["round"], r["reason"], r["detail"]["extensions"])
                for r in read_flight_log(str(d / "flight_rank0.jsonl"))
                if r["kind"] == "anomaly"]
    assert anomalies(pdir) == anomalies(jdir) == [
        (1, "deadline_extension", 1), (1, "deadline_extension", 2)]


def test_empty_and_p0_plans_leave_the_run_bit_for_bit():
    """An empty plan is not wrapped; ``p=0`` rules wrap every endpoint and
    draw, but never fire."""
    runs = [_port_run(plan, 2, round_deadline_s=None)[2] for plan in (
        None, "seed=5", "seed=5;drop:p=0.0;corrupt:p=0.0;duplicate:p=0")]
    for run in runs[1:]:
        for k in runs[0]:
            assert torch.equal(run[k], runs[0][k]), k


@pytest.mark.parametrize("policy", ["none", "delta_int8", "topk_ef_int8"])
def test_duplicates_and_reordered_broadcasts_leave_the_run_unchanged(policy):
    ds = make_blob_federated(**BLOB)

    def run(plan):
        return cs.run_fedavg_cross_silo(
            ds, create_model("lr", ds.class_num, input_shape=(32,)),
            worker_num=SILOS, comm_round=3, train_cfg=TrainConfig(**TRAIN),
            compression=policy, fault_plan=plan, device="cpu",
            join_timeout_s=60)[0]
    clean = run(None)
    noisy = run("seed=9;duplicate:p=1.0,msg_type=4;"
                "delay:p=0.5,delay_ms=40,msg_type=2")
    for k in clean:
        assert torch.equal(noisy[k], clean[k]), k


def test_a_deadline_run_over_tcp_equals_inproc():
    """The deadline tick rides the TCP endpoint to itself."""
    import socket
    socks = [socket.socket() for _ in range(SILOS + 1)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    addresses = {r: s.getsockname() for r, s in enumerate(socks)}
    for s in socks:
        s.close()
    inproc = _port_run(DROP_R1, 3, round_deadline_s=0.3)
    tcp = _port_run(DROP_R1, 3, round_deadline_s=0.3, backend="TCP",
                    addresses=addresses)
    assert _live_rows(tcp[3]) == _live_rows(inproc[3])
    for k in inproc[2]:
        assert torch.equal(tcp[2][k], inproc[2][k]), k


# -- the server's handlers, without threads -----------------------------------

class _Outbox:
    """A stub endpoint: keeps every message the server sends."""

    def __init__(self):
        self.sent = []
        self.bytes_sent = self.bytes_received = 0

    def add_observer(self, obs):
        pass

    def send_message(self, msg):
        self.sent.append(msg)

    def broadcast(self, msgs, on_error=None):
        self.sent.extend(msgs)
        return {"enqueued": len(msgs), "max_queue_depth": 0}

    def stop_receive_message(self):
        pass


def _reply(rank, round_idx, w, n=10.0):
    msg = Message(cs.MSG_TYPE_C2S_SEND_MODEL, rank, 0)
    msg.add(cs.MSG_ARG_KEY_MODEL_PARAMS, {"w": np.full(4, w, np.float32)})
    msg.add(cs.MSG_ARG_KEY_NUM_SAMPLES, n)
    msg.add(cs.MSG_ARG_KEY_ROUND, round_idx)
    return msg


def _tick(round_idx):
    msg = Message(cs.MSG_TYPE_ROUND_TIMEOUT, 0, 0)
    msg.add(cs.MSG_ARG_KEY_ROUND, round_idx)
    return msg


@pytest.mark.parametrize("buffered", [False, True])
def test_a_late_reply_after_a_partial_close_is_stale(buffered):
    """A straggler's reply to a closed round is discarded: it is neither
    folded into the next round nor taken for a duplicate there, and the
    old round's tick does nothing."""
    from fedml_tpu_torch.ops.aggregate import tree_weighted_mean_fused
    out = _Outbox()
    agg = cs.FedAvgAggregator(3, aggregate_fn=(
        tree_weighted_mean_fused if buffered else None))
    server = cs.FedAvgServerManager(
        0, 4, out, agg, 3, 6, {"w": torch.zeros(4)},
        round_deadline_s=30.0)
    server.register_message_receive_handlers()
    server.send_init_msg()
    for rank in (1, 2, 3):
        server.receive_message(4, _reply(rank, 0, float(rank)))
    assert server.round_idx == 1 and server.live_history[0]["partial"] is \
        False
    server.receive_message(4, _reply(1, 1, 1.0))
    server.receive_message(4, _reply(2, 1, 4.0, n=30.0))
    server.receive_message(9, _tick(1))
    server.finish()
    assert server.round_idx == 2
    torch.testing.assert_close(server.global_model["w"],
                               torch.full((4,), 3.25))
    assert server.liveness.live_workers() == {0, 1}
    late = _reply(3, 1, 99.0)
    server.receive_message(4, late)
    assert server.ft_counters["stale_replies"] == 1
    assert not agg.has_reported(2) and agg.received_count() == 0
    server.receive_message(9, _tick(1))  # a closed round's tick
    assert server.round_idx == 2 and server.ft_counters[
        "deadline_extensions"] == 0
    # the round-2 broadcast went to the live silos only
    sync = [m for m in out.sent if m.get_type() == cs.MSG_TYPE_S2C_SYNC_MODEL
            and m.get(cs.MSG_ARG_KEY_ROUND) == 2]
    assert sorted(m.get_receiver_id() for m in sync) == [1, 2]


def test_join_resyncs_the_mirror_once_a_round():
    out = _Outbox()
    server = cs.FedAvgServerManager(
        0, 3, out, cs.FedAvgAggregator(2), 4, 6, {"w": torch.ones(4)},
        round_deadline_s=30.0, compression="delta_int8")
    server.register_message_receive_handlers()
    server.send_init_msg()
    server.liveness.evict(1)
    join = Message(cs.MSG_TYPE_C2S_JOIN, 2, 0)
    join.add(cs.MSG_ARG_KEY_ROUNDS_COMPLETED, 0)
    for _ in range(3):
        server.receive_message(cs.MSG_TYPE_C2S_JOIN, join)
    server.finish()
    resync = [m for m in out.sent if m.get_receiver_id() == 2
              and m.get_type() == cs.MSG_TYPE_S2C_SYNC_MODEL]
    assert len(resync) == 1 and server.ft_counters["join_resyncs"] == 1
    np.testing.assert_array_equal(
        resync[0].get(cs.MSG_ARG_KEY_MODEL_PARAMS)["w"], np.ones(4))
    assert resync[0].get(cs.MSG_ARG_KEY_BCAST_SEQ) == server._bcast_seq
    assert server.liveness.live_workers() == {0, 1}


def test_backpressure_defers_the_silos_next_join_as_jax():
    """A BACKPRESSURE reply (the JAX package's JOIN admission control, item
    23, sends it; the port's server does not yet) defers the silo's next
    JOIN by its retry window, as the JAX silo's handler does."""
    windows = []
    for mod, msg_cls in ((cs, Message), (jcs, JMessage)):
        back = msg_cls(mod.MSG_TYPE_S2C_JOIN_BACKPRESSURE, 0, 2)
        back.add(mod.MSG_ARG_KEY_RETRY_AFTER, 1.5)
        silo = types.SimpleNamespace(rank=2, heartbeat_s=0.05,
                                     _hb_lock=threading.Lock(),
                                     _join_backoff_until=0.0)
        t0 = time.monotonic()
        mod.FedAvgClientManager._handle_join_backpressure(silo, back)
        windows.append(silo._join_backoff_until - t0)
    assert cs.MSG_TYPE_S2C_JOIN_BACKPRESSURE == \
        jcs.MSG_TYPE_S2C_JOIN_BACKPRESSURE
    assert all(1.5 <= w < 1.6 for w in windows), windows


@pytest.mark.parametrize("exc, fails", [(RuntimeError, True),
                                        (ValueError, False)])
def test_only_a_payload_guard_error_drops_a_reply(monkeypatch, exc, fails):
    """Under deadline eviction a reply whose decode fails on a payload
    guard (a ValueError) is a corrupt frame: dropped, and the round closes
    at its deadline without it. Any other error (the dequantize kernel's,
    the card's: a RuntimeError) fails the launch."""
    decode = cs.FedAvgServerManager._decode_model_payload
    calls = []

    def failing(self, payload):
        calls.append(1)
        if len(calls) == 4:  # round 1's first reply
            raise exc("the decode failed")
        return decode(self, payload)
    monkeypatch.setattr(cs.FedAvgServerManager, "_decode_model_payload",
                        failing)
    if fails:
        with pytest.raises(RuntimeError, match="the decode failed"):
            _port_run(None, 3, round_deadline_s=0.3)
        return
    _, _, _, server, timer = _port_run(None, 3, round_deadline_s=0.3)
    assert timer.counters["ft_corrupt_frames"] == 1
    assert server.round_idx == 3 and server.live_history[1]["partial"]


def test_no_timer_or_heartbeat_outlives_the_launch():
    before = set(threading.enumerate())
    _port_run(DROP_R1, 3, heartbeat_s=0.05, round_deadline_s=0.3)
    time.sleep(0.05)
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()
            and (isinstance(t, threading.Timer) or "heartbeat" in t.name)]
    assert not left, left


def test_min_quorum_frac_is_checked():
    with pytest.raises(ValueError, match="min_quorum_frac"):
        cs.FedAvgServerManager(0, 3, _Outbox(), cs.FedAvgAggregator(2), 1,
                               4, {"w": torch.ones(1)}, min_quorum_frac=0.0)
