"""The port's deficit round-robin (``fedml_tpu_torch/sched/interleave.py``)
against the JAX package's: one scripted sequence of acquires and
``release(job, elapsed_s)`` calls through both interleavers gives the same
grant order, ``usage``, ``steady_usage`` and ``fairness_ratio``, exactly;
the JAX suite's ``TestRoundInterleaver`` cases on the port; and the gate's
accounting into a job's timer."""

import collections
import threading
import time

import pytest

from fedml_tpu.sched.interleave import RoundInterleaver as JaxInterleaver
from fedml_tpu_torch.sched import RoundInterleaver
from fedml_tpu_torch.sched.interleave import PROLOGUE_HOLDS
from fedml_tpu_torch.utils.tracing import RoundTimer

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHARES = {"a": 1.0, "b": 2.0, "c": 0.5, "blocker": 1.0}

#: each step: direct charges, then the blocker holds the device while the
#: listed waiters queue (a job may wait more than once), then releases; a
#: granted waiter releases at once, charging its job's next elapsed time in
#: the listed order (which of a job's threads wins a grant is not fixed)
SCRIPT = [
    {"charge": [("a", 0.3)], "wait": [("a", 0.2), ("b", 0.1), ("c", 0.05)]},
    {"charge": [], "wait": [("a", 0.4), ("a", 0.1), ("b", 0.3),
                            ("c", 0.2), ("c", 0.1)]},
    {"charge": [("b", 1.5)], "wait": [("b", 0.2), ("c", 0.3), ("a", 0.05)]},
    {"charge": [], "wait": [("a", 0.1), ("b", 0.1), ("b", 0.2),
                            ("c", 0.4)]},
    {"charge": [("c", 0.25)], "wait": [("c", 0.1), ("a", 0.3), ("b", 0.6),
                                       ("a", 0.2)]},
    {"charge": [], "wait": [("a", 0.15), ("b", 0.15), ("c", 0.15),
                            ("a", 0.15), ("b", 0.15), ("c", 0.15)]},
    # past every tenant's prologue: the steady ratio is defined
    {"charge": [], "wait": [("c", 0.2), ("b", 0.5), ("a", 0.1),
                            ("c", 0.2), ("b", 0.5), ("a", 0.1),
                            ("c", 0.2), ("b", 0.5), ("a", 0.1)]},
    {"charge": [("a", 0.7)], "wait": [("a", 0.3), ("b", 0.3), ("c", 0.3),
                                      ("b", 0.2), ("c", 0.1), ("a", 0.2),
                                      ("a", 0.1), ("b", 0.4), ("c", 0.2)]},
]


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def _run_script(cls):
    inter = cls(dict(SHARES))
    order = []
    charges = {}

    def worker(job):
        inter.acquire(job)
        order.append(job)  # under the grant: serialized
        inter.release(job, charges[job].popleft())

    for step in SCRIPT:
        for job, elapsed in step["charge"]:
            inter.release(job, elapsed)
        charges = {j: collections.deque(el for k, el in step["wait"]
                                        if k == j) for j in "abc"}
        inter.acquire("blocker")
        threads = [threading.Thread(target=worker, args=(job,), daemon=True)
                   for job, _ in step["wait"]]
        for t in threads:
            t.start()
        assert _wait_until(lambda: sum(
            inter._waiting[j] for j in "abc") == len(step["wait"]))
        inter.release("blocker", 0.0)
        for t in threads:
            t.join(timeout=10)
    return {"order": order, "usage": inter.usage(),
            "steady": inter.steady_usage(),
            "fair": inter.fairness_ratio(),
            "fair_raw": inter.fairness_ratio(steady=False)}


def test_scripted_grants_and_accounting_match_jax():
    port, ref = _run_script(RoundInterleaver), _run_script(JaxInterleaver)
    assert port == ref
    assert len(port["order"]) == sum(len(s["wait"]) for s in SCRIPT)
    assert port["fair"] is not None  # every tenant is past its prologue


def test_grants_lowest_normalized_usage_first():
    inter = RoundInterleaver({"heavy": 1.0, "light": 1.0, "blocker": 1.0})
    inter.release("heavy", 10.0)  # heavy has used 10 s already
    inter.acquire("blocker")      # hold the device: contenders queue
    order = []

    def worker(job):
        inter.acquire(job)
        order.append(job)
        inter.release(job, 1.0)

    ts = [threading.Thread(target=worker, args=(j,))
          for j in ("heavy", "light")]
    for t in ts:
        t.start()
    assert _wait_until(
        lambda: inter._waiting["heavy"] + inter._waiting["light"] == 2)
    inter.release("blocker", 0.0)
    for t in ts:
        t.join(timeout=10)
    assert order[0] == "light"  # the starved tenant goes first


def test_share_weighting():
    # equal raw usage, unequal shares: normalized big 0.5 against small
    # 2.0, so the big-share job is the less served and wins the grant
    inter = RoundInterleaver({"big": 4.0, "small": 1.0, "blocker": 1.0})
    inter.release("big", 2.0)
    inter.release("small", 2.0)
    inter.acquire("blocker")
    got = []

    def worker(job):
        inter.acquire(job)
        got.append(job)
        inter.release(job, 0.0)

    ts = [threading.Thread(target=worker, args=(j,))
          for j in ("small", "big")]
    for t in ts:
        t.start()
    assert _wait_until(
        lambda: inter._waiting["big"] + inter._waiting["small"] == 2)
    inter.release("blocker", 0.0)
    for t in ts:
        t.join(timeout=10)
    assert got[0] == "big"
    # the raw ratio is there at once; the steady one waits out each job's
    # prologue
    assert inter.fairness_ratio(steady=False) is not None
    assert inter.fairness_ratio(steady=True) is None


@pytest.mark.parametrize("cls", [RoundInterleaver, JaxInterleaver],
                         ids=["port", "jax"])
def test_total_starvation_reads_zero_not_perfect(cls):
    """A registered tenant that never held the device drags the ratio to
    0.0, in both packages."""
    inter = cls({"fed1": 1.0, "fed2": 1.0, "starved": 1.0})
    for _ in range(PROLOGUE_HOLDS + 3):
        inter.release("fed1", 1.0)
        inter.release("fed2", 1.0)
    assert inter.fairness_ratio(steady=False) == 0.0
    assert inter.fairness_ratio(steady=True) == 0.0


def test_absent_job_yields_slot():
    """A job with nothing pending never blocks the grant."""
    inter = RoundInterleaver({"idle": 1.0, "busy": 1.0})
    inter.release("busy", 100.0)  # busy is far over budget
    done = threading.Event()

    def worker():
        inter.acquire("busy")  # idle is not waiting: granted anyway
        done.set()
        inter.release("busy", 0.1)

    threading.Thread(target=worker, daemon=True).start()
    assert done.wait(timeout=5), "grant blocked on an absent tenant"


def test_gate_is_reentrant_and_charges_the_outermost_hold():
    inter = RoundInterleaver({"j": 1.0})
    timer = RoundTimer()
    lock = threading.RLock()
    gate = inter.gate("j", device_lock=lock, timer=timer)
    with gate:
        with gate:  # an inner hold takes no DRR slot
            time.sleep(0.01)
        assert inter._busy
    assert not inter._busy
    assert timer.counters["sched_device_acquires"] == 1
    assert timer.counts["sched_device_time"] == 1
    assert timer.totals["sched_device_time"] >= 0.01
    assert inter.usage()["j"] == pytest.approx(
        timer.totals["sched_device_time"])
    assert "sched_gate_wait" in timer.totals
    # the default lock is the cross-silo device lock
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import _DEVICE_LOCK
    assert inter.gate("j")._device_lock is _DEVICE_LOCK
