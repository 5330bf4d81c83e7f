"""The port's job-tagged demux (``fedml_tpu_torch/sched/router.py``): the
JAX suite's ``TestJobRouter`` and ``TestChannelRelease``
(``tests/test_sched.py``) on the port's in-process backend, the per-job
byte slices of a TCP fabric against the endpoint's totals, and a pump
failure reaching every channel."""

import threading
import time

from fedml_tpu_torch.comm.base import WIRE_JOB_KEY
from fedml_tpu_torch.comm.inproc import InProcCommManager, InProcRouter
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.sched import SharedFabric
from fedml_tpu_torch.sched.router import JobRouter

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


class _Sink:
    def __init__(self):
        self.got = []

    def receive_message(self, msg_type, msg):
        self.got.append((msg_type, msg))


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _listen(ch):
    sink = _Sink()
    ch.add_observer(sink)
    threading.Thread(target=ch.handle_receive_message, daemon=True).start()
    return sink


def _pair():
    fabric = InProcRouter()
    phys0 = InProcCommManager(fabric, 0, 2)
    phys1 = InProcCommManager(fabric, 1, 2)
    return phys0, phys1, JobRouter(phys0), JobRouter(phys1)


def test_demux_isolates_jobs_over_one_endpoint():
    """Two jobs' traffic over one physical endpoint pair lands on each
    job's observers, with the job tag on the wire."""
    _, _, r0, r1 = _pair()
    sinks = {job: _listen(r1.channel(job)) for job in ("alpha", "beta")}
    send_a, send_b = r0.channel("alpha"), r0.channel("beta")
    for i in range(3):
        send_a.send_message(Message(4, 0, 1).add("n", i))
    send_b.send_message(Message(4, 0, 1).add("n", 99))
    assert _wait_until(lambda: len(sinks["alpha"].got) == 3)
    assert _wait_until(lambda: len(sinks["beta"].got) == 1)
    assert [m.get("n") for _, m in sinks["alpha"].got] == [0, 1, 2]
    assert sinks["beta"].got[0][1].get("n") == 99
    assert sinks["alpha"].got[0][1].get(WIRE_JOB_KEY) == "alpha"
    # the encoded frames were counted in each job's slice, and the slices
    # are the endpoint's totals
    sent = [r0.physical.job_bytes(j)[0] for j in ("alpha", "beta")]
    assert all(n > 0 for n in sent)
    assert sum(sent) == r0.physical.bytes_sent
    assert send_a.bytes_sent == sent[0]
    assert _wait_until(lambda: r1.channel("alpha").bytes_received
                       + r1.channel("beta").bytes_received
                       == r1.physical.bytes_received)
    r0.stop()
    r1.stop()


def test_per_job_dedup_windows():
    """A duplicate frame is shed by the receiving job's own window; the
    other job's stream with the same numbers is untouched."""
    _, _, r0, r1 = _pair()
    sinks = {job: _listen(r1.channel(job)) for job in ("alpha", "beta")}
    msg = Message(4, 0, 1).add("n", 7)
    r0.channel("alpha").send_message(msg)
    # a transport retry sends the same stamped message again
    r0.channel("alpha").send_message(msg)
    r0.channel("beta").send_message(Message(4, 0, 1).add("n", 8))
    assert _wait_until(lambda: len(sinks["beta"].got) == 1)
    assert _wait_until(lambda: len(sinks["alpha"].got) >= 1)
    time.sleep(0.1)
    assert len(sinks["alpha"].got) == 1
    # shed at the physical endpoint, in the alpha tenant's slice only
    assert r1.physical.job_counters("alpha") == {"dedup_drops": 1}
    assert r1.physical.job_counters("beta") == {}
    r0.stop()
    r1.stop()


def test_per_job_counter_slices_reach_the_channel():
    """Events credited with a job tag on the physical endpoint surface in
    that job's channel roll-up and never in a co-tenant's."""
    phys, _, router, _ = _pair()
    ch_a, ch_b = router.channel("alpha"), router.channel("beta")
    phys.bump("retries", job="alpha")
    phys.bump("retries", job="alpha")
    phys.bump("dedup_drops", job="beta")
    phys.bump("conn_errors")  # untagged: the endpoint's only
    ch_a.counters["dedup_drops"] += 1  # the channel's own window
    a, b = ch_a.all_counters(), ch_b.all_counters()
    assert a.get("retries") == 2
    assert a.get("dedup_drops") == 1
    assert "conn_errors" not in a
    assert b == {"dedup_drops": 1}
    router.stop()


def test_unknown_job_counted_and_dropped():
    _, phys1, r0, r1 = _pair()
    sink = _listen(r1.channel("known"))
    r0.channel("ghost").send_message(Message(4, 0, 1))
    r0.channel("known").send_message(Message(4, 0, 1))
    assert _wait_until(lambda: len(sink.got) == 1)
    assert phys1.counters.get("sched_unrouted_frames", 0) == 1
    r0.stop()
    r1.stop()


def test_stale_release_spares_relaunched_jobs_live_streams():
    """stop-to-release racing a relaunch: once ``channel()`` handed out a
    fresh channel under the same id, the stale release must not purge by
    job id (that would fold the relaunch's live epoch into the dead set)."""
    com = InProcCommManager(InProcRouter(), 0, 2)
    jr = JobRouter(com)
    ch1 = jr.channel("j")
    ch1._stopped = True          # mid-stop, release not yet run
    ch2 = jr.channel("j")        # the relaunch wins the id
    assert ch2 is not ch1
    com._seen[(1, "j")] = (123, {1}, 1)  # the relaunch's live stream
    jr.release_channel(ch1)      # the stale release: a no-op
    assert (1, "j") in com._seen
    assert 123 not in com._old_epochs[(1, "j")]
    ch2._stopped = True
    jr.release_channel(ch2)      # the current channel purges
    assert (1, "j") not in com._seen
    assert 123 in com._old_epochs[(1, "j")]


def test_a_dead_pump_reaches_every_channel_as_connection_error():
    class _Dying(InProcCommManager):
        def handle_receive_message(self):
            raise OSError("planted: the shared endpoint died")

    router = JobRouter(_Dying(InProcRouter(), 1, 2))
    errors = {}

    def listen(job):
        try:
            router.channel(job).handle_receive_message()
        except ConnectionError as exc:
            errors[job] = exc

    threads = [threading.Thread(target=listen, args=(j,), daemon=True)
               for j in ("alpha", "beta")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sorted(errors) == ["alpha", "beta"]
    assert all("planted" in str(e) for e in errors.values())


def test_tcp_fabric_job_slices_sum_to_the_endpoint_totals():
    """Over a loopback TCP fabric the per-job byte slices of each
    endpoint add up to its totals, both ways, and each channel reports
    its own slice."""
    fabric = SharedFabric("TCP", 2)
    try:
        sinks = {job: _listen(fabric.channel(job, 1))
                 for job in ("alpha", "beta")}
        for job, n in (("alpha", 3), ("beta", 2)):
            for i in range(n):
                fabric.channel(job, 0).send_message(
                    Message(4, 0, 1).add("n", i))
        assert _wait_until(lambda: [len(sinks[j].got)
                                    for j in ("alpha", "beta")] == [3, 2])
        tx, rx = fabric.routers[0].physical, fabric.routers[1].physical
        sent = {j: tx.job_bytes(j)[0] for j in ("alpha", "beta")}
        got = {j: rx.job_bytes(j)[1] for j in ("alpha", "beta")}
        assert all(v > 0 for v in sent.values())
        assert sum(sent.values()) == tx.bytes_sent
        assert got == sent
        assert sum(got.values()) == rx.bytes_received
        for j in ("alpha", "beta"):
            assert fabric.channel(j, 0).bytes_sent == sent[j]
            assert fabric.channel(j, 1).bytes_received == got[j]
    finally:
        fabric.stop()
