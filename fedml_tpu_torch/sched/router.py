"""Job-scoped frame routing: N federation jobs over one endpoint a rank (the
port's copy of ``fedml_tpu/sched/router.py``).

The cross-silo stack assumes one federation a transport endpoint. Multi-job
tenancy multiplexes instead: every frame is tagged with its job
(``WIRE_JOB_KEY``, a header key like the reliable transport's
``__wire_seq__`` stamp) and one physical endpoint a rank carries every
job's traffic. The pieces:

- :class:`JobChannel`, one job's virtual endpoint. It is a
  ``BaseCommunicationManager``, so the reliable-delivery layer composes
  under it: each channel keeps its own stream epoch, per-peer sequence
  counters and dedup windows, as a dedicated endpoint would. A channel
  stamps outbound frames with its job tag and its own ``[epoch, seq]``
  (the physical backend's stamp is idempotent and keeps it), and delivers
  inbound frames to its observers on its own receive loop, so one job's
  long local training never blocks another job's frames.
- :class:`JobRouter`, the demux: the physical endpoint's sole observer,
  routing every inbound frame to the channel of its tag. Frames of an
  unknown or stopped job are counted (``sched_unrouted_frames``) and
  dropped. The router owns the one pump thread that drains the physical
  endpoint.
- :class:`SharedFabric`, one physical endpoint and router a rank for an
  in-process multi-job launch (INPROC, or TCP with every rank here).

Receive-side dedup runs at both layers with the same ``(peer, job)``
stream keys (``comm/base.py``): the physical endpoint sheds transport-retry
duplicates before the demux, the channel whatever slips between router and
observer. A single-tenant frame carries no tag.
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
from typing import Dict, Optional

from fedml_tpu_torch.comm.base import (WIRE_JOB_KEY,
                                       BaseCommunicationManager, Observer)
from fedml_tpu_torch.comm.message import Message

_STOP = object()


class JobChannel(BaseCommunicationManager):
    """One job's virtual endpoint over a shared physical endpoint, with the
    whole reliable-delivery bookkeeping of its own (epoch, per-peer seq
    streams, dedup windows): a restarted job restarts its streams only."""

    def __init__(self, router: "JobRouter", job_id: str):
        super().__init__()
        self.router = router
        self.job_id = str(job_id)
        self._inbox: "queue.Queue" = queue.Queue()
        self._running = False
        self._stopped = False

    # -- wire accounting: the physical endpoint encodes and counts the
    # frames; the channel reports its job's slice of those tallies
    @property
    def bytes_sent(self) -> int:
        return self.router.physical.job_bytes(self.job_id)[0]

    @bytes_sent.setter
    def bytes_sent(self, value) -> None:
        pass  # the base initializer zeroes it; the tally lives downstairs

    @property
    def bytes_received(self) -> int:
        return self.router.physical.job_bytes(self.job_id)[1]

    @bytes_received.setter
    def bytes_received(self, value) -> None:
        pass

    def all_counters(self) -> dict:
        """This channel's own events (its dedup windows) merged with the
        physical endpoint's slice for its job (send retries, physical
        dedup drops): the launcher's per-job ``ft_*`` roll-up reads real
        transport events."""
        out = dict(self.router.physical.job_counters(self.job_id))
        with self._bytes_lock:  # bump() on the receive loop inserts keys
            own = dict(self.counters)
        for k, v in own.items():
            out[k] = out.get(k, 0) + int(v)
        return out

    # -- sending -----------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        msg.add(WIRE_JOB_KEY, self.job_id)
        # this channel's epoch and seq; the physical backend's stamp is
        # idempotent, so the job-scoped stamp survives
        self._stamp_seq(msg)
        self.router.physical.send_message(msg)

    # -- receiving ---------------------------------------------------------
    def _deliver(self, item) -> None:
        """Called by the router on the pump thread: queue for this
        channel's own receive loop."""
        self._inbox.put(item)

    def handle_receive_message(self) -> None:
        self._running = True
        self.router.ensure_pumping()
        while self._running:
            item = self._inbox.get()
            if item is _STOP:
                break
            if isinstance(item, BaseException):
                raise item
            self._notify(item)

    def stop_receive_message(self) -> None:
        self._running = False
        self._stopped = True
        self._inbox.put(_STOP)
        self.router.release_channel(self)


class JobRouter(Observer):
    """The demultiplexer: the physical endpoint's sole observer, routing
    each inbound frame to the channel of its job tag."""

    def __init__(self, physical: BaseCommunicationManager):
        self.physical = physical
        self._channels: Dict[str, JobChannel] = {}
        self._lock = threading.Lock()
        self._pump: Optional[threading.Thread] = None
        physical.add_observer(self)

    def channel(self, job_id: str) -> JobChannel:
        """The virtual endpoint of ``job_id``, created on first use. A
        stopped channel is dead (its receive loop ended): a relaunched job
        gets a fresh one, with a new epoch and new streams, as a restarted
        dedicated endpoint would."""
        key = str(job_id)
        with self._lock:
            ch = self._channels.get(key)
            if ch is None or ch._stopped:
                ch = self._channels[key] = JobChannel(self, key)
            return ch

    # -- demux (on the pump thread) ------------------------------------------
    def receive_message(self, msg_type: int, msg: Message) -> None:
        job = msg.msg_params.get(WIRE_JOB_KEY)
        with self._lock:
            ch = self._channels.get(str(job)) if job is not None else None
        if ch is None or ch._stopped:
            # a tenant not running here, or finished: count and drop, so
            # one job's stray frame never ends the fabric
            self.physical.bump("sched_unrouted_frames")
            logging.debug("job router: dropping a frame of unknown or "
                          "stopped job %r (type %s)", job, msg_type)
            return
        ch._deliver(msg)

    def release_channel(self, ch: JobChannel) -> None:
        """Reclaim a stopped channel: drop it from the table and purge the
        physical endpoint's ``(peer, job)`` streams, so a persistent fabric
        does not keep dead tenants' windows. Guarded by identity: if a
        relaunched job already owns a fresh channel under this id (the
        stop-to-release window races :meth:`channel`), a purge by job id
        would fold the relaunch's live epochs into the dead set and wedge
        its streams; ``_accept``'s epoch supersede retires the old
        incarnation's state instead."""
        with self._lock:
            if self._channels.get(ch.job_id) is not ch:
                return
            del self._channels[ch.job_id]
        self.physical.purge_streams(ch.job_id)

    # -- the one physical pump -----------------------------------------------
    def ensure_pumping(self) -> None:
        """Start the thread that drains the physical endpoint (idempotent;
        every channel's receive loop calls it)."""
        with self._lock:
            if self._pump is not None and self._pump.is_alive():
                return
            self._pump = threading.Thread(target=self._pump_loop,
                                          daemon=True,
                                          name="jobrouter-pump")
            self._pump.start()

    def _pump_loop(self) -> None:
        try:
            self.physical.handle_receive_message()
        except BaseException as exc:  # noqa: BLE001, fanned out below
            # the shared fabric died: every tenant hears of it, where a
            # silent pump death would look like N hung federations
            logging.error("job router: the physical endpoint failed: %r",
                          exc)
            with self._lock:
                channels = list(self._channels.values())
            for ch in channels:
                ch._deliver(ConnectionError(
                    f"shared fabric endpoint failed: {exc!r}"))
        finally:
            # a dead pump is restartable: a channel created after this
            # exit calls ensure_pumping and gets a fresh pump
            with self._lock:
                self._pump = None

    def stop(self) -> None:
        """Stop every channel loop and the physical pump (the scheduler's
        teardown; each job stops its own channels at FINISH)."""
        with self._lock:
            channels = list(self._channels.values())
        for ch in channels:
            ch.stop_receive_message()
        self.physical.stop_receive_message()


def _loopback_addresses(size: int) -> Dict[int, tuple]:
    """``{rank: ("127.0.0.1", port)}`` with ports the OS assigned (bind 0,
    read, close); the short close-to-rebind window is fine in process."""
    socks, addrs = [], {}
    for rank in range(size):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        addrs[rank] = ("127.0.0.1", s.getsockname()[1])
    for s in socks:
        s.close()
    return addrs


class SharedFabric:
    """One physical endpoint and job router a rank: the comm substrate of
    an in-process multi-job launch. ``backend`` is any registry backend
    (INPROC by default; TCP when every rank of every job lives in this
    process). A job with fewer silos than ``size - 1`` never addresses the
    upper ranks."""

    def __init__(self, backend: str, size: int, *, addresses=None,
                 wire_codec: bool = True, token=None, fault_plan=None):
        from fedml_tpu_torch.comm import create_comm_manager
        from fedml_tpu_torch.comm.inproc import InProcRouter
        self.backend = backend.upper()
        self.size = int(size)
        if self.backend == "TCP" and addresses is None:
            # a one-process wire-level fabric comes up without a written
            # address map: fresh loopback ports a rank
            addresses = _loopback_addresses(self.size)
        router = (InProcRouter()
                  if self.backend in ("INPROC", "MPI") else None)
        self.routers: Dict[int, JobRouter] = {}
        for rank in range(self.size):
            physical = create_comm_manager(
                backend, rank, self.size, router=router,
                addresses=addresses, wire_codec=wire_codec, token=token,
                fault_plan=fault_plan)
            self.routers[rank] = JobRouter(physical)

    def channel(self, job_id: str, rank: int) -> JobChannel:
        return self.routers[rank].channel(job_id)

    def comm_factory(self, job_id: str):
        """A ``comm_factory(rank)`` for ``launch_federation`` that hands
        the job its virtual endpoints over this fabric."""
        return lambda rank: self.channel(job_id, rank)

    def stop(self) -> None:
        for rank in sorted(self.routers):
            self.routers[rank].stop()
