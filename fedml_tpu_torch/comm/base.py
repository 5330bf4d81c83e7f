"""Backend and observer ABCs (reference base_com_manager.py:7-27,
observer.py:4-7); the port's copy of ``fedml_tpu/comm/base.py``.

Besides the observer fan-out and the wire byte counters, the base carries
the reliable-delivery bookkeeping the retrying transports (tcp.py,
grpc_backend.py) rely on: a sending backend stamps each message with a
per-stream ``[epoch, seq]`` (:meth:`_stamp_seq`), and :meth:`_notify`
drops a frame whose stamp was already delivered, so a retry of a frame
that did land is never delivered twice. Fault-tolerance event counts land
in :attr:`counters`. On a shared endpoint of the multi-job scheduler
(``sched/router.py``) every frame carries its job's tag: the streams are
keyed per ``(peer, job)``, and the wire bytes and event counters keep a
slice per job (:meth:`job_bytes`, :meth:`job_counters`), credited where the
frame and so its tag is in hand.
"""

from __future__ import annotations

import abc
import os
import threading
from collections import defaultdict
from typing import Dict, Set, Tuple

from fedml_tpu_torch.comm.message import Message

#: per-stream ``[epoch, seq]`` stamp, written into the message header by
#: the sending backend. A retried frame reuses its stamp (stamping is
#: idempotent), so the receive-side dedup sheds the duplicate a retry of an
#: already-delivered frame creates. The epoch is drawn fresh per endpoint
#: incarnation: a restarted silo's stream starts over at seq 1 under a new
#: epoch, so its frames are not taken for duplicates of its previous life's.
WIRE_SEQ_KEY = "__wire_seq__"

#: tenancy tag: reliable-delivery streams are keyed per ``(peer, job)``.
#: Written by a scheduler channel (``sched/router.py``); a single-tenant
#: frame carries none, and its stream key is ``(peer, None)``.
WIRE_JOB_KEY = "__wire_job__"

#: dedup window per stream: seqs older than (highest seen - window) are
#: treated as duplicates; 4096 in-flight frames per peer is far beyond the
#: protocol's round-trip pipelining
_DEDUP_WINDOW = 4096


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: int, msg: Message) -> None:
        ...


class BaseCommunicationManager(abc.ABC):
    """A transport endpoint for one rank. Backends deliver inbound messages
    by invoking every registered observer (the reference's notify pattern,
    mpi com_manager.py:80-83).

    Wire accounting: backends that encode frames credit
    ``bytes_sent``/``bytes_received`` with the actual encoded frame
    lengths (header and framing included), so compression ratios are
    measured at the wire, not estimated from array sizes.
    """

    def __init__(self) -> None:
        self._observers = []
        self._bytes_lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0
        #: fault-tolerance event counters (retries, dedup_drops,
        #: conn_errors, ...)
        self.counters: Dict[str, int] = defaultdict(int)
        self._seq_lock = threading.Lock()
        #: this endpoint incarnation's stream epoch (see WIRE_SEQ_KEY)
        self._seq_epoch = int.from_bytes(os.urandom(4), "big")
        #: (peer, job) -> last seq sent
        self._send_seq: Dict[Tuple, int] = defaultdict(int)
        #: (sender, job) -> (epoch, seen seq set, highest seq seen)
        self._seen: Dict[Tuple, Tuple[int, Set[int], int]] = {}
        #: (sender, job) -> superseded incarnation epochs: late frames from
        #: a previous life stay dropped instead of reopening a window
        self._old_epochs: Dict[Tuple, Set[int]] = defaultdict(set)
        #: (job, "tx" / "rx") -> bytes: each tenant's slice of the wire
        #: totals on a shared endpoint, what its channel reports as its own
        #: bytes. Not purged with the job's streams: the launcher credits
        #: the final wire bytes after FINISH stopped the channel.
        self._job_bytes: Dict[Tuple, int] = defaultdict(int)
        #: (job, counter name) -> count: each tenant's slice of the event
        #: counters (send retries, dedup drops), with the same lifetime
        self._job_counters: Dict[Tuple, int] = defaultdict(int)

    def _count_sent(self, n: int, job=None) -> None:
        with self._bytes_lock:
            self.bytes_sent += int(n)
            if job is not None:
                self._job_bytes[(job, "tx")] += int(n)

    def _count_received(self, n: int, job=None) -> None:
        with self._bytes_lock:
            self.bytes_received += int(n)
            if job is not None:
                self._job_bytes[(job, "rx")] += int(n)

    def _credit_job_received(self, n: int, job) -> None:
        """The per-job slice only, for backends that count a raw inbound
        frame on the socket thread, before its decode reveals the tag."""
        if job is None:
            return
        with self._bytes_lock:
            self._job_bytes[(job, "rx")] += int(n)

    def job_bytes(self, job) -> Tuple[int, int]:
        """(sent, received) bytes carried for ``job`` on this endpoint."""
        with self._bytes_lock:
            return (self._job_bytes.get((job, "tx"), 0),
                    self._job_bytes.get((job, "rx"), 0))

    def bump(self, name: str, n: int = 1, job=None) -> None:
        """Increment an event counter; ``job`` (when the event's frame is
        in hand) also credits the tenant's slice."""
        with self._bytes_lock:
            self.counters[name] += int(n)
            if job is not None:
                self._job_counters[(job, name)] += int(n)

    def job_counters(self, job) -> Dict[str, int]:
        """``job``'s slice of the event counters."""
        with self._bytes_lock:
            return {name: v for (j, name), v in self._job_counters.items()
                    if j == job}

    # -- reliable-delivery bookkeeping --------------------------------------
    def _stamp_seq(self, msg: Message) -> None:
        """Assign the next sequence number of the message's stream.
        Idempotent: a message that already carries a stamp keeps it, so a
        retried frame ships the same seq and the receiver drops the extra
        copy."""
        if WIRE_SEQ_KEY in msg.msg_params:
            return
        stream = (msg.get_receiver_id(), msg.msg_params.get(WIRE_JOB_KEY))
        with self._seq_lock:
            self._send_seq[stream] += 1
            seq = self._send_seq[stream]
        msg.add(WIRE_SEQ_KEY, [self._seq_epoch, seq])

    def _accept(self, msg: Message) -> bool:
        """Receive-side dedup: True iff this ``(sender, epoch, seq)`` has
        not been delivered before (unstamped messages always pass). A new
        epoch from a sender (a restarted silo) resets that stream's
        window; frames of its previous incarnation still in flight are
        dropped as stale."""
        stamp = msg.msg_params.get(WIRE_SEQ_KEY)
        if stamp is None:
            return True
        epoch, seq = int(stamp[0]), int(stamp[1])
        stream = (msg.get_sender_id(), msg.msg_params.get(WIRE_JOB_KEY))
        with self._seq_lock:
            cur_epoch, seen, high = self._seen.get(stream, (None, set(), 0))
            if epoch in self._old_epochs[stream]:
                return False
            if cur_epoch is not None and epoch != cur_epoch:
                self._old_epochs[stream].add(cur_epoch)
                seen, high = set(), 0
            if seq in seen or seq <= high - _DEDUP_WINDOW:
                return False
            seen.add(seq)
            high = max(high, seq)
            # prune the window so long federations stay O(window) memory
            if len(seen) > 2 * _DEDUP_WINDOW:
                floor = high - _DEDUP_WINDOW
                seen = {s for s in seen if s > floor}
            self._seen[stream] = (epoch, seen, high)
        return True

    def purge_streams(self, job) -> None:
        """Drop the stream state whose job tag is ``job`` (a finished
        tenant on a shared endpoint): a relaunched job opens new streams
        under a new channel epoch, so these windows are never read again.
        Each purged incarnation's epoch joins ``_old_epochs`` (ints only)
        instead of being forgotten: a late retried frame of the dead
        incarnation stays dropped, where a forgotten epoch would make
        ``_accept`` take the relaunch's live epoch for the superseded one
        and wedge the new stream."""
        with self._seq_lock:
            for k in [k for k in self._send_seq if k[1] == job]:
                del self._send_seq[k]
            for k in [k for k in self._seen if k[1] == job]:
                epoch = self._seen[k][0]
                if epoch is not None:
                    self._old_epochs[k].add(epoch)
                del self._seen[k]

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    def broadcast(self, msgs, on_error=None) -> Dict[str, int]:
        """Send one message per peer. With ``on_error`` set, a peer's
        failure (the ``OSError`` family, ``TransportError`` included) is
        reported as ``on_error(receiver_id, exc)`` and the other sends
        proceed; ``on_error`` may run on a writer thread and after this
        returns (overlapped backends). Without it the first failure
        propagates. Returns ``{"enqueued": n, "max_queue_depth": d}``
        (0 when sends complete inline)."""
        enqueued = 0
        for msg in msgs:
            try:
                self.send_message(msg)
            except OSError as exc:
                if on_error is None:
                    raise
                on_error(msg.get_receiver_id(), exc)
            enqueued += 1
        return {"enqueued": enqueued, "max_queue_depth": 0}

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def _notify(self, msg: Message) -> None:
        if not self._accept(msg):
            self.bump("dedup_drops", job=msg.msg_params.get(WIRE_JOB_KEY))
            return
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Block, dispatching inbound messages to observers, until stopped."""
        ...

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...
