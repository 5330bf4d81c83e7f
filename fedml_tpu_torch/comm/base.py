"""Backend and observer ABCs (reference base_com_manager.py:7-27,
observer.py:4-7); the port's copy of ``fedml_tpu/comm/base.py``.

The JAX package's base also carries the reliable-delivery machinery
(per-stream sequence stamps and receive-side dedup for transport retries)
and per-job byte slices for multi-tenant fabrics. The port has neither
retrying transports nor the scheduler yet (ROADMAP Slice D), so its base
keeps the observer fan-out, the fan-out ``broadcast`` and the wire byte
counters only.
"""

from __future__ import annotations

import abc
import threading
from typing import Dict

from fedml_tpu_torch.comm.message import Message


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
    measured at the wire, not estimated from array sizes. Backends that
    hand objects over in memory report 0.
    """

    def __init__(self) -> None:
        self._observers = []
        self._bytes_lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0

    def _count_sent(self, n: int) -> None:
        with self._bytes_lock:
            self.bytes_sent += int(n)

    def _count_received(self, n: int) -> None:
        with self._bytes_lock:
            self.bytes_received += int(n)

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    def broadcast(self, msgs) -> Dict[str, int]:
        """Send one message per peer, in order; the first failure
        propagates. Returns ``{"enqueued": n, "max_queue_depth": 0}``, the
        fan-out stats the JAX package's overlapped transports report."""
        for msg in msgs:
            self.send_message(msg)
        return {"enqueued": len(msgs), "max_queue_depth": 0}

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def _notify(self, msg: Message) -> None:
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Block, dispatching inbound messages to observers, until stopped."""
        ...

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...
