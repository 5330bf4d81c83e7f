"""In-process backend: a queue per rank inside one shared router (the
port's copy of ``fedml_tpu/comm/inproc.py``).

Replaces the reference's localhost-MPI testing setup (``hostname >
mpi_host_file; mpirun -np N``, run_fedavg_distributed_pytorch.sh:19-22):
ranks are threads, and the receive loop blocks on its queue (the reference
polls every 0.3 s, mpi/com_manager.py:78). Every message crosses as an
encoded frame, exactly as on a socket, and the frame lengths are the wire
bytes.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict

from fedml_tpu_torch.comm.base import WIRE_JOB_KEY, BaseCommunicationManager
from fedml_tpu_torch.comm.message import Message

_STOP = object()


class InProcRouter:
    """Shared mailbox fabric for one simulated federation."""

    def __init__(self) -> None:
        self._queues: Dict[int, "queue.Queue"] = {}
        self._lock = threading.Lock()

    def mailbox(self, rank: int) -> "queue.Queue":
        with self._lock:
            if rank not in self._queues:
                self._queues[rank] = queue.Queue()
            return self._queues[rank]


class InProcCommManager(BaseCommunicationManager):
    def __init__(self, router: InProcRouter, rank: int, size: int):
        super().__init__()
        self.router = router
        self.rank = rank
        self.size = size
        self._inbox = router.mailbox(rank)
        self._running = False

    def send_message(self, msg: Message) -> None:
        # stamped like the socket backends: the fault injector
        # (comm/faults.py) duplicates frames above this layer, and the
        # receive side's seq dedup must shed the copies here too
        self._stamp_seq(msg)
        frame = msg.to_bytes()
        self._count_sent(len(frame), msg.msg_params.get(WIRE_JOB_KEY))
        self.router.mailbox(msg.get_receiver_id()).put(frame)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            item = self._inbox.get()
            if item is _STOP:
                break
            msg = Message.from_bytes(item)
            self._count_received(len(item), msg.msg_params.get(WIRE_JOB_KEY))
            self._notify(msg)

    def stop_receive_message(self) -> None:
        self._running = False
        self._inbox.put(_STOP)
