"""Rank event loops: ClientManager / ServerManager (reference L2; the
port's copy of ``fedml_tpu/comm/manager.py``).

Parity with fedml_core/distributed/{client/client_manager.py:13-69,
server/server_manager.py:12-63}: handler-dict dispatch keyed by message type,
``run()`` registers handlers then blocks in the backend's receive loop,
``finish()`` stops cleanly (the reference calls ``MPI.COMM_WORLD.Abort()`` —
a quirk we do not carry forward; SURVEY "fork quirks").
"""

from __future__ import annotations

from typing import Callable, Dict

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import Message


class _ManagerBase(Observer):
    def __init__(self, rank: int, size: int,
                 com_manager: BaseCommunicationManager):
        self.rank = rank
        self.size = size
        self.com_manager = com_manager
        self.com_manager.add_observer(self)
        self.message_handler_dict: Dict[int, Callable[[Message], None]] = {}

    def register_message_receive_handlers(self) -> None:
        """Subclasses register their protocol handlers here."""

    def register_message_receive_handler(
            self, msg_type: int,
            handler: Callable[[Message], None]) -> None:
        self.message_handler_dict[msg_type] = handler

    def receive_message(self, msg_type: int, msg: Message) -> None:
        self.message_handler_dict[msg_type](msg)

    def send_message(self, msg: Message) -> None:
        self.com_manager.send_message(msg)

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()

    def finish(self) -> None:
        self.com_manager.stop_receive_message()


class ClientManager(_ManagerBase):
    pass


class ServerManager(_ManagerBase):
    pass
