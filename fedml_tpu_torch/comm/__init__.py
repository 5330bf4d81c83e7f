"""Cross-silo communication layer (reference L1:
fedml_core/distributed/communication); the port's counterpart of
``fedml_tpu/comm``.

It keeps the reference's contracts (Message / Observer /
BaseCommunicationManager / ClientManager / ServerManager) so the protocol
code is backend-agnostic. The port runs the in-process router
(``inproc``); payloads are trees of numpy arrays serialized with the
zero-copy codec (serialization.py), compressed on the device by
compression.py.
"""

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.manager import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.registry import create_comm_manager

__all__ = [
    "BaseCommunicationManager", "Observer", "Message", "ClientManager",
    "ServerManager", "create_comm_manager",
]
