"""Cross-silo communication layer (reference L1:
fedml_core/distributed/communication); the port's counterpart of
``fedml_tpu/comm``.

It keeps the reference's contracts (Message / Observer /
BaseCommunicationManager / ClientManager / ServerManager) so the protocol
code is backend-agnostic, over the JAX package's transports: the
in-process router (``inproc``), framed TCP sockets (``tcp``), chunked
gRPC (``grpc_backend``) and the reference's proto wire (``grpc_proto``),
MQTT with its in-process broker (``mqtt``) and the native dial-out broker
(``routed``). Payloads are trees of numpy arrays serialized with the
zero-copy codec (serialization.py), compressed on the device by
compression.py; the socket transports retry under reliable.py's policy
and shed the duplicates a retry creates (base.py).
"""

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.manager import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.registry import create_comm_manager
from fedml_tpu_torch.comm.reliable import RetryPolicy, TransportError

__all__ = [
    "BaseCommunicationManager", "Observer", "Message", "ClientManager",
    "ServerManager", "create_comm_manager", "RetryPolicy", "TransportError",
]
