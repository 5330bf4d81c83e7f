"""Message envelope: typed header + a payload tree (the port's copy of
``fedml_tpu/comm/message.py``).

Parity with the reference's dict-shaped ``Message``
(fedml_core/distributed/communication/message.py:5-74): the same header keys
(``msg_type``/``sender``/``receiver``), ``add``/``get`` payload access, and a
wire codec. Unlike the reference (JSON for gRPC/MQTT, pickle for MPI), the
wire format is one binary frame via the zero-copy codec in
``fedml_tpu_torch/comm/serialization.py``, so model trees are never
re-encoded element-wise.
"""

from __future__ import annotations

from typing import Any, Dict

from fedml_tpu_torch.comm import serialization


class Message:
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"

    def __init__(self, type: int = 0, sender_id: int = 0,
                 receiver_id: int = 0):
        self.msg_params: Dict[str, Any] = {
            Message.MSG_ARG_KEY_TYPE: type,
            Message.MSG_ARG_KEY_SENDER: sender_id,
            Message.MSG_ARG_KEY_RECEIVER: receiver_id,
        }

    # -- header ------------------------------------------------------------
    @property
    def type(self) -> int:
        return self.msg_params[Message.MSG_ARG_KEY_TYPE]

    def get_type(self) -> int:
        return self.type

    def get_sender_id(self) -> int:
        return self.msg_params[Message.MSG_ARG_KEY_SENDER]

    def get_receiver_id(self) -> int:
        return self.msg_params[Message.MSG_ARG_KEY_RECEIVER]

    # -- payload -----------------------------------------------------------
    def add(self, key: str, value: Any) -> "Message":
        self.msg_params[key] = value
        return self

    add_params = add

    def get(self, key: str) -> Any:
        return self.msg_params[key]

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    # -- codec -------------------------------------------------------------
    def to_bytes(self) -> bytes:
        return serialization.dumps(self.msg_params)

    def to_parts(self) -> list:
        """The encoded frame as its constituent buffers (header and raw
        leaf buffers) for the socket transports, which write them without
        joining them into one contiguous copy."""
        return serialization.dumps_parts(self.msg_params)

    @classmethod
    def from_bytes(cls, frame) -> "Message":
        msg = cls()
        msg.msg_params = serialization.loads(frame)
        return msg

    def __repr__(self) -> str:
        keys = [k for k in self.msg_params
                if k not in (Message.MSG_ARG_KEY_TYPE,
                             Message.MSG_ARG_KEY_SENDER,
                             Message.MSG_ARG_KEY_RECEIVER)]
        return (f"Message(type={self.type}, "
                f"{self.get_sender_id()}->{self.get_receiver_id()}, "
                f"payload={keys})")
