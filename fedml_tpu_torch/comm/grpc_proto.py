"""Reference-wire-compatible gRPC mode (the port's copy of
``fedml_tpu/comm/grpc_proto.py``).

The reference defines a concrete proto service
(fedml_core/distributed/communication/gRPC/proto/grpc_comm_manager.proto:1-17):

    service gRPCCommManager {
      rpc sendMessage (CommRequest) returns (CommResponse);
      rpc handleReceiveMessage(CommRequest) returns (CommResponse);
    }
    message CommRequest  { int32 client_id = 1; string message = 2; }
    message CommResponse { int32 client_id = 1; string message = 2; }

and ships `request.message = msg.to_json()` through it
(grpc_comm_manager.py:46-72), where the JSON codec is the plain
``json.dumps(msg_params)`` of message.py:62 (tensors pre-converted to nested
lists by the mobile path, fedml_api/distributed/fedavg/utils.py:12).

This module speaks that exact wire format WITHOUT protoc code-gen: the two
messages are trivial proto3 records (field 1 varint, field 2 length-delimited
UTF-8), hand-encoded below, and the service/method names are registered via
grpc's generic handler API. A silo running the reference's generated stubs
can therefore exchange rounds with a ``ProtoGrpcCommManager`` silo unmodified.

The binary-frame backend (grpc_backend.py) remains the default — it moves
model pytrees zero-copy instead of via JSON lists — this codec exists for
interop.
"""

from __future__ import annotations

import json
from typing import Any, Tuple

import numpy as np

from fedml_tpu_torch.comm.grpc_backend import GrpcEndpoint, grpc
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.serialization import SharedPayload

SERVICE = "gRPCCommManager"          # proto has no package ⇒ bare service name
SEND_METHOD = f"/{SERVICE}/sendMessage"
_MAX_LEN = 1 << 30


# -- proto3 wire codec (CommRequest / CommResponse share one shape) ---------

def _encode_varint(value: int) -> bytes:
    if value < 0:  # proto3 int32: negatives are 10-byte two's-complement
        value += 1 << 64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")
    if result >= 1 << 63:  # undo int32-as-uint64 sign extension
        result -= 1 << 64
    return result, pos


def encode_comm_message(client_id: int, message: str) -> bytes:
    """Serialize a CommRequest/CommResponse to proto3 wire bytes."""
    out = bytearray()
    if client_id:  # proto3 omits default-valued fields
        out += b"\x08" + _encode_varint(client_id)      # field 1, varint
    if message:
        data = message.encode("utf-8")
        out += b"\x12" + _encode_varint(len(data)) + data  # field 2, bytes
    return bytes(out)


def decode_comm_message(buf: bytes) -> Tuple[int, str]:
    """Parse proto3 wire bytes into (client_id, message)."""
    client_id, message = 0, ""
    pos = 0
    while pos < len(buf):
        tag, pos = _decode_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            client_id, pos = _decode_varint(buf, pos)
        elif field == 2 and wire == 2:
            length, pos = _decode_varint(buf, pos)
            message = buf[pos:pos + length].decode("utf-8")
            pos += length
        elif wire == 0:  # unknown varint field: skip
            _, pos = _decode_varint(buf, pos)
        elif wire == 2:  # unknown length-delimited field: skip
            length, pos = _decode_varint(buf, pos)
            pos += length
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return client_id, message


# -- JSON payload codec (message.py:62 semantics) ---------------------------

def _jsonify(value: Any) -> Any:
    """Arrays → nested lists, the reference's mobile/JSON convention
    (fedml_api/distributed/fedavg/utils.py:12 transform_tensor_to_list)."""
    if isinstance(value, SharedPayload):
        # a broadcast's encode-once wrapper: the JSON wire has no buffer
        # cache, so its tree encodes in place
        return _jsonify(value.value)
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    if hasattr(value, "dtype") and hasattr(value, "tolist"):  # tensors
        return value.tolist()
    if isinstance(value, dict):
        return {k: _jsonify(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonify(v) for v in value]
    return value


def _restore_tensors(value: Any) -> Any:
    """Nested lists → ndarrays inside a MODEL-PARAMS payload — the
    reference's receive-side convention
    (fedml_api/distributed/fedavg/utils.py:6 transform_list_to_tensor,
    applied to JSON payloads on the mobile/MQTT path, and like the
    reference scoped to the model payload only: other params keep their
    Python types). float64 drops to float32 exactly as the reference's
    ``.float()`` does. A zero-size leaf comes back as float32 [0] — the
    JSON wire cannot carry its original shape/dtype (use the binary
    backends for models with empty params).

    Coercion is by VALUE SHAPE, not position: ANY homogeneous numeric
    nested list under the model payload becomes an ndarray (so a
    structural int list — e.g. a shape stored inside model_params — comes
    back as int64 ndarray, and float lists as float32). This mirrors
    transform_list_to_tensor, which walks every key of the dict the same
    way; keep non-tensor metadata in other message params (they are left
    untouched), or use the binary backends for exact type round-trips."""
    if isinstance(value, dict):
        return {k: _restore_tensors(v) for k, v in value.items()}
    if isinstance(value, list):
        try:
            arr = np.asarray(value)
        except (ValueError, TypeError):
            return [_restore_tensors(v) for v in value]
        if arr.dtype.kind not in "fiu":
            return [_restore_tensors(v) for v in value]
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return arr
    return value


def message_from_json(payload: str) -> Message:
    msg = Message()
    params = json.loads(payload)
    key = Message.MSG_ARG_KEY_MODEL_PARAMS
    if isinstance(params, dict) and key in params:
        params[key] = _restore_tensors(params[key])
    msg.msg_params = params
    return msg


def message_to_json(msg: Message) -> str:
    return json.dumps(_jsonify(msg.get_params()))


class ProtoGrpcCommManager(GrpcEndpoint):
    """Drop-in alternative to GrpcCommManager speaking the reference's wire.

    Same constructor contract (rank + explicit ``{rank: (host, port)}`` map —
    the reference's hardcoded IPs, grpc_comm_manager.py:51-56, are a fork
    quirk not worth reproducing), but every RPC is byte-identical to what the
    reference's generated ``gRPCCommManagerStub.sendMessage`` emits.
    """

    BACKEND = "GRPC_PROTO"
    SERVICE = SERVICE  # the module constant above
    MAX_LEN = _MAX_LEN

    def _rpc_handler(self):
        def handle(request: bytes, context) -> bytes:
            _, payload = decode_comm_message(request)
            self._inbox.put(payload)
            return encode_comm_message(self.rank, "message received")

        return grpc.unary_unary_rpc_method_handler(
            handle, request_deserializer=None, response_serializer=None)

    def _decode(self, item) -> Message:
        return message_from_json(item)

    def send_message(self, msg: Message) -> None:
        frame = encode_comm_message(self.rank, message_to_json(msg))
        self._channel(msg.get_receiver_id()).unary_unary(SEND_METHOD)(
            frame, timeout=60)
