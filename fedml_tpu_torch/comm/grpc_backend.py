"""gRPC backend: chunked streaming transport for the cross-silo wire (the
port's copy of ``fedml_tpu/comm/grpc_backend.py``).

The reference defines ``service gRPCCommManager { rpc sendMessage
(CommRequest) returns (CommResponse) }`` with ``(client_id, message)`` fields
(gRPC/proto/grpc_comm_manager.proto:1-17) but hardcodes two receiver IPs
(grpc_comm_manager.py:51-56). Here ``sendMessage`` is a
client-streaming rpc: the sender walks the frame's constituent buffers
(``Message.to_parts`` — header + raw leaf buffers, never joined) and ships
~``_CHUNK``-byte messages, so the per-message limit only needs to clear one
chunk and total frame size is unbounded. No protoc code-gen needed: chunks
are raw bytes of our self-describing binary frame. Import is gated so
environments without grpcio still load the package.

Reliability: transient stream failures (``UNAVAILABLE``,
``DEADLINE_EXCEEDED``) are retried under a seeded backoff policy
(comm/reliable.py). Each retry restarts the stream FROM CHUNK 0 with the
same wire seq — a partial first attempt never reaches the inbox (the
server drops torn streams), and a complete-but-unacknowledged first
attempt is shed by the receiver's seq dedup (comm/base.py). Permanent
failures raise a non-transient ``TransportError`` immediately so callers
can tell a restarting peer from a misconfigured address.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.reliable import RetryPolicy, retry_call

try:
    import grpc
    HAS_GRPC = True
except ImportError:
    grpc = None
    HAS_GRPC = False

#: the JAX package's service name (the frames themselves differ: the
#: port's header is JSON, see serialization.py)
_SERVICE = "fedml_tpu.CommManager"
_METHOD = f"/{_SERVICE}/sendMessage"
#: stream chunk size, the only per-message budget the transport needs;
#: total frame size is unbounded
_CHUNK = 4 << 20
#: per-message cap: one chunk + protobuf/framing slack
_MSG_LEN = _CHUNK + (1 << 20)

_STOP = object()

#: how long a stopping endpoint lets its in-flight calls finish
STOP_GRACE_S = 1.0


def _iter_chunks(parts, chunk: int = _CHUNK) -> Iterator[bytes]:
    """Walk a ``dumps_parts`` buffer list as ~chunk-byte bytes messages.

    Small parts (the length prefix, the header, scalar-only payloads) are
    coalesced into one chunk; large array buffers are sliced. Only the
    per-chunk ``bytes()`` copies are ever materialized — never the frame.
    """
    pending: list = []
    pending_n = 0
    for p in parts:
        view = memoryview(p)
        off = 0
        while off < len(view):
            take = min(chunk - pending_n, len(view) - off)
            pending.append(view[off:off + take])
            pending_n += take
            off += take
            if pending_n == chunk:
                yield b"".join(pending)
                pending, pending_n = [], 0
    if pending:
        yield b"".join(pending)


def _is_transient_rpc(exc: BaseException) -> bool:
    """UNAVAILABLE (peer down/restarting, link flap) and DEADLINE_EXCEEDED
    (congestion, a stalled stream) are worth a fresh stream; every other
    status (UNIMPLEMENTED, INVALID_ARGUMENT, resolution failures) is a
    configuration or protocol error a retry cannot fix."""
    if grpc is None or not isinstance(exc, grpc.RpcError):
        return False
    code = exc.code() if callable(getattr(exc, "code", None)) else None
    return code in (grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED)


class GrpcEndpoint(BaseCommunicationManager):
    """What both gRPC backends share: the gated import, a server with one
    ``sendMessage`` rpc, a cached channel per peer, the inbox drained by
    ``handle_receive_message``, and the stop. A subclass names its
    backend, service and message cap, and gives the rpc's handler
    (:meth:`_rpc_handler`, which puts a received item on ``_inbox``) and
    the item's decoding (:meth:`_decode`)."""

    BACKEND = ""
    SERVICE = ""
    MAX_LEN = 0

    def __init__(self, rank: int, addresses: Dict[int, Tuple[str, int]]):
        if not HAS_GRPC:
            raise ImportError(f"the {self.BACKEND} backend needs grpcio, "
                              "which this environment does not have")
        super().__init__()
        self.rank = rank
        self.addresses = addresses
        self._inbox: "queue.Queue" = queue.Queue()
        self._channels: Dict[int, "grpc.Channel"] = {}
        self._lock = threading.Lock()
        self._running = False
        handler = grpc.method_handlers_generic_handler(
            self.SERVICE, {"sendMessage": self._rpc_handler()})
        from concurrent import futures
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8),
                                   options=self._options())
        self._server.add_generic_rpc_handlers((handler,))
        host, port = addresses[rank]
        self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    def _rpc_handler(self):
        raise NotImplementedError

    def _decode(self, item) -> Message:
        raise NotImplementedError

    def _options(self):
        return [("grpc.max_send_message_length", self.MAX_LEN),
                ("grpc.max_receive_message_length", self.MAX_LEN)]

    def _channel(self, dest: int) -> "grpc.Channel":
        with self._lock:
            ch = self._channels.get(dest)
            if ch is None:
                host, port = self.addresses[dest]
                ch = grpc.insecure_channel(f"{host}:{port}",
                                           options=self._options())
                self._channels[dest] = ch
            return ch

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            item = self._inbox.get()
            if item is _STOP:
                break
            self._notify(self._decode(item))

    def stop_receive_message(self) -> None:
        self._running = False
        self._inbox.put(_STOP)
        # a grace period, not an abort: the response to the last call this
        # endpoint took (the server's FINISH) must still reach its caller,
        # whose send otherwise fails with "Cancelling all calls" (the JAX
        # modules abort with grace=None). New calls are refused at once.
        self._server.stop(grace=STOP_GRACE_S).wait(2 * STOP_GRACE_S)
        with self._lock:
            for ch in self._channels.values():
                ch.close()
            self._channels.clear()


class GrpcCommManager(GrpcEndpoint):
    BACKEND = "GRPC"
    SERVICE = _SERVICE
    MAX_LEN = _MSG_LEN

    def __init__(self, rank: int, addresses: Dict[int, Tuple[str, int]],
                 retry: Optional[RetryPolicy] = None):
        self.retry = retry if retry is not None else RetryPolicy(seed=rank)
        super().__init__(rank, addresses)

    def _rpc_handler(self):
        def handle(request_iterator, context) -> bytes:
            # reassemble into ONE growing buffer (no chunk list + join)
            buf = bytearray()
            try:
                for chunk in request_iterator:
                    buf.extend(chunk)
            except grpc.RpcError:
                # torn client stream (sender died / retried): the partial
                # frame must never reach the inbox — the sender's retry
                # restarts from chunk 0 and delivers a whole frame
                self.bump("torn_streams")
                logging.warning("grpc rank %d: inbound stream torn after "
                                "%d bytes — dropping partial frame",
                                self.rank, len(buf))
                raise
            self._count_received(len(buf))
            self._inbox.put(buf)
            return b"ok"

        return grpc.stream_unary_rpc_method_handler(
            handle, request_deserializer=None, response_serializer=None)

    def _decode(self, item) -> Message:
        return Message.from_bytes(item)

    def send_message(self, msg: Message) -> None:
        # stamp BEFORE encoding: every stream attempt ships the identical
        # frame/seq, so a duplicate from a completed-but-unacked first
        # attempt is shed by the receiver's dedup
        self._stamp_seq(msg)
        parts = msg.to_parts()
        n = sum(len(p) for p in parts)
        # deadline scales with frame size (floor 8 MB/s): a fixed 60 s
        # would re-cap exactly the huge-model frames streaming unlocked
        timeout = 60 + n / (8 << 20)
        dest = msg.get_receiver_id()

        def attempt() -> None:
            # a FRESH chunk generator per attempt: the retried stream
            # restarts from chunk 0 (the server drops torn partials)
            self._channel(dest).stream_unary(_METHOD)(
                _iter_chunks(parts), timeout=timeout)

        host, port = self.addresses[dest]
        retry_call(
            attempt, self.retry,
            describe=f"grpc sendMessage to rank {dest} ({host}:{port})",
            is_transient=_is_transient_rpc,
            on_retry=lambda a, exc: self.bump("retries"))
        self._count_sent(n)
