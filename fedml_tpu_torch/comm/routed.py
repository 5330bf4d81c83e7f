"""Broker-routed backend: silos dial out to the native C++ router (the
port's copy of ``fedml_tpu/comm/routed.py``).

Complements the peer-to-peer TCP backend (tcp.py) for deployments where
silos cannot accept inbound connections (NAT/firewalled cross-silo — the
scenario the reference serves with an MQTT broker,
fedml_core/distributed/communication/mqtt/mqtt_comm_manager.py): every rank
keeps one outbound connection to the router (fedml_tpu_torch/native/
router.cpp, built by fedml_tpu_torch/native/) and frames
are addressed by rank. Same Message/Observer contract as every other
backend, so managers and algorithm protocols are transport-agnostic.

Wire protocol (little-endian), mirroring the router:
  HELLO:           u32 magic 'FMLR'  u32 rank
  HELLO+AUTH:      u32 magic 'FMLS'  u32 rank  u32 token_len  token
  DATA (send):     u32 dest_rank     u64 len   payload
  DATA (receive):  u32 src_rank      u64 len   payload

A shared-secret ``token`` authenticates the rank claim against a router
started with the same token; without it any reachable host could register as
any rank. Unlike the JAX module, the port credits the frames' payload bytes to
``bytes_sent`` / ``bytes_received`` as the other binary transports do.
Payloads are still cleartext — run the broker behind TLS
termination or on a trusted network (see router.cpp).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Optional, Tuple

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.tcp import _recv_exact

_MAGIC = 0x464D4C52  # 'FMLR'
_MAGIC_AUTH = 0x464D4C53  # 'FMLS'
_HELLO = struct.Struct("<II")
_HELLO_AUTH = struct.Struct("<III")
_HDR = struct.Struct("<IQ")
_STOP = object()


class RoutedCommManager(BaseCommunicationManager):
    """One rank's connection to the message router."""

    def __init__(self, rank: int, router_address: Tuple[str, int],
                 connect_timeout: float = 30.0,
                 token: Optional[bytes] = None):
        super().__init__()
        self.rank = rank
        self._sock = socket.create_connection(router_address,
                                              timeout=connect_timeout)
        # the reader is a dedicated blocking thread; stop tears the socket
        # down and the resulting error is routed to the inbox
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if token:
            self._sock.sendall(
                _HELLO_AUTH.pack(_MAGIC_AUTH, rank, len(token)) + token)
        else:
            self._sock.sendall(_HELLO.pack(_MAGIC, rank))
        # Registration handshake: the router sends nothing on success, so a
        # rejected HELLO (token mismatch, duplicate rank) would otherwise
        # only surface later as a generic "connection lost" mid-round. A
        # self-addressed empty frame echoes back iff we were registered.
        try:
            self._sock.sendall(_HDR.pack(rank, 0))
            src, length = _HDR.unpack(_recv_exact(self._sock, _HDR.size))
            if src != rank or length != 0:
                raise ConnectionError(
                    f"rank {rank}: unexpected first frame from router "
                    f"(src={src}, len={length})")
        except (ConnectionError, OSError) as exc:
            self._sock.close()
            raise ConnectionError(
                f"rank {rank}: router at {router_address} closed the "
                "connection during registration — auth token mismatch "
                "(client and router must both set the same token, or "
                "neither) or this rank is already connected") from exc
        self._send_lock = threading.Lock()
        self._inbox: "queue.Queue" = queue.Queue()
        self._running = False
        self._reader: Optional[threading.Thread] = None

    def send_message(self, msg: Message) -> None:
        # parts, not one joined frame: a broadcast's shared payload rides
        # as cached buffer views and a multi-hundred-MB model update never
        # materializes as a contiguous copy on the send path
        parts = msg.to_parts()
        total = sum(len(p) for p in parts)
        with self._send_lock:
            self._sock.sendall(_HDR.pack(msg.get_receiver_id(), total))
            for part in parts:
                self._sock.sendall(part)
        self._count_sent(total)

    def _read_loop(self) -> None:
        try:
            while self._running:
                hdr = _recv_exact(self._sock, _HDR.size)
                _src, length = _HDR.unpack(hdr)
                self._inbox.put(_recv_exact(self._sock, length))
                self._count_received(length)
        except (ConnectionError, OSError) as exc:
            if self._running:
                # broker died mid-protocol: this must surface as an error,
                # not look like a clean stop (the manager would otherwise
                # "finish" with a partial round and no exception)
                self._inbox.put(ConnectionError(
                    f"rank {self.rank}: router connection lost: {exc}"))
            else:
                self._inbox.put(_STOP)

    def handle_receive_message(self) -> None:
        self._running = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        while self._running:
            item = self._inbox.get()
            if item is _STOP:
                break
            if isinstance(item, ConnectionError):
                raise item
            msg = Message.from_bytes(item)
            self._notify(msg)

    def stop_receive_message(self) -> None:
        self._running = False
        self._inbox.put(_STOP)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # the router already closed the connection
        self._sock.close()
