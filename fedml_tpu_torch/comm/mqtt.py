"""MQTT backend: the reference's mobile/IoT transport, protocol-level (the
port's copy of ``fedml_tpu/comm/mqtt.py``).

Reference (fedml_core/distributed/communication/mqtt/mqtt_comm_manager.py:14-121):
broker pub/sub over paho with the topic scheme

    server: subscribes ``<topic><cid>`` for every client,
            publishes  ``<topic>0_<cid>`` to address client ``cid``
    client: subscribes ``<topic>0_<cid>``, publishes ``<topic><cid>``

and JSON message payloads (message.py:62).

paho-mqtt is not in this environment, so :class:`MiniMqttClient` speaks
MQTT 3.1.1 (OASIS spec) directly over TCP — CONNECT/CONNACK,
SUBSCRIBE/SUBACK, QoS-0 PUBLISH, PINGREQ/PINGRESP, DISCONNECT — which makes
:class:`MqttCommManager` interoperable with any standard broker (mosquitto,
EMQX, a cloud IoT endpoint) AND with reference peers on the same broker,
since both sides agree on topics + JSON. :class:`MiniMqttBroker` is an
in-process QoS-0 broker so tests need no external daemon.

Cross-silo payload caveat: JSON-encoded model lists are ~5× larger than the
binary frame the routed/gRPC backends move; MQTT is for the mobile/IoT
interop story, not the hot path.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, List, Tuple

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.grpc_proto import (message_from_json,
                                             message_to_json)
from fedml_tpu_torch.comm.message import Message

# -- MQTT 3.1.1 control packet types (spec §2.2.1) --------------------------
CONNECT, CONNACK = 0x10, 0x20
PUBLISH = 0x30
SUBSCRIBE, SUBACK = 0x82, 0x90
UNSUBSCRIBE, UNSUBACK = 0xA2, 0xB0
PINGREQ, PINGRESP = 0xC0, 0xD0
DISCONNECT = 0xE0


def _encode_remaining_length(n: int) -> bytes:
    """Spec §2.2.3 variable-length encoding (7 bits per byte, MSB=continue)."""
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | 0x80 if n else byte)
        if not n:
            return bytes(out)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes into one preallocated buffer (a JSON model
    payload is tens of MB: growing a bytes object per chunk would copy it
    once per chunk)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError("MQTT peer closed")
        got += r
    return bytes(buf)


def _read_packet(sock: socket.socket) -> Tuple[int, bytes]:
    """Returns (first header byte, body). Blocks; raises on EOF."""
    first = _read_exact(sock, 1)[0]
    length, mult = 0, 1
    for _ in range(4):
        byte = _read_exact(sock, 1)[0]
        length += (byte & 0x7F) * mult
        if not byte & 0x80:
            break
        mult *= 128
    else:
        raise ValueError("malformed remaining length")
    return first, _read_exact(sock, length) if length else b""


def _utf8(s: str) -> bytes:
    data = s.encode("utf-8")
    return struct.pack(">H", len(data)) + data


class MiniMqttClient:
    """Blocking-connect, threaded-receive MQTT 3.1.1 client (QoS 0)."""

    def __init__(self, host: str, port: int, client_id: str,
                 on_message: Callable[[str, bytes], None],
                 keepalive: int = 0, timeout: float = 10.0):
        self._on_message = on_message
        self._sock = socket.create_connection((host, port), timeout=timeout)
        # the reader is a dedicated blocking thread; close() tears the
        # socket down, and recv raising IS the shutdown signal
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._suback = threading.Event()
        self._packet_id = 0
        self._running = True

        # CONNECT: protocol "MQTT" level 4, clean session, client id payload
        var = _utf8("MQTT") + bytes([4, 0x02]) + struct.pack(">H", keepalive)
        body = var + _utf8(client_id)
        self._send(bytes([CONNECT]) + _encode_remaining_length(len(body))
                   + body)
        first, payload = _read_packet(self._sock)
        if first & 0xF0 != CONNACK or len(payload) < 2 or payload[1] != 0:
            raise ConnectionError(f"CONNACK refused: {payload!r}")

        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _send(self, frame: bytes) -> None:
        with self._wlock:
            self._sock.sendall(frame)

    def subscribe(self, topic: str, timeout: float = 10.0) -> None:
        self._packet_id += 1
        body = struct.pack(">H", self._packet_id) + _utf8(topic) + b"\x00"
        self._suback.clear()
        self._send(bytes([SUBSCRIBE]) + _encode_remaining_length(len(body))
                   + body)
        if not self._suback.wait(timeout):
            raise TimeoutError(f"no SUBACK for {topic!r}")

    def publish(self, topic: str, payload: bytes) -> None:
        body = _utf8(topic) + payload  # QoS 0: no packet id
        self._send(bytes([PUBLISH]) + _encode_remaining_length(len(body))
                   + body)

    def ping(self) -> None:
        self._send(bytes([PINGREQ, 0]))

    def _read_loop(self) -> None:
        try:
            while self._running:
                first, body = _read_packet(self._sock)
                ptype = first & 0xF0
                if ptype == PUBLISH:
                    tlen = struct.unpack(">H", body[:2])[0]
                    topic = body[2:2 + tlen].decode("utf-8")
                    pos = 2 + tlen
                    if (first >> 1) & 0x03:  # QoS>0: skip packet id
                        pos += 2
                    self._on_message(topic, body[pos:])
                elif ptype == SUBACK & 0xF0:
                    self._suback.set()
                # PINGRESP and others: ignore
        except (ConnectionError, OSError, ValueError):
            pass  # socket closed or torn down

    def close(self) -> None:
        self._running = False
        try:
            self._send(bytes([DISCONNECT, 0]))
        except OSError:
            pass  # a courtesy DISCONNECT to a broker already gone
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already torn down
        self._sock.close()


class MqttCommManager(BaseCommunicationManager):
    """Reference-compatible MQTT comm manager (topic scheme + JSON payloads).

    client_id 0 is the server (subscribes every client's uplink topic);
    any other id is a client (subscribes its own downlink topic).
    """

    def __init__(self, host: str, port: int, topic: str = "fedml",
                 client_id: int = 0, client_num: int = 0):
        super().__init__()
        self._topic = topic
        self.client_id = client_id
        self.client_num = client_num
        self._inbox: List = []
        self._cv = threading.Condition()
        self._running = False

        self._client = MiniMqttClient(
            host, port, client_id=f"{topic}-node-{client_id}",
            on_message=self._on_raw)
        if client_id == 0:
            for cid in range(1, client_num + 1):
                self._client.subscribe(self._topic + str(cid))
        else:
            self._client.subscribe(f"{self._topic}0_{client_id}")

    def _on_raw(self, topic: str, payload: bytes) -> None:
        with self._cv:
            self._inbox.append(payload.decode("utf-8"))
            self._cv.notify()

    def send_message(self, msg: Message) -> None:
        if self.client_id == 0:
            topic = f"{self._topic}0_{msg.get_receiver_id()}"
        else:
            topic = self._topic + str(self.client_id)
        self._client.publish(topic, message_to_json(msg).encode("utf-8"))

    def handle_receive_message(self) -> None:
        self._running = True
        while True:
            with self._cv:
                while self._running and not self._inbox:
                    self._cv.wait(timeout=0.5)
                if not self._running:
                    return
                payload = self._inbox.pop(0)
            self._notify(message_from_json(payload))

    def stop_receive_message(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._client.close()


class MiniMqttBroker:
    """In-process QoS-0 MQTT 3.1.1 broker (exact-match topics) for tests
    and single-box federations — the daemon role mosquitto plays for the
    reference."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(32)
        self.port = self._server.getsockname()[1]
        self._subs: Dict[str, List[socket.socket]] = {}
        self._lock = threading.Lock()
        self._running = True
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        try:
            first, body = _read_packet(conn)
            if first & 0xF0 != CONNECT:
                conn.close()
                return
            with wlock:
                conn.sendall(bytes([CONNACK, 2, 0, 0]))  # accepted
            while self._running:
                first, body = _read_packet(conn)
                ptype = first & 0xF0
                if ptype == SUBSCRIBE & 0xF0:
                    pid = body[:2]
                    pos, codes = 2, b""
                    while pos < len(body):
                        tlen = struct.unpack(">H", body[pos:pos + 2])[0]
                        topic = body[pos + 2:pos + 2 + tlen].decode("utf-8")
                        pos += 2 + tlen + 1  # + requested qos byte
                        with self._lock:
                            self._subs.setdefault(topic, []).append(conn)
                        codes += b"\x00"
                    ack = pid + codes
                    with wlock:
                        conn.sendall(bytes([SUBACK])
                                     + _encode_remaining_length(len(ack))
                                     + ack)
                elif ptype == PUBLISH:
                    tlen = struct.unpack(">H", body[:2])[0]
                    topic = body[2:2 + tlen].decode("utf-8")
                    frame = (bytes([PUBLISH])
                             + _encode_remaining_length(len(body)) + body)
                    # fan out under the broker lock so two publisher threads
                    # can't interleave bytes on one subscriber socket
                    with self._lock:
                        for t in self._subs.get(topic, ()):
                            try:
                                t.sendall(frame)
                            except OSError:
                                pass  # a dead subscriber detaches itself
                elif ptype == PINGREQ & 0xF0:
                    with wlock:
                        conn.sendall(bytes([PINGRESP, 0]))
                elif ptype == DISCONNECT & 0xF0:
                    break
        except (ConnectionError, OSError, ValueError):
            pass  # a torn client connection ends its loop
        finally:
            with self._lock:
                for subs in self._subs.values():
                    if conn in subs:
                        subs.remove(conn)
            conn.close()

    def stop(self) -> None:
        self._running = False
        # shut the listener down before closing it, so the accept loop
        # blocked in accept() wakes (a close alone does not wake it)
        try:
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never listened / already closed
        self._server.close()
        self._accept_thread.join(timeout=5)
