"""The port's transports against the JAX package's wire, and their own
invariants.

- The reference-wire codecs (``grpc_proto``: the hand-encoded proto3
  ``CommRequest`` and the JSON message codec) give the JAX module's bytes
  for the same message, and a JAX and a port ``MqttCommManager`` exchange
  messages through one ``MiniMqttBroker`` in both directions.
- A federation over each transport (TCP, GRPC, GRPC_PROTO, MQTT, ROUTED)
  ends on the in-process router's model bit for bit: the frames carry the
  same arrays and the fold's order is ascending worker index whatever the
  arrival order. The JSON transports carry ``none`` (the JSON wire has no
  int8 arrays).
- Reliable delivery: a TCP frame written twice by a retry is delivered
  once (``dedup_drops``), a restarted endpoint's new epoch is not taken
  for duplicates, and stopping an endpoint wakes its accept loop at once.
  An overlapped ``broadcast(on_error=)`` delivers to the live peers and
  reports a dead or wedged one to ``on_error``.
- The routed broker refuses a wrong token, and a missing g++ raises.

Socket tests take free loopback ports from the OS and retry a launch whose
bind lost a race (at most 3 tries); every endpoint is stopped in a
``finally`` and every wait has a short timeout. The JAX side is imported
inside the tests that use it, so the gpu test collects without it.
"""

import errno
import re
import socket
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fedml_tpu_torch import native
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.comm import base as tbase
from fedml_tpu_torch.comm import create_comm_manager
from fedml_tpu_torch.comm import grpc_backend, grpc_proto, tcp
from fedml_tpu_torch.comm.base import Observer
from fedml_tpu_torch.comm.inproc import InProcCommManager, InProcRouter
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.mqtt import MiniMqttBroker, MqttCommManager
from fedml_tpu_torch.comm.routed import RoutedCommManager
from fedml_tpu_torch.comm.serialization import SharedPayload
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
BLOB = dict(client_num=6, dim=32, class_num=4, seed=7)
TRAIN = dict(epochs=1, batch_size=16, lr=0.1)
SILOS, ROUNDS = 3, 2
WAIT_S = 10.0


def free_ports(n):
    """``n`` loopback ports the OS reports free (they may be taken again
    before they are bound: launches retry, see :func:`with_ports`)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _lost_bind_race(exc) -> bool:
    if isinstance(exc, OSError):
        return exc.errno == errno.EADDRINUSE
    return isinstance(exc, RuntimeError) and "Failed to bind" in str(exc)


def with_ports(n, fn):
    """``fn({rank: (host, port)})`` on fresh free ports; relaunched (at
    most 3 tries) only when a bind lost the port to another process."""
    for attempt in range(3):
        addresses = {r: ("127.0.0.1", p)
                     for r, p in enumerate(free_ports(n))}
        try:
            return fn(addresses)
        except (OSError, RuntimeError) as exc:
            if not _lost_bind_race(exc) or attempt == 2:
                raise


class Inbox(Observer):
    def __init__(self):
        self.msgs = []
        self.cv = threading.Condition()

    def receive_message(self, msg_type, msg):
        with self.cv:
            self.msgs.append(msg)
            self.cv.notify_all()

    def wait_for(self, n, timeout=WAIT_S):
        with self.cv:
            assert self.cv.wait_for(lambda: len(self.msgs) >= n, timeout), \
                f"{len(self.msgs)} of {n} messages within {timeout} s"
        return self.msgs


def _serve(com):
    t = threading.Thread(target=com.handle_receive_message, daemon=True)
    t.start()
    return t


def _stop(coms, threads=()):
    for com in coms:
        com.stop_receive_message()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()


# -- the reference wire: byte parity with the JAX package --------------------

@pytest.mark.parametrize("client_id", [0, 1, 7, 300, -1, 2**31 - 1])
@pytest.mark.parametrize("text", ["", "x", "héllo wörld", "{}" * 200])
def test_comm_message_bytes_equal_jax(client_id, text):
    from fedml_tpu.comm import grpc_proto as jproto
    want = jproto.encode_comm_message(client_id, text)
    got = grpc_proto.encode_comm_message(client_id, text)
    assert got == want
    assert grpc_proto.decode_comm_message(want) == (client_id, text)
    assert jproto.decode_comm_message(got) == (client_id, text)


def _message(msg_cls, seed, shared=False):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32),
              "steps": np.arange(3, dtype=np.int64)}
    msg = msg_cls(2, 0, 3)
    msg.add(Message.MSG_ARG_KEY_MODEL_PARAMS,
            SharedPayload(params) if shared else params)
    msg.add(Message.MSG_ARG_KEY_NUM_SAMPLES, float(rng.randint(1, 99)))
    msg.add(Message.MSG_ARG_KEY_CLIENT_INDEX, int(rng.randint(0, 9)))
    msg.add("round_idx", 4)
    msg.add("base_fp", "a1b2c3")
    msg.add("nested", {"xs": [1, 2.5, None, True], "s": "t"})
    return msg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_message_json_equals_jax(seed):
    """The JSON codec's text is the JAX module's for the same message; a
    broadcast's shared payload encodes as its tree (the JAX module has no
    wrapper on this wire); both decoders restore the same arrays."""
    from fedml_tpu.comm import grpc_proto as jproto
    from fedml_tpu.comm.message import Message as JaxMessage
    want = jproto.message_to_json(_message(JaxMessage, seed))
    assert grpc_proto.message_to_json(_message(Message, seed)) == want
    assert grpc_proto.message_to_json(
        _message(Message, seed, shared=True)) == want
    got = grpc_proto.message_from_json(want).get_params()
    ref = jproto.message_from_json(want).get_params()
    assert list(got) == list(ref)
    for k in got:
        if k == Message.MSG_ARG_KEY_MODEL_PARAMS:
            for name in ref[k]:
                assert got[k][name].dtype == ref[k][name].dtype
                np.testing.assert_array_equal(got[k][name], ref[k][name])
        else:
            assert got[k] == ref[k]


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_mqtt_peers_of_both_packages_exchange_messages(server_side):
    """A server and a client of different packages on one broker: the
    model payload goes down and a reply comes up, arrays intact."""
    from fedml_tpu.comm.message import Message as JaxMessage
    from fedml_tpu.comm.mqtt import MqttCommManager as JaxMqtt
    broker = MiniMqttBroker()
    server_cls, client_cls = ((JaxMqtt, MqttCommManager)
                              if server_side == "jax"
                              else (MqttCommManager, JaxMqtt))
    server_msg_cls = JaxMessage if server_side == "jax" else Message
    client_msg_cls = Message if server_side == "jax" else JaxMessage
    coms, threads = [], []
    try:
        server = server_cls("127.0.0.1", broker.port, client_id=0,
                            client_num=1)
        coms.append(server)
        client = client_cls("127.0.0.1", broker.port, client_id=1)
        coms.append(client)
        down, up = Inbox(), Inbox()
        client.add_observer(down)
        server.add_observer(up)
        threads = [_serve(server), _serve(client)]
        sent = _message(server_msg_cls, 3)
        sent.msg_params[Message.MSG_ARG_KEY_RECEIVER] = 1
        server.send_message(sent)
        got = down.wait_for(1)[0]
        for k, v in sent.get(Message.MSG_ARG_KEY_MODEL_PARAMS).items():
            np.testing.assert_array_equal(
                got.get(Message.MSG_ARG_KEY_MODEL_PARAMS)[k], v)
        assert got.get("nested") == sent.get("nested")
        reply = client_msg_cls(4, 1, 0)
        reply.add(Message.MSG_ARG_KEY_MODEL_PARAMS,
                  {"w": np.full((2, 2), 0.5, np.float32)})
        client.send_message(reply)
        back = up.wait_for(1)[0]
        assert back.get_sender_id() == 1 and back.get_type() == 4
        np.testing.assert_array_equal(
            back.get(Message.MSG_ARG_KEY_MODEL_PARAMS)["w"],
            np.full((2, 2), 0.5, np.float32))
    finally:
        _stop(coms, threads)
        broker.stop()


# -- federations over every transport equal the in-process router's --------

def _lr(ds):
    return create_model("lr", ds.class_num,
                        input_shape=ds.train_data_global[0].shape[1:])


def _federation(policy, **kw):
    ds = make_blob_federated(**BLOB)
    return cs.run_fedavg_cross_silo(
        ds, _lr(ds), worker_num=SILOS, comm_round=ROUNDS,
        train_cfg=TrainConfig(**TRAIN), compression=policy, device="cpu",
        join_timeout_s=60, **kw)


def _same_bits(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k


@pytest.mark.parametrize("backend, policy", [
    ("TCP", "delta_int8"), ("TCP", "topk_ef_int8:0.1"),
    ("GRPC", "topk_ef_int8:0.1"), ("GRPC_PROTO", "none"), ("MQTT", "none"),
    ("ROUTED", "topk_ef_int8:0.1"), ("ROUTED", "delta_int8")])
def test_federation_over_the_transport_equals_inproc(backend, policy):
    want, want_hist = _federation(policy)
    if backend == "MQTT":
        broker = MiniMqttBroker()
        try:
            got, hist = _federation(
                policy, backend=backend,
                addresses={"broker": ("127.0.0.1", broker.port)})
        finally:
            broker.stop()
    elif backend == "ROUTED":
        with native.NativeRouter(token=b"s3cret") as router:
            got, hist = _federation(
                policy, backend=backend, token=b"s3cret",
                addresses={"router": ("127.0.0.1", router.port)})
            # every frame of the run crossed the broker
            assert router.frames_routed >= ROUNDS * 2 * SILOS
    else:
        got, hist = with_ports(SILOS + 1, lambda addresses: _federation(
            policy, backend=backend, addresses=addresses))
    _same_bits(got, want)
    assert hist == want_hist


def test_socket_wire_bytes_are_the_frames():
    """TCP carries the in-process router's frames: both stamp each frame
    with its seq (a header entry of the key and a 32-bit epoch and seq, as
    the JAX package's in-process router does), so the two differ only by
    the digits of the endpoints' random epochs; the length prefixes are
    framing, not counted."""
    sizes = {}
    for backend in ("INPROC", "TCP"):
        from fedml_tpu_torch.utils.tracing import RoundTimer
        timer = RoundTimer()
        if backend == "TCP":
            with_ports(SILOS + 1, lambda a: _federation(
                "delta_int8", backend="TCP", addresses=a, timer=timer))
        else:
            _federation("delta_int8", timer=timer)
        sizes[backend] = (timer.comm_bytes_up, timer.comm_bytes_down)
    # up: the replies; down: the broadcasts and the FINISH frames
    for frames, tcp_b, inproc_b in zip(
            (ROUNDS * SILOS, (ROUNDS + 1) * SILOS), sizes["TCP"],
            sizes["INPROC"]):
        assert abs(tcp_b - inproc_b) <= 12 * frames


# -- reliable delivery -------------------------------------------------------

def test_a_retried_tcp_frame_is_delivered_once(monkeypatch):
    """The first write lands, then fails as a torn connection would: the
    sender reconnects and resends the same stamped frame, and the
    receiver drops the copy."""
    real = tcp.send_frame
    calls = {"n": 0}

    def flaky(sock, frame):
        n = real(sock, frame)
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionResetError("torn after the write")
        return n
    monkeypatch.setattr(tcp, "send_frame", flaky)

    def run(addresses):
        coms, threads = [], []
        try:
            sender = tcp.TcpCommManager(0, addresses)
            coms.append(sender)
            receiver = tcp.TcpCommManager(1, addresses)
            coms.append(receiver)
            inbox = Inbox()
            receiver.add_observer(inbox)
            threads.append(_serve(receiver))
            for i in range(2):
                msg = Message(5, 0, 1)
                msg.add("i", i)
                sender.send_message(msg)
            got = inbox.wait_for(2)
            deadline = time.monotonic() + WAIT_S
            while (receiver.counters["dedup_drops"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert [m.get("i") for m in got] == [0, 1]
            assert receiver.counters["dedup_drops"] == 1
            assert sender.counters["retries"] == 1
            assert sender.bytes_sent > 0
        finally:
            _stop(coms, threads)
    with_ports(2, run)


def test_a_restarted_endpoint_is_not_taken_for_duplicates():
    """Dedup is per (sender, epoch): a copy of a delivered seq drops, a new
    epoch (a restarted sender) starts its window over, and a late frame of
    the superseded epoch stays dropped."""
    com = InProcCommManager(InProcRouter(), 0, 2)
    inbox = Inbox()
    com.add_observer(inbox)

    def frame(epoch, seq):
        msg = Message(1, 1, 0)
        msg.add(tbase.WIRE_SEQ_KEY, [epoch, seq])
        return msg
    for epoch, seq in ((7, 1), (7, 2), (7, 2), (9, 1), (7, 3), (9, 2)):
        com._notify(frame(epoch, seq))
    assert [m.get(tbase.WIRE_SEQ_KEY) for m in inbox.msgs] == [
        [7, 1], [7, 2], [9, 1], [9, 2]]
    assert com.counters["dedup_drops"] == 2
    # stamping is idempotent and per stream
    sender = InProcCommManager(InProcRouter(), 1, 3)
    a, b = Message(1, 1, 0), Message(1, 1, 2)
    for msg in (a, a, b):
        sender._stamp_seq(msg)
    assert a.get(tbase.WIRE_SEQ_KEY)[1] == 1
    assert b.get(tbase.WIRE_SEQ_KEY)[1] == 1
    assert a.get(tbase.WIRE_SEQ_KEY)[0] == sender._seq_epoch


def test_stopping_a_tcp_endpoint_wakes_its_accept_loop():
    """The listener is shut down before it is closed, so the accept loop
    ends at once (not at its next 0.5 s poll) and the port is free."""
    def run(addresses):
        com = tcp.TcpCommManager(0, addresses)
        t = _serve(com)
        deadline = time.monotonic() + WAIT_S
        while com._accept_thread is None and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        t0 = time.monotonic()
        _stop([com], [t])
        com._accept_thread.join(timeout=WAIT_S)
        assert not com._accept_thread.is_alive()
        assert time.monotonic() - t0 < 0.4
        socket.create_server(addresses[0]).close()  # the port is free
    with_ports(1, run)


def test_a_sender_to_a_dead_peer_raises_after_its_retries():
    from fedml_tpu_torch.comm.reliable import RetryPolicy, TransportError

    # rank 1's port is held bound but never listens: every connect is
    # refused, and no other test can take the port meanwhile
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))

    def run(addresses):
        addresses[1] = dead.getsockname()
        com = tcp.TcpCommManager(0, addresses,
                                 retry=RetryPolicy(max_attempts=2,
                                                   base_delay_s=0.01))
        try:
            with pytest.raises(TransportError, match="after 2 attempts"):
                com.send_message(Message(1, 0, 1))
            assert com.counters["retries"] == 1
        finally:
            com.stop_receive_message()
    try:
        with_ports(1, run)
    finally:
        dead.close()


def test_an_overlapped_broadcast_reports_a_dead_peer_and_delivers_the_rest():
    """``broadcast(on_error=)`` returns after enqueue: the live peer gets
    its frame, and the dead one's exhausted retries reach ``on_error`` on
    its writer thread as a ``TransportError``."""
    from fedml_tpu_torch.comm.reliable import RetryPolicy, TransportError

    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    errors, failed = [], threading.Event()

    def on_error(receiver, exc):
        errors.append((receiver, exc))
        failed.set()

    def run(addresses):
        addresses[2] = dead.getsockname()
        coms, threads = [], []
        try:
            sender = tcp.TcpCommManager(0, addresses,
                                        retry=RetryPolicy(max_attempts=2,
                                                          base_delay_s=0.01))
            coms.append(sender)
            live = tcp.TcpCommManager(1, addresses)
            coms.append(live)
            inbox = Inbox()
            live.add_observer(inbox)
            threads.append(_serve(live))
            out = sender.broadcast([Message(4, 0, 1), Message(4, 0, 2)],
                                   on_error=on_error)
            assert out["enqueued"] == 2
            assert [m.get_type() for m in inbox.wait_for(1)] == [4]
            assert failed.wait(WAIT_S)
            [(receiver, exc)] = errors
            assert receiver == 2
            assert isinstance(exc, TransportError)
            assert "after 2 attempts" in str(exc)
            assert sender.counters["retries"] == 1
        finally:
            _stop(coms, threads)
    try:
        with_ports(2, run)
    finally:
        dead.close()


def test_a_full_send_queue_sheds_to_on_error():
    """A peer that does not drain: once its queue is full, the next frame
    fails at once as a transient ``TransportError`` and is counted."""
    from fedml_tpu_torch.comm.reliable import RetryPolicy, TransportError

    errors, counts = [], {}

    def run(addresses):
        sink = socket.create_server(addresses[1])
        peer = tcp._Peer(addresses[1], RetryPolicy(max_attempts=1),
                         bump=lambda name, n=1, job=None: counts.update(
                             {name: counts.get(name, 0) + n}),
                         on_sent=lambda n, job=None: None, queue_depth=1)
        try:
            with peer.lock:  # the writer takes frame 0 and blocks on it
                shed = lambda r, e: errors.append(e)  # noqa: E731
                peer.enqueue_nowait(b"0", shed, 1)
                deadline = time.monotonic() + WAIT_S
                while peer._queue.qsize() and time.monotonic() < deadline:
                    time.sleep(0.01)
                peer.enqueue_nowait(b"1", shed, 1)
                peer.enqueue_nowait(b"2", shed, 1)
                [exc] = errors
                assert isinstance(exc, TransportError) and exc.transient
                assert "overflowed" in str(exc)
                assert counts == {"send_queue_overflows": 1}
        finally:
            peer.close()
            sink.close()
    with_ports(2, run)


# -- the routed broker -------------------------------------------------------

def test_a_wrong_routed_token_is_refused():
    with native.NativeRouter(token=b"right") as router:
        addr = ("127.0.0.1", router.port)
        for token in (b"wrong", None):
            with pytest.raises(ConnectionError, match="token mismatch"):
                RoutedCommManager(1, addr, connect_timeout=WAIT_S,
                                  token=token)
        good = RoutedCommManager(1, addr, token=b"right")
        try:
            assert router.connected_ranks == 1
        finally:
            good.stop_receive_message()
        # a whole federation with the wrong token raises, and releases
        # every endpoint it made
        with pytest.raises(ConnectionError, match="token mismatch"):
            _federation("none", backend="ROUTED", token=b"wrong",
                        addresses={"router": addr})
        deadline = time.monotonic() + WAIT_S
        while router.connected_ranks and time.monotonic() < deadline:
            time.sleep(0.01)
        assert router.connected_ranks == 0


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(native.NativeUnavailable, match="could not build"):
        native.build_lib(lib=tmp_path / "router.so", force=True)
    assert not list(tmp_path.iterdir())  # no half-written library left


def test_a_compile_error_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( {\n")
    with pytest.raises(native.NativeUnavailable, match="failed to build"):
        native.build_lib(src=bad, lib=tmp_path / "bad.so")


_STOP_FIX = """\
      if (!running_.load()) {
        ::shutdown(fd, SHUT_RDWR);
      }
"""


#: the headers the port's copy adds (GCC 13 needs <string> spelled out)
_HEADERS = ["#include <new>", "#include <string>", "#include <utility>"]


def test_the_broker_builds_from_the_ports_own_copy():
    """The builder reads fedml_tpu_torch/native/router.cpp only, and that
    file is the JAX package's broker plus two fixes: its code lines
    (comments aside) are native/router.cpp's with three headers and the
    stop race's three lines added."""
    assert native.SRC == ROOT / "fedml_tpu_torch" / "native" / "router.cpp"
    assert native.LIB.parent == ROOT / "fedml_tpu_torch" / "_build"

    def code(path):
        return [line for line in path.read_text().splitlines()
                if not line.lstrip().startswith("//")]
    ours, theirs = code(native.SRC), code(ROOT / "native" / "router.cpp")
    fix = _STOP_FIX.splitlines()
    at = next(i for i in range(len(ours)) if ours[i:i + 3] == fix)
    ours = ours[:at] + ours[at + 3:]
    assert all(h in ours and h not in theirs for h in _HEADERS)
    assert [line for line in ours if line not in _HEADERS] == theirs


def test_stopping_the_broker_never_waits_on_a_late_registration():
    """A client whose HELLO registers while the broker stops: stop()
    returns. The JAX package's broker waits on that reader until the
    client closes (here it did so within 300 tries)."""
    for _ in range(200):
        router = native.NativeRouter()
        sock = socket.create_connection(("127.0.0.1", router.port),
                                        timeout=WAIT_S)
        try:
            sock.sendall(struct.pack("<II", 0x464D4C52, 1))
            stopper = threading.Thread(target=router.stop, daemon=True)
            stopper.start()
            stopper.join(timeout=WAIT_S)
            assert not stopper.is_alive(), "the broker's stop() hung"
        finally:
            sock.close()


# -- the registry ------------------------------------------------------------

@pytest.mark.parametrize("backend, cls", [
    ("TCP", tcp.TcpCommManager), ("GRPC", grpc_backend.GrpcCommManager),
    ("GRPC_PROTO", grpc_proto.ProtoGrpcCommManager)])
def test_the_registry_builds_the_socket_backends(backend, cls):
    def run(addresses):
        com = create_comm_manager(backend, 0, 2, addresses=addresses)
        try:
            assert isinstance(com, cls)
        finally:
            com.stop_receive_message()
    with_ports(2, run)
    with pytest.raises(ValueError, match="needs"):
        create_comm_manager(backend, 0, 2)


def test_the_registry_builds_mqtt_and_routed():
    broker = MiniMqttBroker()
    try:
        com = create_comm_manager(
            "MQTT", 0, 3, addresses={"broker": ("127.0.0.1", broker.port)})
        assert isinstance(com, MqttCommManager) and com.client_num == 2
        com.stop_receive_message()
    finally:
        broker.stop()
    with native.NativeRouter() as router:
        for name in ("ROUTED", "BROKER"):
            com = create_comm_manager(
                name, 1, 2, addresses={"router": ("127.0.0.1",
                                                  router.port)})
            assert isinstance(com, RoutedCommManager)
            com.stop_receive_message()
    for name in ("MQTT", "ROUTED"):
        with pytest.raises(ValueError, match="needs"):
            create_comm_manager(name, 0, 2, addresses={})


def test_the_registry_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="unknown fault-rule key"):
        create_comm_manager("INPROC", 0, 2, router=InProcRouter(),
                            fault_plan="drop:0.1")
    with pytest.raises(NotImplementedError, match="wire_codec"):
        create_comm_manager("INPROC", 0, 2, router=InProcRouter(),
                            wire_codec=False)
    with pytest.raises(ValueError, match="unknown backend"):
        create_comm_manager("PIGEON", 0, 2)


@pytest.mark.parametrize("module, cls", [
    (grpc_backend, "GrpcCommManager"), (grpc_proto, "ProtoGrpcCommManager")])
def test_grpc_without_grpcio_raises(monkeypatch, module, cls):
    # both backends start from grpc_backend's gated import
    monkeypatch.setattr(grpc_backend, "HAS_GRPC", False)
    with pytest.raises(ImportError, match="grpcio"):
        getattr(module, cls)(0, {0: ("127.0.0.1", 1)})


def test_no_transport_module_imports_the_jax_package():
    pattern = re.compile(r"^\s*(?:from|import)\s+\S*\bfedml_tpu(?!_torch)\b",
                         re.MULTILINE)
    files = sorted((ROOT / "fedml_tpu_torch" / "comm").glob("*.py")) + [
        ROOT / "fedml_tpu_torch" / "native" / "__init__.py"]
    assert not [str(f) for f in files if pattern.search(f.read_text())]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the int8 kernels run only on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_tcp_federation_on_the_card_equals_inproc(cuda_device):
    """On the card the int8 kernels encode every frame: TCP and the
    in-process router launch them equally often and end on the same
    bits."""
    from fedml_tpu_torch.ops import quantize as tq
    ds = make_blob_federated(**BLOB)
    runs = {}
    for backend in ("INPROC", "TCP"):
        before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)

        def go(addresses=None):
            return cs.run_fedavg_cross_silo(
                ds, _lr(ds), worker_num=SILOS, comm_round=ROUNDS,
                train_cfg=TrainConfig(**TRAIN), compression="delta_int8",
                device="cuda", join_timeout_s=60, backend=backend,
                addresses=addresses)[0]
        model = with_ports(SILOS + 1, go) if backend == "TCP" else go()
        runs[backend] = (model, (tq.quantize_int8.launches - before[0],
                                 tq.dequantize_int8.launches - before[1]))
    _same_bits(runs["TCP"][0], runs["INPROC"][0])
    assert runs["TCP"][1] == runs["INPROC"][1]
    assert runs["TCP"][1][0] == ROUNDS * SILOS + ROUNDS - 1
