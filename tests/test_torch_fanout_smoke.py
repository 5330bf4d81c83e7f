"""The port's fan-out smoke (``fedml_tpu_torch/comm/fanout_smoke.py``):
both stages pass on the CPU, and a ``_RawPeer`` closed before any
connection releases its blocked ``accept()`` and its port (the port's
divergence from the JAX module, whose close leaves the serve thread in
``accept()``)."""

import socket

from fedml_tpu_torch.comm import fanout_smoke as fs
from fedml_tpu_torch.control.failover_harness import free_port_base

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_both_stages_pass(capsys):
    base = free_port_base(53)  # stage 1: base..+4; stage 2: +32..+52
    fs.main(["--port_base", str(base), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "stage 1 OK" in out and "one encode" in out
    assert "stage 2 OK: 3/3 rounds, ledger parity" in out
    assert out.strip().endswith("FANOUT SMOKE PASS")


def test_raw_peer_close_without_connection():
    port = _free_port()
    peer = fs._RawPeer(port)
    peer.close()
    peer.close()  # idempotent
    assert not peer._thread.is_alive()
    rebound = socket.create_server(("127.0.0.1", port))
    rebound.close()
    assert peer.frames == [] and peer.done_t is None
