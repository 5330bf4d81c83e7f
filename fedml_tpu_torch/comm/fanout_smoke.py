"""The fan-out smoke: the round's hot path against a slow peer (the port's
copy of ``fedml_tpu/comm/fanout_smoke.py``).

Two stages over real TCP sockets on localhost; the process exits non-zero
on any broken contract:

1. **Transport backpressure**: a 4-peer broadcast of one multi-MB shared
   payload where one peer accepts its connection but reads nothing for
   ``STALL_S`` seconds (the kernel's socket buffers fill; a sequential
   fan-out would sit in ``sendall`` for the whole stall). Required: the
   ``broadcast()`` call returns in a fraction of the stall, every fast
   peer holds its whole frame while the slow one still stalls, the slow
   peer's frame drains only after the stall, the payload was encoded
   once, and all four frames decode to the same payload.

2. **Federation ledger parity**: a 4-silo deadline federation (so the
   server takes the overlapped fan-out) where the fault injector
   (``comm/faults.py``) delays every model broadcast to one silo by
   ``DELAY_MS``. Required: the whole schedule completes (the slow silo is
   never evicted), the server's round-open fan-out gauge stays far under
   the delay, each round's reported set is the fault-free reference run's,
   the reference run rode the send queues (``send_queue_depth >= 1``) and
   the final model is bit for bit the reference's (the sorted-index fold
   makes arrival order irrelevant).

Two divergences from the JAX module: :meth:`_RawPeer.close` shuts the
listener down (``shutdown(SHUT_RDWR)``) before it closes it, which wakes
a serve thread blocked in ``accept()`` (the JAX module's close leaves it
blocked); and stage 2 reads each round's reported set from the control
plane's ledger (``server_checkpoint_dir``), where the JAX module reads it
from the history records, which carry none.

Run: ``python -m fedml_tpu_torch.comm.fanout_smoke [--port_base N]
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import socket
import sys
import tempfile
import threading
import time

import numpy as np

_HOST = "127.0.0.1"
STALL_S = 2.0        # stage 1: how long the slow peer refuses to read
PAYLOAD_MB = 8       # stage 1: big enough to overflow loopback buffers
DELAY_MS = 1200.0    # stage 2: the fault plan's receive delay at one silo


def _fail(msg: str) -> None:
    print(f"FANOUT SMOKE FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# -- stage 1: transport backpressure ----------------------------------------
class _RawPeer:
    """A minimal frame sink: accepts one connection and records when its
    first frame finished arriving. ``stall_s`` delays the first read: with
    the socket unread, the sender's TCP window closes and a blocking
    fan-out would wedge on this peer."""

    def __init__(self, port: int, stall_s: float = 0.0):
        self.stall_s = stall_s
        self.frames = []
        self.done_t: float | None = None
        self._server = socket.create_server((_HOST, port))
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        from fedml_tpu_torch.comm.tcp import recv_frame
        try:
            conn, _ = self._server.accept()
        except OSError:
            return  # close() shut the listener down before any connect
        try:
            if self.stall_s:
                time.sleep(self.stall_s)
            frame = recv_frame(conn)
            if frame is not None:  # None: the sender closed, no frame
                self.frames.append(frame)
                self.done_t = time.monotonic()
        except OSError:
            pass  # a torn socket leaves done_t unset: the stage fails on it
        finally:
            conn.close()
            self._server.close()

    def close(self) -> None:
        """Idempotent: shut the listener down, which wakes a serve thread
        still blocked in ``accept()``, then close it, so the next stage can
        bind the port at once."""
        try:
            self._server.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # not listening any more: nothing to wake
        self._server.close()
        self._thread.join(timeout=1.0)


def stage_transport(port_base: int) -> None:
    from fedml_tpu_torch.comm.tcp import TcpCommManager

    n_peers = 4
    slow_rank = n_peers  # the last peer stalls
    addresses = {r: (_HOST, port_base + r) for r in range(n_peers + 1)}
    peers = {r: _RawPeer(port_base + r,
                         stall_s=STALL_S if r == slow_rank else 0.0)
             for r in range(1, n_peers + 1)}
    try:
        com = TcpCommManager(0, addresses)
        try:
            _stage_transport_run(com, peers, n_peers, slow_rank)
        finally:
            # a failure mid-stage must not keep the listener bound: stage
            # 2 binds the next ports in this process
            com.stop_receive_message()
    finally:
        for peer in peers.values():
            peer.close()


def _stage_transport_run(com, peers, n_peers: int, slow_rank: int) -> None:
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        MSG_ARG_KEY_ROUND)
    from fedml_tpu_torch.comm.message import Message
    from fedml_tpu_torch.comm.serialization import SharedPayload

    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal(
        (PAYLOAD_MB * (1 << 20) // 4,)).astype(np.float32)}
    shared = SharedPayload(tree)
    msgs = []
    for r in range(1, n_peers + 1):
        msg = Message(2, 0, r)
        msg.add(Message.MSG_ARG_KEY_MODEL_PARAMS, shared)
        msg.add(MSG_ARG_KEY_ROUND, 0)
        msgs.append(msg)

    errors = []
    t0 = time.monotonic()
    stats = com.broadcast(msgs, on_error=lambda r, e: errors.append((r, e)))
    bcast_wall = time.monotonic() - t0

    # the fast peers must finish while the slow peer still stalls
    deadline = t0 + STALL_S * 0.75
    for r in range(1, n_peers):
        while peers[r].done_t is None and time.monotonic() < deadline:
            time.sleep(0.005)
    # the slow peer drains only after the stall
    slow_deadline = t0 + STALL_S + 30.0
    while time.monotonic() < slow_deadline \
            and peers[slow_rank].done_t is None:
        time.sleep(0.01)

    if errors:
        _fail(f"stage 1: broadcast surfaced errors: {errors}")
    if stats["enqueued"] != n_peers:
        _fail(f"stage 1: enqueued {stats['enqueued']} != {n_peers}")
    if bcast_wall >= STALL_S / 4:
        _fail(f"stage 1: broadcast() took {bcast_wall:.3f}s — blocked on "
              f"the stalled peer (stall {STALL_S}s)")
    fast_done = [peers[r].done_t for r in range(1, n_peers)]
    if any(t is None for t in fast_done):
        _fail("stage 1: a fast peer never received its frame while the "
              "slow peer stalled — fan-out is serialized")
    if max(t - t0 for t in fast_done) >= STALL_S * 0.75:
        _fail("stage 1: fast peers drained only near/after the stall — "
              "fan-out is serialized behind the slow peer")
    if peers[slow_rank].done_t is None:
        _fail("stage 1: slow peer never drained")
    slow_took = peers[slow_rank].done_t - t0
    if slow_took < STALL_S - 0.1:
        _fail(f"stage 1: slow peer drained in {slow_took:.3f}s — the "
              f"stall never produced backpressure; the stage proves "
              f"nothing")
    if shared.encode_count != 1:
        _fail(f"stage 1: payload encoded {shared.encode_count}x, want 1")
    for r, peer in peers.items():
        got = Message.from_bytes(peer.frames[0]).get(
            Message.MSG_ARG_KEY_MODEL_PARAMS)
        got_w = np.asarray(got["w"])
        if got_w.dtype != tree["w"].dtype \
                or not np.array_equal(got_w, tree["w"]):
            _fail(f"stage 1: peer {r} frame decoded to a different "
                  "payload")
    print(f"stage 1 OK: broadcast {n_peers}x{PAYLOAD_MB}MB returned in "
          f"{bcast_wall * 1e3:.1f} ms; fast peers drained in "
          f"{max(t - t0 for t in fast_done):.2f}s; slow peer in "
          f"{slow_took:.2f}s (stall {STALL_S}s); one encode")


# -- stage 2: federation ledger parity under a delayed silo ------------------
def _run_federation(port_base: int, device, fault_plan=None):
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        run_fedavg_cross_silo)
    from fedml_tpu_torch.control import ServerControlCheckpointer
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig
    from fedml_tpu_torch.utils.tracing import RoundTimer

    worker_num = 4
    ds = make_blob_federated(client_num=worker_num, dim=8, class_num=3,
                             n_samples=128, seed=11)
    addresses = {r: (_HOST, port_base + r)
                 for r in range(worker_num + 1)}
    timer = RoundTimer()
    with tempfile.TemporaryDirectory(prefix="fanout_smoke_") as ck:
        model, history = run_fedavg_cross_silo(
            ds, create_model("lr", 3, input_shape=(8,)),
            worker_num=worker_num, comm_round=3,
            train_cfg=TrainConfig(epochs=1, batch_size=8, lr=0.1),
            backend="TCP", addresses=addresses, timer=timer,
            fault_plan=fault_plan, round_deadline_s=30.0,
            min_quorum_frac=0.5, server_checkpoint_dir=ck, device=device)
        ledger = ServerControlCheckpointer(ck).read_ledger()
    return model, history, ledger, timer


def stage_federation(port_base: int, device="cuda") -> None:
    import torch

    ref_model, ref_hist, ref_ledger, ref_timer = _run_federation(
        port_base, device)
    # every model broadcast to silo rank 4 is delivered DELAY_MS late
    plan = (f"seed=3;delay:p=1.0,delay_ms={DELAY_MS:.0f},msg_type=2,"
            f"receiver=4,direction=recv")
    model, hist, ledger, timer = _run_federation(port_base + 16, device,
                                                 fault_plan=plan)

    if len(hist) != len(ref_hist) or len(hist) != 3:
        _fail(f"stage 2: chaos run finished {len(hist)}/3 rounds")
    got_rep = [sorted(r.get("reported", [])) for r in ledger]
    ref_rep = [sorted(r.get("reported", [])) for r in ref_ledger]
    if got_rep != ref_rep or len(got_rep) != 3:
        _fail(f"stage 2: reported-set ledger diverged: {got_rep} vs "
              f"{ref_rep} — the slow silo fell out of the round")
    fanout_ms = timer.gauges.get("bcast_fanout_ms")
    if fanout_ms is None:
        _fail("stage 2: no bcast_fanout_ms gauge — the fan-out path "
              "never ran")
    if fanout_ms >= DELAY_MS / 2:
        _fail(f"stage 2: round-open fan-out took {fanout_ms:.1f} ms "
              f"against a {DELAY_MS:.0f} ms slow peer — the round "
              f"thread waited out the straggler")
    if ref_timer.gauges.get("send_queue_depth", 0) < 1:
        _fail("stage 2: reference run never rode the per-peer send "
              "queues (send_queue_depth gauge empty)")
    faults = timer.counters.get("ft_faults_injected", 0)
    if faults < 2:
        _fail(f"stage 2: only {faults} faults injected — the chaos "
              "delay never fired; the parity claim is untested")
    if list(ref_model) != list(model) or not all(
            torch.equal(ref_model[k], model[k]) for k in ref_model):
        _fail("stage 2: final model diverged from the fault-free "
              "reference — the fold is arrival-order sensitive")
    print(f"stage 2 OK: 3/3 rounds, ledger parity, bit-identical model; "
          f"round-open fan-out {fanout_ms:.1f} ms vs {DELAY_MS:.0f} ms "
          f"injected delay; {faults} faults injected")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port_base", type=int, default=40610)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where stage 2's models live (cuda, or cpu on a "
                         "host without a card)")
    args = ap.parse_args(argv)
    stage_transport(args.port_base)
    stage_federation(args.port_base + 32, device=args.device)
    print("FANOUT SMOKE PASS")


if __name__ == "__main__":
    main()
