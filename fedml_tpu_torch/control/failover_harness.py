"""The server failover harness, the control plane's acceptance oracle (the
port's copy of ``fedml_tpu/control/failover_harness.py``).

Two kill modes over one deterministic fixture (a seeded blob federation
with logistic regression, the same in every process that builds it):

- **A simulated crash** (:func:`run_simulated_failover`): phase 1 runs a
  server whose receive loop stops cold (no FINISH, no cleanup, its async
  writer killed mid-write) right before it broadcasts round
  ``crash_at_round``, which is what a SIGKILL looks like to the fleet;
  phase 2 builds a fresh server manager over the same fabric (the same
  in-process router, or the same TCP port), which restores the newest
  snapshot and finishes the schedule with the same silo threads. The
  memory loss is real (a new manager object); only the process survives.
- **A real SIGKILL** (:func:`run_failover_scenario`): the server runs as a
  subprocess over TCP (``python -m fedml_tpu_torch.control.
  failover_harness --role server``), the silos as threads of the caller.
  The harness polls the durable ledger, SIGKILLs the server once
  ``kill_after_round`` has closed, starts it again with the same flags
  (it restores itself), and waits for the schedule to end. A seeded
  ``silo_fault_plan`` may flap silos all along.

Either way the oracle is the ledger: the resumed run's (round, cohort)
sequence must equal an unkilled reference's (:func:`ledger_schedule`).

``--smoke`` runs a small SIGKILL scenario end to end and exits non-zero
unless the schedule completed with ``cp_restores >= 1`` and the
reference's ledger. Everything runs on ``--device`` (default ``cuda``;
``cpu`` on a host without a card).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

#: the fixture's constants: every process that builds it must agree
FIXTURE_SEED = 3
MODEL_SEED = 0
DEFAULT_WORKERS = 3
DEFAULT_ROUNDS = 8


def build_fixture(workers: int = DEFAULT_WORKERS):
    """The shared federation: (dataset, module, train config), a pure
    function of its argument (the server subprocess and the silos build
    bit-identical copies; each call gives a module of its own)."""
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig
    ds = make_blob_federated(client_num=workers, dim=8, class_num=3,
                             n_samples=120, seed=FIXTURE_SEED)
    return ds, create_model("lr", 3, input_shape=(8,)), TrainConfig(
        epochs=1, batch_size=8, lr=0.3)


def make_addresses(port_base: int, size: int) -> Dict[int, Tuple[str, int]]:
    return {r: ("127.0.0.1", port_base + r) for r in range(size)}


def free_port_base(n: int, tries: int = 200) -> int:
    """A base port whose ``n`` consecutive loopback ports were free just
    now (a TCP federation's rank r listens on base + r)."""
    import random
    rng = random.Random()
    for _ in range(tries):
        base = rng.randrange(20000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free loopback ports")


def _make_com(backend: str, rank: int, size: int, *, router=None,
              addresses=None, fault_plan=None, bind_retry_s: float = 10.0):
    """``create_comm_manager`` with a bind retry: a restarted server binds
    the port its previous incarnation held, which is released when that
    listener closes (a simulated crash) or the process dies (SIGKILL)."""
    from fedml_tpu_torch.comm import create_comm_manager
    deadline = time.monotonic() + bind_retry_s
    while True:
        try:
            return create_comm_manager(backend, rank, size, router=router,
                                       addresses=addresses,
                                       fault_plan=fault_plan)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.2)


def start_silos(backend: str, workers: int, *, router=None, addresses=None,
                fault_plan=None, heartbeat_s: float = 0.3, device="cuda",
                compression=None, fixture: Optional[Callable] = None):
    """The silo half of ``launch_federation``, standalone: client managers
    and receive threads that outlive any number of server incarnations
    (heartbeats and JOIN are their way back)."""
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        FedAvgClientManager)
    from fedml_tpu_torch.utils.device import resolve_device
    ds, module, tcfg = (fixture or build_fixture)(workers)
    dev = resolve_device(device)
    module.to(dev)
    size = workers + 1
    clients, threads = [], []
    for rank in range(1, size):
        com = _make_com(backend, rank, size, router=router,
                        addresses=addresses, fault_plan=fault_plan)
        clients.append(FedAvgClientManager(
            rank, size, com, ds, module, "classification", tcfg,
            seed=MODEL_SEED, compression=compression, device=dev,
            heartbeat_s=heartbeat_s))
    for c in clients:
        t = threading.Thread(target=c.run, daemon=True,
                             name=f"silo{c.rank}")
        t.start()
        threads.append(t)
    return clients, threads


def _build_server(com, workers: int, rounds: int, ckpt_dir: str, *,
                  deadline_s: Optional[float], min_quorum_frac: float,
                  pace: bool, join_rate_limit: float,
                  max_deadline_extensions: int, server_cls=None,
                  obs_dir: Optional[str] = None,
                  checkpoint_sync: bool = False, device="cuda",
                  compression=None, init_variables=None,
                  aggregate_fn=None, fixture: Optional[Callable] = None):
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        FedAvgAggregator, FedAvgServerManager, _initial_model)
    from fedml_tpu_torch.control import build_control_plane
    from fedml_tpu_torch.utils.device import resolve_device
    from fedml_tpu_torch.utils.tracing import RoundTimer
    ds, module, _ = (fixture or build_fixture)(workers)
    global_model = _initial_model(module, MODEL_SEED,
                                  resolve_device(device), init_variables)
    control = build_control_plane(
        server_checkpoint_dir=ckpt_dir, pace_steering=pace,
        join_rate_limit=join_rate_limit, round_deadline_s=deadline_s,
        min_quorum_frac=min_quorum_frac,
        max_deadline_extensions=max_deadline_extensions,
        checkpoint_sync=checkpoint_sync)
    cls = server_cls or FedAvgServerManager
    timer = RoundTimer()
    server = cls(0, workers + 1, com,
                 FedAvgAggregator(workers, aggregate_fn=aggregate_fn),
                 rounds, ds.client_num, global_model,
                 compression=compression, timer=timer,
                 round_deadline_s=deadline_s,
                 min_quorum_frac=min_quorum_frac, **control)
    if obs_dir:
        # the flight log beside the snapshots: a restarted server appends
        # to it under a new transport epoch, so the merged timeline
        # shows both lives
        from fedml_tpu_torch.obs import build_observability, endpoint_epoch
        obs = build_observability(obs_dir, job_id="failover", rank=0,
                                  role="server")
        obs.recorder.set_epoch(endpoint_epoch(com))
        obs.bind_timer(timer)
        server.obs = obs
    return server


def _close_obs(server) -> None:
    if server.obs is not None:
        server.obs.close()


def serve(rounds: int, workers: int, port_base: int, ckpt_dir: str, *,
          deadline_s: float, min_quorum_frac: float = 0.5,
          pace: bool = False, join_rate_limit: float = 0.0,
          max_deadline_extensions: int = 25,
          join_timeout_s: float = 600.0,
          obs_dir: Optional[str] = None,
          checkpoint_sync: bool = False, device="cuda") -> int:
    """The subprocess entry: ONE server incarnation over TCP until the
    schedule completes (or this process is killed, the point of the
    exercise). Writes ``server_summary.json`` beside the snapshots and
    returns an exit code."""
    size = workers + 1
    com = _make_com("TCP", 0, size,
                    addresses=make_addresses(port_base, size))
    try:
        return _serve_with(com, workers, rounds, ckpt_dir,
                           deadline_s=deadline_s,
                           min_quorum_frac=min_quorum_frac, pace=pace,
                           join_rate_limit=join_rate_limit,
                           max_deadline_extensions=max_deadline_extensions,
                           join_timeout_s=join_timeout_s, obs_dir=obs_dir,
                           checkpoint_sync=checkpoint_sync, device=device)
    finally:
        # the listener must not outlive a raise: the next incarnation
        # binds the same port
        com.stop_receive_message()


def _serve_with(com, workers: int, rounds: int, ckpt_dir: str, *,
                deadline_s: float, min_quorum_frac: float, pace: bool,
                join_rate_limit: float, max_deadline_extensions: int,
                join_timeout_s: float, obs_dir: Optional[str],
                checkpoint_sync: bool = False, device="cuda") -> int:
    server = _build_server(com, workers, rounds, ckpt_dir,
                           deadline_s=deadline_s,
                           min_quorum_frac=min_quorum_frac, pace=pace,
                           join_rate_limit=join_rate_limit,
                           max_deadline_extensions=max_deadline_extensions,
                           obs_dir=obs_dir,
                           checkpoint_sync=checkpoint_sync, device=device)

    # the graceful-stop barrier: a SIGTERM (a supervisor's drain, not the
    # SIGKILL legs) flushes the writer's pending snapshot and the
    # ledger's group-commit tail before the default handler ends us
    def _sigterm(signum, frame):
        ckpt = server._server_ckpt
        if ckpt is not None:
            flush = getattr(ckpt, "flush", None)
            if flush is not None:
                flush(timeout=30)
            getattr(ckpt, "inner", ckpt).sync_ledger()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (embedded use): no signal barrier
    thread = threading.Thread(target=server.run, daemon=True,
                              name="server")
    thread.start()
    try:
        server.send_init_msg()
        thread.join(timeout=join_timeout_s)
    finally:
        _close_obs(server)
    done = server.round_idx >= rounds and not thread.is_alive()
    summary = {
        "rounds_completed": int(server.round_idx),
        "schedule_rounds": int(rounds),
        "done": bool(done),
        "cp_counters": {k: int(v) for k, v in server.cp_counters.items()},
        "ft_counters": {k: int(v) for k, v in server.ft_counters.items()},
        "evictions": int(server.liveness.evictions),
        "rejoins": int(server.liveness.rejoins),
        "final_deadline_s": server.round_deadline_s,
        "error": (str(server.scheduling_error)
                  if server.scheduling_error else None),
    }
    tmp = os.path.join(ckpt_dir, f"summary.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(summary, f)
    os.replace(tmp, os.path.join(ckpt_dir, "server_summary.json"))
    return 0 if done else 1


# -- the simulated crash (in process; INPROC and TCP) -------------------------
def make_crashing_server_cls(crash_at_round: int):
    """A server that dies, its receive loop stopped cold with no FINISH
    and no cleanup, right before it broadcasts ``crash_at_round``. The
    newest published snapshot at that moment is exactly a SIGKILL's."""
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        MSG_TYPE_S2C_SYNC_MODEL, FedAvgServerManager)
    from fedml_tpu_torch.control import AsyncCheckpointWriter

    class CrashBeforeBroadcast(FedAvgServerManager):
        crashed = False

        def _broadcast_model(self, msg_type, idxs):
            if (msg_type == MSG_TYPE_S2C_SYNC_MODEL
                    and self.round_idx == crash_at_round):
                type(self).crashed = True
                # no timer outlives a killed process: the deadline the
                # close arms next would tick into the next incarnation
                self._cancel_deadline(final=True)
                self.com_manager.stop_receive_message()
                # a SIGKILL takes the writer thread with it: drop the
                # pending snapshot and fence the write in flight, or the
                # dead server would publish beside the restore. The kill
                # lands once the writer has caught up to the previous
                # boundary (as it does at a real round's pace; the LR
                # fixture's rounds take milliseconds), so the restore
                # finds that boundary or the newest one
                ckpt = self._server_ckpt
                if isinstance(ckpt, AsyncCheckpointWriter):
                    ckpt.drain_to_newest()
                    ckpt.abort()
                elif ckpt is not None:
                    ckpt.kill()
                return
            super()._broadcast_model(msg_type, idxs)

    return CrashBeforeBroadcast


def run_simulated_failover(ckpt_dir: str, *, rounds: int = 6,
                           workers: int = DEFAULT_WORKERS,
                           crash_at_round: int = 3,
                           backend: str = "INPROC",
                           port_base: Optional[int] = None,
                           deadline_s: Optional[float] = None,
                           min_quorum_frac: float = 0.5,
                           pace: bool = False,
                           join_timeout_s: float = 180.0,
                           obs_dir: Optional[str] = None,
                           checkpoint_sync: bool = False,
                           device="cuda", compression=None,
                           init_variables=None, aggregate_fn=None,
                           fixture: Optional[Callable] = None):
    """Kill and restart without subprocesses. Returns ``(final model as
    numpy, ledger, server2)``; server2 carries the restored counters and
    its timer. ``crash_at_round >= rounds`` never crashes (the unkilled
    reference). ``compression``, ``init_variables`` (the initial state
    dict), ``aggregate_fn`` (the buffered close) and ``fixture`` (a
    callable ``workers -> (dataset, module, train config)``) reshape the
    federation."""
    from fedml_tpu_torch.comm.compression import to_numpy
    from fedml_tpu_torch.comm.inproc import InProcRouter
    from fedml_tpu_torch.comm.policy import resolve_compression
    from fedml_tpu_torch.control import ServerControlCheckpointer

    policy = resolve_compression(compression)
    inproc = backend.upper() == "INPROC"
    router = InProcRouter() if inproc else None
    size = workers + 1
    addresses = (make_addresses(port_base, size)
                 if backend.upper() == "TCP" else None)
    clients, client_threads = start_silos(
        backend, workers, router=router, addresses=addresses,
        device=device, compression=policy, fixture=fixture)
    common = dict(deadline_s=deadline_s, min_quorum_frac=min_quorum_frac,
                  pace=pace, join_rate_limit=0.0,
                  max_deadline_extensions=25, obs_dir=obs_dir,
                  checkpoint_sync=checkpoint_sync, device=device,
                  compression=policy, init_variables=init_variables,
                  aggregate_fn=aggregate_fn, fixture=fixture)
    crashing = crash_at_round < rounds
    servers = []
    try:
        # phase 1: runs to crash_at_round, then goes dark mid-schedule
        com1 = _make_com(backend, 0, size, router=router,
                         addresses=addresses)
        s1 = _build_server(com1, workers, rounds, ckpt_dir,
                           server_cls=(make_crashing_server_cls(
                               crash_at_round) if crashing else None),
                           **common)
        servers.append(s1)
        t1 = threading.Thread(target=s1.run, daemon=True, name="server1")
        t1.start()
        s1.send_init_msg()
        t1.join(timeout=join_timeout_s)
        assert not t1.is_alive(), \
            "phase-1 server never reached its crash point"
        s2 = s1
        if crashing:
            assert type(s1).crashed, \
                "crash point not hit: schedule too short?"
            if router is not None:
                # the dead server stopped from inside its receive loop, so
                # its stop sentinel (and stale heartbeats) still sit in
                # the shared rank-0 mailbox; a real process death frees
                # its queues, the simulation drains them
                q = router.mailbox(0)
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            # phase 2: a fresh server over the same fabric restores and
            # finishes
            com2 = _make_com(backend, 0, size, router=router,
                             addresses=addresses)
            s2 = _build_server(com2, workers, rounds, ckpt_dir, **common)
            servers.append(s2)
            t2 = threading.Thread(target=s2.run, daemon=True,
                                  name="server2")
            t2.start()
            s2.send_init_msg()
            t2.join(timeout=join_timeout_s)
            assert not t2.is_alive(), \
                "restored server did not finish the schedule"
            assert s2.round_idx >= rounds, \
                (f"restored server stopped early at round {s2.round_idx} "
                 f"of {rounds}")
        for t in client_threads:
            t.join(timeout=60)
    finally:
        for s in servers:
            s._cancel_deadline(final=True)
            s.com_manager.stop_receive_message()
            _close_obs(s)
        for c in clients:
            c.com_manager.stop_receive_message()
            c._hb_stop.set()
            if c._prefetch is not None:
                c._prefetch.close()
    ledger = ServerControlCheckpointer(ckpt_dir).read_ledger()
    return to_numpy(s2.global_model), ledger, s2


# -- the real SIGKILL (a server subprocess over TCP) --------------------------
def _spawn_server(port_base: int, rounds: int, workers: int, ckpt_dir: str,
                  deadline_s: float, pace: bool, join_rate_limit: float,
                  log_path: str, obs_dir: Optional[str] = None,
                  checkpoint_sync: bool = False,
                  device="cuda") -> subprocess.Popen:
    cmd = [sys.executable, "-m", "fedml_tpu_torch.control.failover_harness",
           "--role", "server", "--rounds", str(rounds),
           "--workers", str(workers), "--port_base", str(port_base),
           "--ckpt_dir", ckpt_dir, "--deadline_s", str(deadline_s),
           "--join_rate_limit", str(join_rate_limit),
           "--device", str(device)]
    if pace:
        cmd.append("--pace")
    if checkpoint_sync:
        cmd.append("--checkpoint_sync")
    if obs_dir:
        cmd.extend(["--obs_dir", obs_dir])
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    logf = open(log_path, "ab")
    try:
        return subprocess.Popen(cmd, stdout=logf, stderr=logf, env=env)
    finally:
        logf.close()  # the child holds its own descriptor


def _wait_for_round(ckpt_dir: str, round_idx: int, proc: subprocess.Popen,
                    timeout_s: float) -> None:
    from fedml_tpu_torch.control import ServerControlCheckpointer
    ckp = ServerControlCheckpointer(ckpt_dir)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rows = ckp.read_ledger()
        if rows and rows[-1]["round"] >= round_idx:
            return
        if proc.poll() is not None:
            raise RuntimeError(
                f"server subprocess exited (rc={proc.returncode}) before "
                f"round {round_idx} closed: see its log")
        time.sleep(0.05)
    raise TimeoutError(f"round {round_idx} did not close in {timeout_s}s")


def run_failover_scenario(ckpt_dir: str, *, rounds: int = DEFAULT_ROUNDS,
                          workers: int = DEFAULT_WORKERS,
                          kill_after_round: int = 2,
                          port_base: int = 40110,
                          deadline_s: float = 2.0,
                          pace: bool = False,
                          join_rate_limit: float = 0.0,
                          silo_fault_plan=None,
                          timeout_s: float = 300.0,
                          obs_dir: Optional[str] = None,
                          checkpoint_sync: bool = False,
                          device="cuda") -> Dict:
    """SIGKILL the server subprocess mid-schedule, start it again, and
    wait for the whole schedule. ``silo_fault_plan`` (e.g. a 30% flap)
    wraps the silo endpoints only: the chaos rides the fleet, the kill
    the coordinator. Returns the final server summary, the ledger and
    the kill's bookkeeping."""
    from fedml_tpu_torch.control import ServerControlCheckpointer
    os.makedirs(ckpt_dir, exist_ok=True)
    log_path = os.path.join(ckpt_dir, "server.log")
    clients, client_threads = start_silos(
        "TCP", workers, addresses=make_addresses(port_base, workers + 1),
        fault_plan=silo_fault_plan, device=device)
    proc = _spawn_server(port_base, rounds, workers, ckpt_dir, deadline_s,
                         pace, join_rate_limit, log_path, obs_dir=obs_dir,
                         checkpoint_sync=checkpoint_sync, device=device)
    killed_at, rc = None, None
    try:
        _wait_for_round(ckpt_dir, kill_after_round, proc, timeout_s / 2)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        killed_at = kill_after_round
        proc = _spawn_server(port_base, rounds, workers, ckpt_dir,
                             deadline_s, pace, join_rate_limit, log_path,
                             obs_dir=obs_dir,
                             checkpoint_sync=checkpoint_sync, device=device)
        rc = proc.wait(timeout=timeout_s)
        for t in client_threads:
            t.join(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for c in clients:
            c.com_manager.stop_receive_message()
            c._hb_stop.set()
            if c._prefetch is not None:
                c._prefetch.close()
    summary_path = os.path.join(ckpt_dir, "server_summary.json")
    summary = {}
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = json.load(f)
    return {
        "summary": summary,
        "ledger": ServerControlCheckpointer(ckpt_dir).read_ledger(),
        "killed_at_round": killed_at,
        "restart_rc": rc,
        "server_log": log_path,
    }


def ledger_schedule(ledger: List[Dict]) -> List[Tuple[int, Tuple[int, ...]]]:
    """The parity projection: the (round, cohort) pairs a resumed run must
    replay as the unkilled reference did."""
    return [(int(r["round"]), tuple(r["cohort"] or ())) for r in ledger]


def _smoke(tmp_root: Optional[str], obs_dir: Optional[str] = None,
           checkpoint_sync: bool = False, device="cuda") -> int:
    import tempfile
    root = tmp_root or tempfile.mkdtemp(prefix="fedml_failover_smoke_")
    t0 = time.time()
    # the unkilled reference over the same TCP topology; the default
    # async writer makes every smoke exercise a restore that may land
    # on an older boundary and replay forward
    ref_model, ref_ledger, _ = run_simulated_failover(
        os.path.join(root, "reference"), rounds=6, crash_at_round=10**9,
        backend="TCP", port_base=free_port_base(DEFAULT_WORKERS + 1),
        deadline_s=5.0, checkpoint_sync=checkpoint_sync, device=device)
    res = run_failover_scenario(
        os.path.join(root, "killed"), rounds=6, kill_after_round=2,
        port_base=free_port_base(DEFAULT_WORKERS + 1), deadline_s=2.0,
        obs_dir=obs_dir, checkpoint_sync=checkpoint_sync, device=device)
    same = ledger_schedule(res["ledger"]) == ledger_schedule(ref_ledger)
    ok = (res["summary"].get("done") is True
          and res["summary"].get("cp_counters", {}).get("restores", 0) >= 1
          and same)
    print(json.dumps({
        "server_failover_smoke": "ok" if ok else "FAILED",
        "elapsed_s": round(time.time() - t0, 1),
        "killed_at_round": res["killed_at_round"],
        "rounds_completed": res["summary"].get("rounds_completed"),
        "cp_restores": res["summary"].get("cp_counters",
                                          {}).get("restores"),
        "ledger_matches_reference": same,
    }))
    return 0 if ok else 1


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("fedml_tpu_torch server-failover harness")
    p.add_argument("--role", choices=["server", "smoke"], default="smoke")
    p.add_argument("--smoke", action="store_true",
                   help="run the SIGKILL smoke scenario and exit non-zero "
                        "unless the schedule recovered")
    p.add_argument("--rounds", type=int, default=DEFAULT_ROUNDS)
    p.add_argument("--workers", type=int, default=DEFAULT_WORKERS)
    p.add_argument("--port_base", type=int, default=40110)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--deadline_s", type=float, default=2.0)
    p.add_argument("--min_quorum_frac", type=float, default=0.5)
    p.add_argument("--pace", action="store_true")
    p.add_argument("--join_rate_limit", type=float, default=0.0)
    p.add_argument("--checkpoint_sync", action="store_true",
                   help="snapshot inline at every boundary, an fsync a "
                        "ledger line (default: the async writer thread "
                        "with newest-wins coalescing)")
    p.add_argument("--obs_dir", type=str, default=None,
                   help="flight-recorder directory (fedml_tpu_torch/obs) "
                        "for the server's incarnations")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the models live (cuda, or cpu on a host "
                        "without a card)")
    args = p.parse_args(argv)
    if args.smoke:
        args.role = "smoke"  # the documented invocation wins over --role
    if args.role == "server":
        if not args.ckpt_dir:
            p.error("--role server requires --ckpt_dir")
        return serve(args.rounds, args.workers, args.port_base,
                     args.ckpt_dir, deadline_s=args.deadline_s,
                     min_quorum_frac=args.min_quorum_frac, pace=args.pace,
                     join_rate_limit=args.join_rate_limit,
                     obs_dir=args.obs_dir,
                     checkpoint_sync=args.checkpoint_sync,
                     device=args.device)
    return _smoke(args.ckpt_dir, obs_dir=args.obs_dir,
                  checkpoint_sync=args.checkpoint_sync, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
