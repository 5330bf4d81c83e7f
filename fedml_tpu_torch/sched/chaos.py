"""The tenancy failover harness, the scheduler's acceptance oracle (the
port's copy of ``fedml_tpu/sched/chaos.py``).

The claim multi-job tenancy must defend: one tenant's coordinator dying is
that tenant's problem. The harness proves it the hard way:

1. **solo legs**: every surviving job runs alone through the scheduler
   (the same code path, a trivial interleaver); its ``ledger.jsonl`` and
   final model are the reference;
2. **the shared leg**: all jobs run at once, the survivors in process over
   one shared fabric (``sched/router.py``), the victim's silos in the same
   process contending for the same device through the shared interleaver,
   and the victim's server as a real TCP subprocess (``python -m
   fedml_tpu_torch.sched serve``: coordinators deploy as processes of
   their own, which is what makes a real SIGKILL possible);
3. **the kill**: once the victim's ledger closes ``kill_after_round``, its
   server takes SIGKILL, is started again with the same flags, restores
   from its own ``job_<id>/`` snapshot and finishes;
4. **the verdict**: every survivor's ledger rows and final model are bit
   for bit its solo leg's, and the victim finishes its schedule with
   ``cp_restores >= 1``.

:func:`run_tenancy_smoke` is the two-job smoke (exit non-zero unless the
verdict holds, a per-job ``obs report`` from the one shared obs dir
included).

Two divergences from the JAX module: :func:`model_blob` writes the port's
own canonical bytes (each state-dict entry's name, dtype, shape and CPU
bytes, in order), where the JAX module serializes through flax's msgpack,
which the port does not import; and the victim's server subprocess runs on
the caller's ``device``, passed as ``--device`` (it never falls back),
where the JAX module forces its child onto the CPU. A third: the first
server incarnation parks before it broadcasts round ``kill_after_round +
1`` (``serve --hold_before_round``) until the SIGKILL takes it, so the kill
lands mid-schedule however fast the rounds are; the JAX harness races the
kill against the schedule, which a round of milliseconds can win.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from fedml_tpu_torch.sched.interleave import RoundInterleaver
from fedml_tpu_torch.sched.jobs import JobSpec, build_job_fixture
from fedml_tpu_torch.sched.launcher import (job_control_dir, job_obs_dir,
                                            launch_jobs)

#: the default three-tenant fixture: different populations, shapes, round
#: counts and shares (tenants are allowed to be unalike)
DEFAULT_SPECS = (
    JobSpec(id="joba", workers=2, rounds=6, seed=5, share=1.0,
            dim=8, class_num=3, n_samples=120, batch_size=8, lr=0.2),
    JobSpec(id="jobb", workers=3, rounds=8, seed=7, share=1.0,
            dim=6, class_num=2, n_samples=150, batch_size=10, lr=0.1,
            round_deadline_s=2.0, heartbeat_s=0.3),
    JobSpec(id="jobc", workers=2, rounds=6, seed=9, share=2.0,
            dim=10, class_num=4, n_samples=160, batch_size=8, lr=0.15),
)


def model_blob(model) -> bytes:
    """Canonical bytes of a model state dict (tensors on any device, or
    numpy arrays): for each entry in order, its name, dtype and shape as a
    JSON header and its bytes on the CPU, each length-prefixed. The
    bit-identity oracle of final-model parity."""
    import numpy as np
    import torch
    out = bytearray()
    for name, value in model.items():
        t = (value.detach() if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(value)))
        t = t.cpu().contiguous()
        head = json.dumps([name, str(t.dtype).replace("torch.", ""),
                           list(t.shape)]).encode()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        for part in (head, raw):
            out += len(part).to_bytes(8, "little") + part
    return bytes(out)


def solo_parity(ref: Dict, ten: Dict):
    """The tenancy oracle: ``(error, ledger_ok, model_ok)`` for one job's
    solo result against its shared-fabric result."""
    err = ref.get("error") or ten.get("error")
    ledger_ok = not err and ref.get("ledger") == ten.get("ledger")
    model_ok = (not err
                and model_blob(ref["model"]) == model_blob(ten["model"]))
    return err, bool(ledger_ok), bool(model_ok)


def _write_spec(spec: JobSpec, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(spec.to_json(), f, indent=2)
    os.replace(tmp, path)


def _spawn_victim_server(spec_path: str, ckpt_dir: str, port_base: int,
                         log_path: str, obs_dir: Optional[str],
                         device, hold_before_round: Optional[int] = None
                         ) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "fedml_tpu_torch.sched", "serve",
           "--spec", spec_path, "--ckpt_dir", ckpt_dir,
           "--port_base", str(port_base), "--device", str(device)]
    if obs_dir:
        cmd.extend(["--obs_dir", obs_dir])
    if hold_before_round is not None:
        cmd.extend(["--hold_before_round", str(hold_before_round)])
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


def serve_spec(spec_path: str, ckpt_dir: str, port_base: int, *,
               join_timeout_s: float = 600.0,
               obs_dir: Optional[str] = None, device="cuda",
               hold_before_round: Optional[int] = None) -> int:
    """Subprocess entry: one server incarnation of one tenant job over TCP
    on ``device``, run until its schedule completes or the process is
    killed (the point of the exercise). The control plane and the ledger
    live under ``ckpt_dir``, the job's ``job_<id>/``. With
    ``hold_before_round`` the server parks before it broadcasts that
    round, its boundary snapshot and ledger line already queued, and waits
    there for its SIGKILL."""
    from fedml_tpu_torch.control.failover_harness import (_make_com,
                                                          make_addresses)
    from fedml_tpu_torch.sched.jobs import spec_from_dict
    with open(spec_path) as f:
        spec = spec_from_dict(json.load(f))
    size = spec.workers + 1
    com = _make_com("TCP", 0, size,
                    addresses=make_addresses(port_base, size))
    try:
        return _serve_spec_with(com, spec, ckpt_dir,
                                join_timeout_s=join_timeout_s,
                                obs_dir=obs_dir, device=device,
                                hold_before_round=hold_before_round)
    finally:
        # the listener must not outlive a raise: the next incarnation
        # binds the same port
        com.stop_receive_message()


def _holding_server_cls(hold_before_round: int):
    """A server that parks its round thread before it broadcasts
    ``hold_before_round``, until the process is killed."""
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        MSG_TYPE_S2C_SYNC_MODEL, FedAvgServerManager)

    class HoldBeforeBroadcast(FedAvgServerManager):
        def _broadcast_model(self, msg_type, idxs):
            if (msg_type == MSG_TYPE_S2C_SYNC_MODEL
                    and self.round_idx == hold_before_round):
                logging.warning("server parked before the round-%d "
                                "broadcast, waiting for its SIGKILL",
                                hold_before_round)
                threading.Event().wait()
            super()._broadcast_model(msg_type, idxs)

    return HoldBeforeBroadcast


def _serve_spec_with(com, spec: JobSpec, ckpt_dir: str, *,
                     join_timeout_s: float, obs_dir: Optional[str],
                     device, hold_before_round: Optional[int] = None
                     ) -> int:
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        FedAvgAggregator, FedAvgServerManager, _initial_model)
    from fedml_tpu_torch.control import build_control_plane
    from fedml_tpu_torch.utils.device import resolve_device
    from fedml_tpu_torch.utils.tracing import RoundTimer
    ds, module, _task, _tcfg = build_job_fixture(spec)
    global_model = _initial_model(module, spec.seed, resolve_device(device),
                                  None)
    # the spec pins everything that shapes the run, with no substitutes: a
    # strict-barrier victim (round_deadline_s None) runs a strict barrier
    # here too
    control = build_control_plane(
        server_checkpoint_dir=ckpt_dir, pace_steering=spec.pace_steering,
        join_rate_limit=spec.join_rate_limit,
        round_deadline_s=spec.round_deadline_s,
        min_quorum_frac=spec.min_quorum_frac,
        max_deadline_extensions=spec.max_deadline_extensions)
    cls = (FedAvgServerManager if hold_before_round is None
           else _holding_server_cls(hold_before_round))
    server = cls(
        0, spec.workers + 1, com, FedAvgAggregator(spec.workers),
        spec.rounds, ds.client_num, global_model,
        compression=spec.compression, timer=RoundTimer(),
        round_deadline_s=spec.round_deadline_s,
        min_quorum_frac=spec.min_quorum_frac, **control)
    if obs_dir:
        from fedml_tpu_torch.obs import build_observability, endpoint_epoch
        obs = build_observability(obs_dir, job_id=spec.id, rank=0,
                                  role="server")
        obs.recorder.set_epoch(endpoint_epoch(com))
        obs.bind_timer(server.round_timer)
        server.obs = obs
    thread = threading.Thread(target=server.run, daemon=True,
                              name="server")
    thread.start()
    try:
        server.send_init_msg()
        thread.join(timeout=join_timeout_s)
    finally:
        if server.obs is not None:
            server.obs.close()
    done = server.round_idx >= spec.rounds and not thread.is_alive()
    summary = {
        "job_id": spec.id,
        "rounds_completed": int(server.round_idx),
        "schedule_rounds": int(spec.rounds),
        "done": bool(done),
        "cp_counters": {k: int(v) for k, v in server.cp_counters.items()},
        "ft_counters": {k: int(v) for k, v in server.ft_counters.items()},
        "error": (str(server.scheduling_error)
                  if server.scheduling_error else None),
    }
    tmp = os.path.join(ckpt_dir, f"summary.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(summary, f)
    os.replace(tmp, os.path.join(ckpt_dir, "server_summary.json"))
    return 0 if done else 1


def _wait_for_close(ckpt_dir: str, rows_before: int,
                    proc: subprocess.Popen, timeout_s: float) -> None:
    """Block until the ledger holds more than ``rows_before`` lines (every
    close, repeats included): the incarnation's first closed round."""
    from fedml_tpu_torch.control import ServerControlCheckpointer
    ckp = ServerControlCheckpointer(ckpt_dir)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if len(ckp.read_ledger(dedup=False)) > rows_before:
            return
        if proc.poll() is not None:
            raise RuntimeError(
                f"server subprocess exited (rc={proc.returncode}) before "
                "it closed a round: see its log")
        time.sleep(0.02)
    raise TimeoutError(f"no round closed in {timeout_s}s")


def _run_victim_job(spec: JobSpec, base_dir: str, inter: RoundInterleaver,
                    *, port_base: int, kill_after_round: int,
                    timeout_s: float, obs: bool, out: Dict,
                    device="cuda") -> None:
    """The victim tenant in the shared leg: its silos in this process (the
    same device and interleaver as every co-tenant), its server a TCP
    subprocess SIGKILLed once ``kill_after_round`` has closed and started
    again (it restores from its own job_<id>/ snapshot). Each
    incarnation's time from spawn to its first closed round is kept."""
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        FedAvgClientManager)
    from fedml_tpu_torch.control import ServerControlCheckpointer
    from fedml_tpu_torch.control.failover_harness import (_make_com,
                                                          _wait_for_round,
                                                          make_addresses)
    from fedml_tpu_torch.utils.device import resolve_device
    ctrl = job_control_dir(base_dir, spec.id)
    os.makedirs(ctrl, exist_ok=True)
    ds, module, task, tcfg = build_job_fixture(spec)
    dev = resolve_device(device)
    module.to(dev)
    size = spec.workers + 1
    addresses = make_addresses(port_base, size)
    inter.register(spec.id, spec.share)
    if not spec.heartbeat_s:
        # honored (the spec is the contract), but the respawned server
        # learns of live silos through their heartbeats: without them the
        # recovery may stall
        logging.warning("victim job %s has heartbeat_s=%r: silos cannot "
                        "announce themselves to the respawned server; "
                        "recovery may stall", spec.id, spec.heartbeat_s)
    clients, threads = [], []
    for rank in range(1, size):
        com = _make_com("TCP", rank, size, addresses=addresses)
        clients.append(FedAvgClientManager(
            rank, size, com, ds, module, task, tcfg, seed=spec.seed,
            compression=spec.compression, device=dev,
            heartbeat_s=spec.heartbeat_s,
            device_gate=inter.gate(spec.id)))
    for c in clients:
        t = threading.Thread(target=c.run, daemon=True,
                             name=f"victim-silo{c.rank}")
        t.start()
        threads.append(t)
    spec_path = os.path.join(ctrl, "spec.json")
    _write_spec(spec, spec_path)
    log_path = os.path.join(ctrl, "server.log")
    obs_dir = job_obs_dir(base_dir, spec.id) if obs else None
    ledger = ServerControlCheckpointer(ctrl)
    incarnations: List[Dict] = []
    t_spawn = time.monotonic()
    proc = _spawn_victim_server(spec_path, ctrl, port_base, log_path,
                                obs_dir, device,
                                hold_before_round=kill_after_round + 1)
    killed_at = None
    rc = None
    try:
        _wait_for_close(ctrl, 0, proc, timeout_s / 2)
        incarnations.append(
            {"spawn_to_first_round_s": time.monotonic() - t_spawn})
        _wait_for_round(ctrl, kill_after_round, proc, timeout_s / 2)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        killed_at = kill_after_round
        rows = len(ledger.read_ledger(dedup=False))
        t_spawn = time.monotonic()
        proc = _spawn_victim_server(spec_path, ctrl, port_base, log_path,
                                    obs_dir, device)
        _wait_for_close(ctrl, rows, proc, timeout_s)
        incarnations.append(
            {"spawn_to_first_round_s": time.monotonic() - t_spawn})
        rc = proc.wait(timeout=timeout_s)
    except Exception as exc:  # noqa: BLE001, the verdict reports it
        out[spec.id] = {"job_id": spec.id, "error": repr(exc),
                        "server_log": log_path,
                        "incarnations": incarnations}
        return
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for t in threads:
            t.join(timeout=60)
        for c in clients:
            # a silo the FINISH never reached must not outlive the leg
            c.com_manager.stop_receive_message()
            c._hb_stop.set()
            if c._prefetch is not None:
                c._prefetch.close()
    summary = {}
    summary_path = os.path.join(ctrl, "server_summary.json")
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            summary = json.load(f)
    out[spec.id] = {
        "job_id": spec.id,
        "summary": summary,
        "ledger": ledger.read_ledger(),
        "killed_at_round": killed_at,
        "restart_rc": rc,
        "server_log": log_path,
        "incarnations": incarnations,
    }


def run_tenancy_failover(root: str, *,
                         specs: Optional[Sequence[JobSpec]] = None,
                         victim: Optional[str] = None,
                         kill_after_round: int = 2,
                         port_base: Optional[int] = None,
                         timeout_s: float = 300.0,
                         join_timeout_s: float = 240.0,
                         obs: bool = True, device="cuda") -> Dict:
    """The whole scenario on ``device``: solo reference legs, then the
    shared leg with a real SIGKILL of one tenant's server. ``port_base``
    None takes free loopback ports. Returns the verdict (``ok`` and each
    job's parity or recovery evidence)."""
    from fedml_tpu_torch.control.failover_harness import free_port_base
    specs = list(specs if specs is not None else DEFAULT_SPECS)
    victim = victim or specs[1].id
    by_id = {s.id: s for s in specs}
    if victim not in by_id:
        raise ValueError(f"victim {victim!r} not among job ids "
                         f"{sorted(by_id)}")
    if port_base is None:
        port_base = free_port_base(by_id[victim].workers + 1)
    survivors = [s for s in specs if s.id != victim]
    os.makedirs(root, exist_ok=True)

    # -- solo reference legs, alone through the same scheduler -----------
    solo: Dict[str, Dict] = {}
    for spec in survivors:
        res = launch_jobs([spec], os.path.join(root, "solo", spec.id),
                          obs=False, join_timeout_s=join_timeout_s,
                          device=device)
        solo[spec.id] = res["jobs"][spec.id]

    # -- the shared leg: survivors in process, the victim's server a
    # subprocess -----------------------------------------------------------
    shared_dir = os.path.join(root, "shared")
    inter = RoundInterleaver()
    victim_out: Dict[str, Dict] = {}
    vt = threading.Thread(
        target=_run_victim_job,
        args=(by_id[victim], shared_dir, inter),
        kwargs=dict(port_base=port_base, kill_after_round=kill_after_round,
                    timeout_s=timeout_s, obs=obs, out=victim_out,
                    device=device),
        daemon=True, name=f"sched-victim-{victim}")
    vt.start()
    shared = launch_jobs(survivors, shared_dir, interleaver=inter,
                         obs=obs, join_timeout_s=join_timeout_s,
                         device=device)
    # the victim leg's own budgets sum to about 2 * timeout_s + 120 (half
    # of it twice before the kill, the respawn's first close and its
    # exit, the reaps and the joins): the outer join covers them
    vt.join(timeout=2 * timeout_s + 180)
    if vt.is_alive():
        victim_out.setdefault(victim, {"job_id": victim,
                                       "error": "victim leg still "
                                                "running after budget"})

    # -- the verdict ---------------------------------------------------------
    jobs_report: Dict[str, Dict] = {}
    ok = True
    for spec in survivors:
        ref = solo[spec.id]
        ten = shared["jobs"].get(spec.id, {})
        err, ledger_ok, model_ok = solo_parity(ref, ten)
        jobs_report[spec.id] = {
            "role": "survivor",
            "error": err,
            "ledger_rounds": len(ten.get("ledger") or []),
            "ledger_identical_to_solo": bool(ledger_ok),
            "model_identical_to_solo": bool(model_ok),
        }
        ok = ok and ledger_ok and model_ok
    vres = victim_out.get(victim, {})
    vsum = vres.get("summary", {})
    recovered = (vres.get("error") is None
                 and vsum.get("done") is True
                 and vsum.get("cp_counters", {}).get("restores", 0) >= 1)
    jobs_report[victim] = {
        "role": "victim",
        "error": vres.get("error"),
        "killed_at_round": vres.get("killed_at_round"),
        "rounds_completed": vsum.get("rounds_completed"),
        "cp_restores": vsum.get("cp_counters", {}).get("restores", 0),
        "recovered_full_schedule": bool(recovered),
        "server_log": vres.get("server_log"),
        "incarnations": vres.get("incarnations", []),
    }
    ok = ok and recovered
    return {
        "ok": bool(ok),
        "victim": victim,
        "jobs": jobs_report,
        "device_time_s": inter.usage(),
        "fairness_ratio": inter.fairness_ratio(),
        "obs_dir": os.path.join(shared_dir, "obs") if obs else None,
    }


def run_tenancy_smoke(root: str, *, port_base: Optional[int] = None,
                      timeout_s: float = 300.0, device="cuda") -> int:
    """Two jobs over one fabric, the victim's server SIGKILLed mid-schedule.
    Exit 0 only when the survivor's ledger and model are bit for bit its
    solo leg's, the victim recovered through its own checkpoint, and
    ``obs report`` gives one summary a tenant from the shared obs dir."""
    specs = [
        JobSpec(id="joba", workers=2, rounds=6, seed=5, share=1.0,
                batch_size=8, lr=0.2),
        JobSpec(id="jobb", workers=3, rounds=8, seed=7, share=1.0,
                dim=6, class_num=2, n_samples=150, batch_size=10,
                lr=0.1, round_deadline_s=2.0, heartbeat_s=0.3),
    ]
    t0 = time.time()
    res = run_tenancy_failover(root, specs=specs, victim="jobb",
                               port_base=port_base, timeout_s=timeout_s,
                               device=device)
    # a per-tenant report from the one shared obs dir is part of the
    # smoke's contract
    report_jobs: List[str] = []
    report_ok = False
    if res["obs_dir"] and os.path.isdir(res["obs_dir"]):
        from fedml_tpu_torch.obs.report import summarize
        report = summarize([res["obs_dir"]])
        report_jobs = sorted(report["jobs"])
        report_ok = set(report_jobs) >= {s.id for s in specs}
    ok = bool(res["ok"] and report_ok)
    print(json.dumps({
        "tenancy_smoke": "ok" if ok else "FAILED",
        "elapsed_s": round(time.time() - t0, 1),
        "jobs": res["jobs"],
        "fairness_ratio": res["fairness_ratio"],
        "obs_report_jobs": report_jobs,
    }, indent=2))
    if not ok:
        logging.error("tenancy smoke failed: %s",
                      json.dumps(res["jobs"], indent=2))
    return 0 if ok else 1
