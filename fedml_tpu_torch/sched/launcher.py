"""The federation scheduler: N tenant jobs over one fabric and one card (the
port's copy of ``fedml_tpu/sched/launcher.py``).

:func:`launch_jobs` is the in-process multi-tenant launcher: every job is a
full cross-silo federation (its own server, silo actors, control plane,
compression policy and round schedule) running beside the others over

- one comm fabric: a physical endpoint a rank, shared by every job through
  the job-tagged demux (``sched/router.py``);
- one device: the silos' local training and the server's decode, fold and
  eval ordered by share-weighted deficit round-robin
  (``sched/interleave.py``);
- a control plane a job: its ``ServerControlCheckpointer`` (and ledger),
  ``PaceSteerer`` and ``JoinAdmissionController`` live under
  ``<base_dir>/job_<id>/``, built by the path a solo launch takes, with
  steering fed by the job's own report latencies;
- flight logs a job under ``<base_dir>/obs/job_<id>/``, stamped with the
  job id, so ``obs report <base_dir>/obs`` gives one summary a tenant.

The contract (the chaos harness's oracle): each job's ``ledger.jsonl`` and
final model are bit for bit those of its solo run. Tenancy changes when
things run, never what they compute.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence

from fedml_tpu_torch.sched.interleave import RoundInterleaver
from fedml_tpu_torch.sched.jobs import JobSpec, build_job_fixture
from fedml_tpu_torch.sched.router import SharedFabric


def job_control_dir(base_dir: str, job_id: str) -> str:
    """``<base_dir>/job_<id>/``: the job's control-plane namespace (server
    snapshots, ledger.jsonl, the silos' residual state)."""
    return os.path.join(base_dir, f"job_{job_id}")


def job_obs_dir(base_dir: str, job_id: str) -> str:
    """``<base_dir>/obs/job_<id>/``: the job's flight logs inside the
    shared obs dir (a subdirectory a tenant, so no log file mixes jobs,
    while ``obs merge/report <base_dir>/obs`` sees every tenant)."""
    return os.path.join(base_dir, "obs", f"job_{job_id}")


def run_one_job(spec: JobSpec, base_dir: str, *, comm_factory=None,
                device_gate=None, timer=None, obs: bool = True,
                join_timeout_s: float = 600.0,
                backend: str = "INPROC", device="cuda",
                init_variables=None) -> Dict:
    """Run one job's federation (blocking) on ``device``. ``comm_factory``
    and ``device_gate`` come from the scheduler's fabric and interleaver;
    both None runs the job as a solo ``run_fedavg_cross_silo`` launch.
    ``init_variables`` (a state dict; the JAX function has no such
    argument) starts the global model from given weights, so a parity
    test can carry another package's initialization across. A spec with
    ``serve_port`` set raises ``NotImplementedError``: the serving tier is
    ROADMAP Slice D item 23c."""
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        run_fedavg_cross_silo)
    from fedml_tpu_torch.control import ServerControlCheckpointer
    from fedml_tpu_torch.utils.tracing import RoundTimer
    if spec.serve_port is not None:
        raise NotImplementedError(
            f"job {spec.id}: serve_port={spec.serve_port!r} is not ported "
            "yet: ROADMAP Queue 1, Slice D item 23c (serving)")
    ds, module, task, tcfg = build_job_fixture(spec)
    ctrl_dir = job_control_dir(base_dir, spec.id)
    timer = timer if timer is not None else RoundTimer()
    model, history = run_fedavg_cross_silo(
        ds, module, task=task, worker_num=spec.workers,
        comm_round=spec.rounds, train_cfg=tcfg, seed=spec.seed,
        backend=backend,
        compression=spec.compression,
        checkpoint_dir=ctrl_dir,
        server_checkpoint_dir=ctrl_dir,
        round_deadline_s=spec.round_deadline_s,
        min_quorum_frac=spec.min_quorum_frac,
        heartbeat_s=spec.heartbeat_s,
        pace_steering=spec.pace_steering,
        join_rate_limit=spec.join_rate_limit,
        max_deadline_extensions=spec.max_deadline_extensions,
        join_timeout_s=join_timeout_s,
        timer=timer,
        obs_dir=(job_obs_dir(base_dir, spec.id) if obs else None),
        job_id=spec.id,
        comm_factory=comm_factory,
        device_gate=device_gate,
        device=device, init_variables=init_variables)
    ledger = ServerControlCheckpointer(ctrl_dir).read_ledger()
    return {"job_id": spec.id, "history": history, "model": model,
            "ledger": ledger, "rounds": spec.rounds,
            "counters": {k: int(v) for k, v in timer.counters.items()},
            "phases": {k: float(v) for k, v in timer.totals.items()},
            "control_dir": ctrl_dir}


def launch_jobs(specs: Sequence[JobSpec], base_dir: str, *,
                backend: str = "INPROC",
                interleave: bool = True, obs: bool = True,
                join_timeout_s: float = 600.0,
                interleaver: Optional[RoundInterleaver] = None,
                fabric: Optional[SharedFabric] = None,
                device="cuda") -> Dict:
    """Run every job at once over one shared fabric and one device.

    Returns ``{"jobs": {job_id: result}, "device_time_s": {...},
    "steady_device_time_s": {...}, "fairness_ratio": ...,
    "fairness_ratio_raw": ...}``; a job that failed carries an ``error``
    entry instead of ending its co-tenants. ``interleaver`` and ``fabric``
    may come from a caller that schedules more tenants out of process (the
    chaos harness's SIGKILLed server job)."""
    specs = list(specs)
    ids = [s.id for s in specs]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate job ids in launch: {sorted(ids)}")
    os.makedirs(base_dir, exist_ok=True)
    inter = interleaver if interleaver is not None else RoundInterleaver()
    for spec in specs:
        inter.register(spec.id, spec.share)
    own_fabric = fabric is None
    if fabric is None:
        size = max(s.workers for s in specs) + 1
        fabric = SharedFabric(backend, size)
    results: Dict[str, Dict] = {}
    from fedml_tpu_torch.utils.tracing import RoundTimer

    def run_job(spec: JobSpec) -> None:
        timer = RoundTimer()
        gate = (inter.gate(spec.id, timer=timer) if interleave else None)
        try:
            results[spec.id] = run_one_job(
                spec, base_dir, comm_factory=fabric.comm_factory(spec.id),
                device_gate=gate, timer=timer, obs=obs,
                join_timeout_s=join_timeout_s, backend=backend,
                device=device)
        except Exception as exc:  # noqa: BLE001, one tenant's failure
            logging.error("job %s failed: %r", spec.id, exc, exc_info=True)
            results[spec.id] = {"job_id": spec.id, "error": repr(exc)}

    threads = [threading.Thread(target=run_job, args=(s,), daemon=True,
                                name=f"sched-job-{s.id}") for s in specs]
    for t in threads:
        t.start()
    # one deadline for all the joins: one stuck tenant must not delay the
    # report by N budgets
    deadline = time.monotonic() + join_timeout_s + 120.0
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    hung = [s.id for s, t in zip(specs, threads) if t.is_alive()]
    for job in hung:
        # is_alive() can race a thread that already stored its result: a
        # row that exists speaks for itself
        if job not in results:
            results[job] = {"job_id": job,
                            "error": "job thread still running after "
                                     "the join budget"}
    if own_fabric:
        fabric.stop()
    # a snapshot: a job thread abandoned past the budget that finishes
    # later must not replace the error row the caller reads
    return {"jobs": dict(results),
            "device_time_s": inter.usage(),
            "steady_device_time_s": inter.steady_usage(),
            # steady: past each tenant's prologue (the headline figure);
            # raw: with the one-off set-up charges
            "fairness_ratio": inter.fairness_ratio(),
            "fairness_ratio_raw": inter.fairness_ratio(steady=False)}
