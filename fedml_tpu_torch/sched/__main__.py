"""CLI: ``python -m fedml_tpu_torch.sched <command>``, the tenancy tools
(the port's copy of ``fedml_tpu/sched/__main__.py``).

``launch``: N federation jobs at once over one shared comm fabric and one
device::

    python -m fedml_tpu_torch.sched launch --jobs jobs.json \\
        --base_dir runs/sched [--device cpu]

Each job gets its control plane under ``<base_dir>/job_<id>/`` (snapshots
and ledger.jsonl) and flight logs under ``<base_dir>/obs/job_<id>/``;
device time is shared by share-weighted deficit round-robin
(``--no-interleave`` reverts to arrival order). Prints one JSON summary
with each job's result and the fairness ratio; exit 1 if a job failed.

``serve``: the subprocess entry of one tenant's server over TCP (the chaos
harness's SIGKILL target, ``sched/chaos.py``).

``smoke``: two jobs over one fabric, one real SIGKILL, the survivor's bits
and a per-tenant ``obs report`` checked.

Everything runs on ``--device`` (default ``cuda``; ``cpu`` on a host
without a card).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional


def _cmd_launch(args) -> int:
    from fedml_tpu_torch.sched.jobs import load_jobs
    from fedml_tpu_torch.sched.launcher import launch_jobs
    specs = load_jobs(args.jobs)
    res = launch_jobs(specs, args.base_dir,
                      backend=args.backend,
                      interleave=not args.no_interleave,
                      obs=not args.no_obs,
                      join_timeout_s=args.join_timeout_s,
                      device=args.device)
    jobs_out = {}
    for j, r in res["jobs"].items():
        row = {k: v for k, v in r.items()
               if k in ("job_id", "rounds", "error", "counters",
                        "control_dir")}
        row["rounds_completed"] = len(r.get("ledger") or [])
        row["final"] = r["history"][-1] if r.get("history") else None
        jobs_out[j] = row
    out = {
        "jobs": jobs_out,
        "device_time_s": {k: round(v, 4)
                          for k, v in res["device_time_s"].items()},
        "fairness_ratio": res["fairness_ratio"],
    }
    print(json.dumps(out, indent=2))
    failed = [j for j, r in res["jobs"].items() if r.get("error")]
    for j in failed:
        print(f"job {j} FAILED: {res['jobs'][j]['error']}",
              file=sys.stderr)
    return 1 if failed else 0


def _cmd_serve(args) -> int:
    from fedml_tpu_torch.sched.chaos import serve_spec
    return serve_spec(args.spec, args.ckpt_dir, args.port_base,
                      join_timeout_s=args.join_timeout_s,
                      obs_dir=args.obs_dir, device=args.device,
                      hold_before_round=args.hold_before_round)


def _cmd_smoke(args) -> int:
    import tempfile
    from fedml_tpu_torch.sched.chaos import run_tenancy_smoke
    root = args.root or tempfile.mkdtemp(prefix="fedml_sched_smoke_")
    return run_tenancy_smoke(root, port_base=args.port_base,
                             timeout_s=args.timeout_s, device=args.device)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="python -m fedml_tpu_torch.sched",
        description="federation scheduler: multi-job tenancy tools")
    sub = parser.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", type=str, default="cuda",
                       help="where the models live (cuda, or cpu on a "
                            "host without a card)")

    ln = sub.add_parser("launch", help="run N jobs over one shared "
                                       "fabric and one device")
    ln.add_argument("--jobs", type=str, required=True,
                    help="jobs.json: a list of job specs or "
                         "{'jobs': [...]} (see fedml_tpu_torch/sched/"
                         "jobs.py)")
    ln.add_argument("--base_dir", type=str, default="runs/sched",
                    help="scheduler namespace root: per-job control "
                         "under job_<id>/, flight logs under "
                         "obs/job_<id>/")
    ln.add_argument("--backend", type=str, default="INPROC",
                    help="shared-fabric transport (INPROC default; TCP "
                         "for a wire-level fabric in one process)")
    ln.add_argument("--no-interleave", action="store_true",
                    dest="no_interleave",
                    help="disable fair-share device interleaving "
                         "(arrival-order device access)")
    ln.add_argument("--no-obs", action="store_true", dest="no_obs",
                    help="disable per-job flight recorders")
    ln.add_argument("--join_timeout_s", type=float, default=600.0)
    device_flag(ln)
    ln.set_defaults(fn=_cmd_launch)

    sv = sub.add_parser("serve", help="one tenant's server over TCP "
                                      "(chaos-harness subprocess entry)")
    sv.add_argument("--spec", type=str, required=True,
                    help="job spec JSON file (one JobSpec object)")
    sv.add_argument("--ckpt_dir", type=str, required=True,
                    help="the job's control-plane dir (job_<id>/)")
    sv.add_argument("--port_base", type=int, required=True)
    sv.add_argument("--join_timeout_s", type=float, default=600.0)
    sv.add_argument("--obs_dir", type=str, default=None)
    sv.add_argument("--hold_before_round", type=int, default=None,
                    help="park before this round's broadcast until the "
                         "process is killed (the harness's first "
                         "incarnation)")
    device_flag(sv)
    sv.set_defaults(fn=_cmd_serve)

    sm = sub.add_parser("smoke", help="two-job SIGKILL smoke")
    sm.add_argument("--root", type=str, default=None,
                    help="artifact root (default: a fresh tmpdir)")
    sm.add_argument("--port_base", type=int, default=None,
                    help="the victim's TCP ports (default: free ones)")
    sm.add_argument("--timeout_s", type=float, default=300.0)
    device_flag(sm)
    sm.set_defaults(fn=_cmd_smoke)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
