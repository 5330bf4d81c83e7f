"""The WAN-churn CLI: the smoke and the trace inspector (the port's copy
of ``fedml_tpu/wan/__main__.py``).

``python -m fedml_tpu_torch.wan smoke`` runs a small cross-silo
federation over loopback TCP through a diurnal trough and a flap burst,
twice, and exits non-zero unless:

- the whole schedule closes (churn degrades rounds, never stalls them);
- at least one silo was deadline-evicted and at least one rejoined
  through the trace-gated JOIN;
- every sampled cohort member was available in the trace at its round's
  sim time, with no forced (fallback) cohort;
- the second run's round ledger equals the first's.

``python -m fedml_tpu_torch.wan curve --trace SPEC`` prints a trace's
availability curve and its per-round silo online matrix: the tool that
designs fixtures (the world is a pure function, so what it prints is what
a run meets).

Both run on the card unless ``--device cpu``. Each leg's ledger is the
control plane's (``ServerControlCheckpointer.read_ledger``, one row a
closed round: ``round``, ``cohort``, ``reported``, ``partial``,
``deadline_s``), as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

#: the fixture, the JAX package's: chosen with ``curve`` so the trough and
#: the flap evict some silos of the fleet, never all
SMOKE_WORKERS = 4
SMOKE_ROUNDS = 8
SMOKE_POPULATION = 24
SMOKE_ROUND_S = 60.0
SMOKE_TRACE = ("seed=20;period_s=960;phase0_s=480;peak=0.98;trough=0.45;"
               "duty_jitter=0.05;slot_s=120;flap=60:120:0.5")
SMOKE_PROFILES = ("seed=5;compute_median_s=0.12;compute_sigma=0.5;"
                  "delay_cap_s=1.0")
SMOKE_DEADLINE_S = 2.0

def build_fixture(population: int = SMOKE_POPULATION):
    """A blob population larger than the silo fleet, so the cohort draw
    has a real pool to restrict by availability: the dataset, the LR
    model and its TrainConfig."""
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig
    ds = make_blob_federated(client_num=population, dim=8, class_num=3,
                             n_samples=population * 20, seed=3,
                             noise=5.0, partition_method="homo")
    return ds, create_model("lr", 3, input_shape=(8,)), TrainConfig(
        epochs=1, batch_size=8, lr=0.08)


def smoke_world():
    from fedml_tpu_torch.wan import (WanWorld, parse_wan_profiles,
                                     parse_wan_trace)
    return WanWorld(trace=parse_wan_trace(SMOKE_TRACE),
                    profiles=parse_wan_profiles(SMOKE_PROFILES),
                    round_s=SMOKE_ROUND_S, delay_wall_cap_s=0.8,
                    # the shadow admission bucket on the sim clock: the
                    # population's JOIN wave against a real rate
                    mass_join_rate=0.05)


def run_churn_leg(ckpt_dir: Optional[str] = None, *,
                  rounds: int = SMOKE_ROUNDS,
                  workers: int = SMOKE_WORKERS,
                  world=None, backend: str = "TCP",
                  port_base: Optional[int] = 40310,
                  pace_steering: bool = False,
                  deadline_s: float = SMOKE_DEADLINE_S,
                  min_quorum_frac: float = 0.25,
                  obs_dir: Optional[str] = None,
                  compression=None,
                  fault_plan=None,
                  join_timeout_s: float = 300.0,
                  init_variables=None,
                  device="cuda") -> Dict:
    """One federation under the world model, checkpointing its control
    plane into ``ckpt_dir`` (a temporary directory when None); returns the
    history, the round ledger read back from the checkpointer, the
    counters and gauges, and the world. ``init_variables`` (a state dict)
    replaces the seeded initial model."""
    import tempfile

    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        run_fedavg_cross_silo)
    from fedml_tpu_torch.control import ServerControlCheckpointer
    from fedml_tpu_torch.control.failover_harness import make_addresses
    from fedml_tpu_torch.utils.tracing import RoundTimer

    if ckpt_dir is None:
        with tempfile.TemporaryDirectory(prefix="fedml_wan_leg_") as tmp:
            return run_churn_leg(
                tmp, rounds=rounds, workers=workers, world=world,
                backend=backend, port_base=port_base,
                pace_steering=pace_steering, deadline_s=deadline_s,
                min_quorum_frac=min_quorum_frac, obs_dir=obs_dir,
                compression=compression, fault_plan=fault_plan,
                join_timeout_s=join_timeout_s,
                init_variables=init_variables, device=device)
    ds, module, tcfg = build_fixture()
    timer = RoundTimer()
    addresses = (make_addresses(port_base, workers + 1)
                 if backend.upper() == "TCP" else None)
    t0 = time.perf_counter()
    round_walls: Dict[int, float] = {}

    def record(rec):
        # each round's wall offset, for time-to-target figures
        round_walls[int(rec["round"])] = round(time.perf_counter() - t0, 4)

    _, history = run_fedavg_cross_silo(
        ds, module, worker_num=workers, comm_round=rounds,
        train_cfg=tcfg, backend=backend, addresses=addresses,
        round_deadline_s=deadline_s, min_quorum_frac=min_quorum_frac,
        heartbeat_s=0.2, server_checkpoint_dir=ckpt_dir,
        pace_steering=pace_steering, timer=timer, wan=world,
        obs_dir=obs_dir, compression=compression, fault_plan=fault_plan,
        round_record_hook=record, join_timeout_s=join_timeout_s,
        device=device, init_variables=init_variables)
    wall = time.perf_counter() - t0
    ledger = ServerControlCheckpointer(ckpt_dir).read_ledger()
    return {
        "history": history,
        "ledger": ledger,
        "wall_s": round(wall, 3),
        "rounds_per_sec": round(rounds / max(wall, 1e-9), 3),
        "round_walls": round_walls,
        "counters": {k: int(v) for k, v in timer.counters.items()},
        "gauges": {k: round(float(v), 6) for k, v in timer.gauges.items()},
        "world": world,
    }


def cohorts_all_available(ledger, world) -> bool:
    """The replay oracle: every ledger cohort member is available in the
    trace at its round's sim time (a pure recomputation from the seed)."""
    for row in ledger:
        cohort = np.asarray(row.get("cohort") or [], dtype=np.int64)
        if len(cohort) and not world.trace.available(
                cohort, world.t_of_round(int(row["round"]))).all():
            return False
    return True


def _ledger_key(ledger) -> str:
    return json.dumps(ledger, sort_keys=True)


def smoke(root: Optional[str], device="cuda") -> int:
    import tempfile
    root = root or tempfile.mkdtemp(prefix="fedml_wan_smoke_")
    t0 = time.time()
    a = run_churn_leg(os.path.join(root, "leg_a"), port_base=40310,
                      world=smoke_world(), device=device)
    b = run_churn_leg(os.path.join(root, "leg_b"), port_base=40330,
                      world=smoke_world(), device=device)
    ca = a["counters"]
    checks = {
        "full_schedule": len(a["history"]) == SMOKE_ROUNDS
        and len(a["ledger"]) == SMOKE_ROUNDS,
        "evictions": ca.get("ft_evictions", 0) >= 1,
        "rejoins": ca.get("ft_rejoins", 0) >= 1,
        "partial_rounds": ca.get("ft_partial_rounds", 0) >= 1,
        "cohorts_trace_available": cohorts_all_available(a["ledger"],
                                                         a["world"]),
        "no_forced_cohorts": ca.get("wan_forced_cohorts", 0) == 0,
        "ledger_replay_identical":
            _ledger_key(a["ledger"]) == _ledger_key(b["ledger"]),
    }
    ok = all(checks.values())
    print(json.dumps({
        "wan_churn_smoke": "ok" if ok else "FAILED",
        "elapsed_s": round(time.time() - t0, 1),
        "checks": checks,
        "evictions": ca.get("ft_evictions", 0),
        "rejoins": ca.get("ft_rejoins", 0),
        "partial_rounds": ca.get("ft_partial_rounds", 0),
        "offline_drops": ca.get("wan_offline_drops", 0),
        "delay_injected_ms": ca.get("wan_delay_injected_ms", 0),
        "cohort_rejections": ca.get("wan_cohort_rejections", 0),
        "rounds_per_sec": a["rounds_per_sec"],
    }))
    return 0 if ok else 1


def curve(trace_spec: str, rounds: int, round_s: float, workers: int,
          population: int) -> int:
    """Print the pure-function view of a trace: each round's available
    fraction, the silo online matrix and the churn wave."""
    from fedml_tpu_torch.wan import WanWorld, parse_wan_trace
    world = WanWorld(trace=parse_wan_trace(trace_spec), round_s=round_s,
                     population=population)
    rows = []
    for r in range(rounds):
        silos = "".join("#" if world.silo_online(rank, r) else "."
                        for rank in range(1, workers + 1))
        frac = world.available_frac(r)
        joins, leaves, _ = world.mass_churn(r)
        rows.append({"round": r, "available_frac": round(frac, 3),
                     "silos": silos, "joins": joins, "leaves": leaves})
        print(f"r{r:3d}  frac={frac:5.3f}  silos[{silos}]  "
              f"+{joins} -{leaves}")
    print(json.dumps({"rows": rows}, indent=None))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.WARNING)
    p = argparse.ArgumentParser("python -m fedml_tpu_torch.wan")
    p.add_argument("mode", nargs="?", choices=["smoke", "curve"],
                   default="smoke")
    p.add_argument("--root", type=str, default=None,
                   help="smoke working directory (default: a tmpdir)")
    p.add_argument("--trace", type=str, default=SMOKE_TRACE,
                   help="curve mode: the --wan_trace spec to inspect")
    p.add_argument("--rounds", type=int, default=16)
    p.add_argument("--round_s", type=float, default=SMOKE_ROUND_S)
    p.add_argument("--workers", type=int, default=SMOKE_WORKERS)
    p.add_argument("--population", type=int, default=SMOKE_POPULATION)
    p.add_argument("--device", type=str, default="cuda",
                   help="smoke mode: the federation's device (cuda, or cpu)")
    args = p.parse_args(argv)
    if args.mode == "curve":
        return curve(args.trace, args.rounds, args.round_s, args.workers,
                     args.population)
    from fedml_tpu_torch.utils.device import resolve_device
    resolve_device(args.device)  # no GPU and no --device cpu: raise now
    return smoke(args.root, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
