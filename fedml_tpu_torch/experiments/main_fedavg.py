"""FedAvg experiment main (parity:
fedml_experiments/standalone/fedavg/main_fedavg.py), the port's
counterpart of ``fedml_tpu/experiments/main_fedavg.py``.

Runs on ``--device`` (default ``cuda``; no GPU and no ``--device cpu``
raises) either the ``simulation`` backend (FedAvgAPI) or the cross-silo
protocol: one server and ``client_num_per_round`` silo actors exchanging
messages, with the wire policy ``--compression``, over the in-process
router (``--backend inproc``, or ``mpi``, the same router) or loopback
sockets (``--backend tcp|grpc``, rank r on port 29500 + r, the JAX CLI's
address map). ``--fused_rounds R`` runs the simulation R rounds a dispatch
through ``FusedRounds`` (on a GPU, replays of a captured CUDA graph of the
round). ``--checkpoint_dir`` saves the round state after every round (the
simulation's model; the cross-silo server's model and each silo's EF
residual) and ``--resume`` restarts from the latest checkpoint, for the
host loop of either backend. ``--obs_dir`` (with ``--job_id``) turns on the
flight recorder for either backend: ``flight_rank<r>.jsonl`` a rank, with
per-round perf records (MFU against the card's BF16 peak); read them with
``python -m fedml_tpu_torch.obs merge|report|tail <obs_dir>``.
The cross-silo backends take the fault-tolerance flags
``--round_deadline_s``, ``--min_quorum_frac``, ``--max_deadline_extensions``,
``--heartbeat_s`` and ``--fault_plan``. ``--backend spmd`` is not ported
yet and raises ``NotImplementedError``; the control plane's flags
(ROADMAP item 23) are not ported yet.

Usage: python -m fedml_tpu_torch.experiments.main_fedavg \
    --dataset femnist_gen --client_num_in_total 200 --client_num_per_round 10 \
    --batch_size 20 --lr 0.1 --comm_round 5 \
    [--fused_rounds 5 --compute_dtype bfloat16] \
    [--backend inproc|tcp|grpc --compression topk_ef_int8:0.05] \
    [--checkpoint_dir ckpt [--resume]] [--obs_dir obs [--job_id j]]
"""

from __future__ import annotations

import argparse
import logging

from fedml_tpu_torch.experiments.args import (add_federated_args,
                                              build_dataset_and_model,
                                              resolve_max_extensions)
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.checkpoint import CheckpointManager
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.metrics import MetricsSink

#: the loopback port of rank 0 under --backend tcp|grpc (rank r listens on
#: this + r), the JAX CLI's address map
BASE_PORT = 29500


def make_train_config(args) -> TrainConfig:
    return TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                       lr=args.lr, client_optimizer=args.client_optimizer,
                       wd=args.wd, compute_dtype=args.compute_dtype,
                       accum_steps=args.accum_steps,
                       lr_decay_round=args.lr_decay_round)


def run_simulation(args, ds, model, task, sink):
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig

    cfg = FedAvgConfig(comm_round=args.comm_round,
                       client_num_per_round=args.client_num_per_round,
                       frequency_of_the_test=args.frequency_of_the_test,
                       seed=args.seed,
                       eval_train_subsample=args.eval_train_subsample,
                       prefetch_depth=args.prefetch_depth,
                       obs_dir=args.obs_dir, job_id=args.job_id,
                       train=make_train_config(args))
    api = FedAvgAPI(ds, model, task=task, config=cfg, device=args.device)
    if args.fused_rounds:
        # up to --fused_rounds rounds a dispatch, with the host loop's
        # trajectory and eval cadence
        rec = api.fused_rounds().train(
            max_rounds_per_dispatch=args.fused_rounds)
        for hist_rec in api.history:
            sink.log(hist_rec, step=hist_rec["round"])
        return rec
    mgr = (CheckpointManager(args.checkpoint_dir)
           if args.checkpoint_dir else None)
    start = 0
    if mgr and args.resume:
        restored = mgr.restore_latest({"variables": api.variables})
        if restored:
            state, meta = restored
            api.variables = state["variables"]
            start = meta["round_idx"]
            logging.info("resumed from round %d", start)
    rec = {}
    for r in range(start, cfg.comm_round):
        api.run_round(r)
        if r % cfg.frequency_of_the_test == 0 or r == cfg.comm_round - 1:
            rec = api.evaluate(r)
            sink.log(rec, step=r)
        if mgr:
            mgr.save(r + 1, {"variables": api.variables})
    return rec


def run_cross_silo(args, ds, model, task, sink):
    """The cross-silo protocol, one silo per sampled client (``worker_num =
    client_num_per_round``), evaluating every round, over the in-process
    router or (tcp, grpc) loopback sockets on ports ``BASE_PORT + rank``.
    Logs one record a round and a final summary record with the wire
    bytes, each round's duration and the phases' host ms (phases that end
    in device work synchronize, so they include it)."""
    from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
        run_fedavg_cross_silo)
    from fedml_tpu_torch.utils.tracing import RoundTimer

    addresses = None
    if args.backend in ("tcp", "grpc"):
        addresses = {r: ("127.0.0.1", BASE_PORT + r)
                     for r in range(args.client_num_per_round + 1)}
    timer = RoundTimer()
    _, history = run_fedavg_cross_silo(
        ds, model, task=task, worker_num=args.client_num_per_round,
        comm_round=args.comm_round, train_cfg=make_train_config(args),
        backend=args.backend, addresses=addresses, compress=args.compress,
        compression=args.compression, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        prefetch_depth=args.prefetch_depth,
        round_deadline_s=args.round_deadline_s,
        min_quorum_frac=args.min_quorum_frac, heartbeat_s=args.heartbeat_s,
        fault_plan=args.fault_plan,
        max_deadline_extensions=resolve_max_extensions(args),
        obs_dir=args.obs_dir, job_id=args.job_id, timer=timer,
        device=args.device)
    for rec in history:
        sink.log(rec, step=rec["round"])
    rounds = max(1, len(history))
    sink.log({"summary": "cross_silo", "rounds": len(history),
              "round_duration_s": [r["duration_s"]
                                   for r in timer.round_records()],
              "comm_bytes_up": timer.comm_bytes_up,
              "comm_bytes_down": timer.comm_bytes_down,
              "comm_bytes_up_per_round": timer.comm_bytes_up / rounds,
              "comm_bytes_down_per_round": timer.comm_bytes_down / rounds,
              **{f"gauge_{k}": v for k, v in timer.gauges.items()},
              **{f"phase_{k}_ms": v * 1e3
                 for k, v in timer.means().items()},
              **{f"phase_{k}_ms_per_round": v * 1e3 / rounds
                 for k, v in timer.totals.items()}})
    return history[-1] if history else {}


BACKEND_RUNNERS = {"simulation": run_simulation, "inproc": run_cross_silo,
                   "mpi": run_cross_silo, "tcp": run_cross_silo,
                   "grpc": run_cross_silo}


def _not_ported(args) -> None:
    """Raise for the flags whose paths this slice does not run yet, before
    any data is built."""
    if args.backend not in BACKEND_RUNNERS:
        raise NotImplementedError(
            f"--backend {args.backend} is not ported yet: ROADMAP Queue 1 "
            "(spmd: item 26)")
    if args.fused_rounds and args.backend != "simulation":
        raise ValueError("--fused_rounds fuses the simulation backend's "
                         f"rounds; --backend {args.backend} exchanges a "
                         "message a round")
    if args.fused_rounds and args.checkpoint_dir:
        # the JAX CLI warns and runs without checkpoints; the port refuses
        # rather than drop the flag
        raise ValueError("--checkpoint_dir checkpoints the host round loop; "
                         "--fused_rounds runs fused blocks, which save no "
                         "round state")


def apply_ci_truncation(args):
    """--ci 1 = smoke-run truncation (clamps rounds and participants)."""
    if args.ci:
        args.comm_round = min(args.comm_round, 2)
        args.client_num_per_round = min(args.client_num_per_round, 4)
        args.frequency_of_the_test = 1
    return args


def main(argv=None):
    parser = argparse.ArgumentParser("fedml_tpu_torch fedavg")
    add_federated_args(parser)
    args = apply_ci_truncation(parser.parse_args(argv))
    resolve_device(args.device)  # no GPU and no --device cpu: raise now
    _not_ported(args)
    logging.basicConfig(level=logging.INFO)
    ds, model, task = build_dataset_and_model(args)
    sink = MetricsSink(args.run_dir, config=vars(args),
                       use_wandb=args.use_wandb)
    final = BACKEND_RUNNERS[args.backend](args, ds, model, task, sink)
    sink.finish()
    logging.info("final: %s", final)
    return final


if __name__ == "__main__":
    main()
