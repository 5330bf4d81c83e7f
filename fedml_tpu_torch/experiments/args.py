"""Shared argparse flags, the port's subset of
``fedml_tpu/experiments/args.py`` (reference flag set:
fedml_experiments/distributed/fedavg/main_fedavg.py:48-117), plus
``--device``."""

from __future__ import annotations

import argparse


def add_federated_args(parser: argparse.ArgumentParser):
    parser.add_argument("--model", type=str, default=None,
                        help="model name (default: dataset's reference pick)")
    parser.add_argument("--dataset", type=str, default="blob")
    parser.add_argument("--data_dir", type=str, default="")
    parser.add_argument("--partition_method", type=str, default="hetero",
                        choices=["homo", "hetero"])
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--client_num_in_total", type=int, default=10)
    parser.add_argument("--client_num_per_round", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--client_optimizer", type=str, default="sgd",
                        choices=["sgd", "adam"],
                        help="sgd, or adam (optax's amsgrad, with --wd "
                             "folded into the gradient)")
    parser.add_argument("--backend", type=str, default="simulation",
                        choices=["simulation", "spmd", "inproc", "mpi",
                                 "tcp", "grpc"],
                        help="simulation (FedAvgAPI) or the cross-silo "
                             "protocol over the in-process router (inproc; "
                             "mpi is the same router) or loopback sockets "
                             "(tcp, grpc: rank r on port 29500 + r); spmd "
                             "is not ported yet and raises")
    parser.add_argument("--compression", type=str, default=None,
                        help="cross-silo wire policy: none | delta_int8 | "
                             "topk_ef | topk_ef_int8, optionally with a "
                             "top-k keep fraction (topk_ef_int8:0.05); "
                             "$FEDML_TPU_TORCH_COMPRESSION overrides")
    parser.add_argument("--compress", action="store_true",
                        help="legacy cross-silo flag: int8 uplink deltas "
                             "only (delta_int8 without the downlink); use "
                             "--compression for both directions")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the run uses (default cuda; "
                             "raises when no GPU is present — pass "
                             "--device cpu to run on the CPU)")
    parser.add_argument("--lr", type=float, default=0.03)
    parser.add_argument("--wd", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--comm_round", type=int, default=10)
    parser.add_argument("--frequency_of_the_test", type=int, default=5)
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=[None, "bfloat16", "float32"],
                        help="mixed precision: forward and backward in "
                             "this dtype off float32 masters")
    parser.add_argument("--accum_steps", type=int, default=1,
                        help="gradient accumulation: one optimizer step "
                             "every k real micro-batches (optax "
                             "MultiSteps, mean of the gradients)")
    parser.add_argument("--lr_decay_round", type=float, default=1.0,
                        help="per-round exponential client-LR decay: "
                             "effective lr at round r is lr * decay**r")
    parser.add_argument("--prefetch_depth", type=int, default=2,
                        help="pack + upload up to this many next-round "
                             "cohorts on a background thread (0 = serial; "
                             "$FEDML_TPU_TORCH_PREFETCH overrides); the "
                             "trajectory is the same either way")
    parser.add_argument("--fused_rounds", type=int, default=0,
                        help="fused multi-round dispatch: up to this many "
                             "rounds a dispatch (FusedRounds; on a GPU, "
                             "replays of a captured CUDA graph); 0 = the "
                             "host round loop")
    parser.add_argument("--eval_train_subsample", type=int, default=None,
                        help="evaluate train metrics on a fixed seeded "
                             "subsample of the train union (None = full)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_dir", type=str, default="./runs/latest")
    parser.add_argument("--obs_dir", type=str, default=None,
                        help="federation flight recorder "
                             "(fedml_tpu_torch/obs): per-round telemetry "
                             "and perf (MFU) records to "
                             "flight_rank<r>.jsonl under this directory, "
                             "per-silo digest rows, and anomaly-armed "
                             "one-shot torch.profiler windows under "
                             "<obs_dir>/profiles. Merge N logs with "
                             "`python -m fedml_tpu_torch.obs merge "
                             "<obs_dir>`. Pure observer: trajectories are "
                             "bit-exact vs unset (the default: off)")
    parser.add_argument("--job_id", type=str, default=None,
                        help="flight-record correlation id stamped on "
                             "every telemetry record (default: a derived "
                             "per-run id) — lets one obs_dir hold several "
                             "jobs' logs")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="save the round state after every round (the "
                             "host loop's model; the cross-silo server's "
                             "model and each silo's EF residual)")
    parser.add_argument("--resume", action="store_true",
                        help="restart from the latest checkpoint in "
                             "--checkpoint_dir")
    # -- fault tolerance (the cross-silo backends) --------------------------
    parser.add_argument("--round_deadline_s", type=float, default=None,
                        help="cross-silo fault tolerance: close a round "
                             "with the weighted partial aggregate once this "
                             "deadline passes with >= min_quorum_frac of "
                             "the live silos reported, evicting the rest "
                             "(they rejoin via JOIN and a full-precision "
                             "resync). Unset = the strict all-received "
                             "barrier. Also the per-round deadline of "
                             "--algo fedavg_async quorum mode (10 there "
                             "when unset)")
    parser.add_argument("--min_quorum_frac", type=float, default=0.5,
                        help="fraction of the live silos that must report "
                             "before a deadline close may evict the rest "
                             "(below it the deadline extends)")
    parser.add_argument("--heartbeat_s", type=float, default=0.0,
                        help="silo heartbeat period (0 = off): idle silos "
                             "beat the server's liveness table, and after "
                             "three silent beats send JOIN to be "
                             "re-admitted (evicted or restarted silos)")
    parser.add_argument("--fault_plan", type=str, default=None,
                        help="seeded fault injection (comm/faults.py): a "
                             "DSL string like "
                             "'seed=7;drop:p=0.1;delay:p=0.2,delay_ms=50', "
                             "inline JSON, or a .json path. Wraps every "
                             "endpoint; empty/unset = no injection")
    # -- the elastic control plane (fedml_tpu_torch/control) -----------------
    parser.add_argument("--server_checkpoint_dir", type=str, default=None,
                        help="durable server control-plane snapshots and "
                             "the round/cohort ledger: the whole round-"
                             "schedule state (round index, live set, "
                             "compression mirror, pending replies, "
                             "steering windows) is written atomically at "
                             "round boundaries and deadline extensions, so "
                             "a killed and restarted server resumes mid-"
                             "schedule. Written by a thread of their own "
                             "(newest-wins, group-committed ledger "
                             "fsyncs) unless --checkpoint_sync. Unset = no "
                             "snapshots")
    parser.add_argument("--checkpoint_sync", action="store_true",
                        help="write the control-plane snapshots inline at "
                             "every boundary, one ledger fsync a line (the "
                             "restore point is always the newest "
                             "boundary, at the round thread's cost); also "
                             "makes the silos' residual stores write "
                             "inline. Off = the async writer: a restore "
                             "may land a few rounds back and replay "
                             "forward to the same ledger")
    parser.add_argument("--pace_steering", action="store_true",
                        help="adaptive pace steering: each round's "
                             "deadline (p90 of the observed report "
                             "latencies x1.5, clamped to [base/4, "
                             "base*4]) and quorum from the straggler "
                             "distribution; --round_deadline_s is the "
                             "base and --min_quorum_frac the floor. Off = "
                             "the static schedule")
    parser.add_argument("--join_rate_limit", type=float, default=0.0,
                        help="JOIN admission: a token-bucket rate (JOINs a "
                             "second) on the server's full-precision "
                             "resync path; a throttled silo gets "
                             "BACKPRESSURE with retry_after_s. 0 = off")
    parser.add_argument("--max_deadline_extensions", type=int, default=25,
                        help="cap on the below-quorum deadline extensions "
                             "of a round; past it the run fails loudly "
                             "(SchedulingStallError) instead of extending "
                             "forever. Negative = unbounded")
    # -- WAN-realistic federation (fedml_tpu_torch/wan) ----------------------
    parser.add_argument("--wan_trace", type=str, default=None,
                        help="WAN world model (--algo fedavg_cross_silo): "
                             "a seeded diurnal availability trace driving "
                             "churn through the real protocol: cohorts "
                             "sample only currently-available clients, "
                             "trace-offline silos drop replies and get "
                             "deadline-evicted, rejoin is trace-gated "
                             "through JOIN. DSL like "
                             "'seed=7;period_s=960;peak=0.95;trough=0.5;"
                             "flap=180:120:0.5', inline JSON, or a .json "
                             "path (see README 'WAN-realistic "
                             "federation'). Unset = off")
    parser.add_argument("--wan_profiles", type=str, default=None,
                        help="heterogeneous client profiles for the WAN "
                             "world: per-client compute (lognormal) and "
                             "up/downlink bandwidth (Pareto) as pure "
                             "functions of (seed, client id), injected as "
                             "report delays. DSL like "
                             "'compute_median_s=0.1;compute_sigma=0.8;"
                             "bw_alpha=1.5'. Requires --wan_trace")
    parser.add_argument("--wan_round_s", type=float, default=60.0,
                        help="WAN virtual clock: simulated seconds per "
                             "federation round (round r happens at sim "
                             "time r * wan_round_s; the trace never reads "
                             "the wall clock, so a churn run replays "
                             "bit-identically under one seed)")
    parser.add_argument("--ci", type=int, default=0,
                        help="1 = tiny smoke-run truncation (reference --ci)")
    return parser


def resolve_max_extensions(args):
    """A negative ``--max_deadline_extensions`` means unbounded, ``None``
    for the server managers (the JAX launchers' convention)."""
    v = getattr(args, "max_deadline_extensions", 25)
    return None if v is not None and v < 0 else v


def build_dataset_and_model(args):
    """Registry-driven load_data + create_model (the reference's per-main
    load_data/create_model pair, main_fedavg.py:120-266)."""
    from fedml_tpu_torch.data.registry import (DEFAULT_MODEL_AND_TASK,
                                               load_data)
    from fedml_tpu_torch.models import create_model

    ds = load_data(args.dataset, args.data_dir,
                   partition_method=args.partition_method,
                   partition_alpha=args.partition_alpha,
                   client_num_in_total=args.client_num_in_total)
    model_name, task = DEFAULT_MODEL_AND_TASK[args.dataset]
    if args.model:
        model_name = args.model
    model = create_model(model_name, output_dim=ds.class_num,
                         input_shape=ds.train_data_global[0].shape[1:])
    return ds, model, task
