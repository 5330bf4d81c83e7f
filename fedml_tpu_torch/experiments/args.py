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
                             "mpi is the same router); spmd, tcp and grpc "
                             "are not ported yet and raise")
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
                        help="flight recorder (not ported yet: raises)")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--checkpoint_dir", type=str, default=None,
                        help="round checkpoints (not ported yet: raises)")
    parser.add_argument("--ci", type=int, default=0,
                        help="1 = tiny smoke-run truncation (reference --ci)")
    return parser


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
