"""Generic multi-algorithm launcher, the port's counterpart of
``fedml_tpu/experiments/fed_launch.py`` (reference fed_launch: one main
that dispatches any algorithm, fedml_experiments/distributed/fed_launch/).

    python -m fedml_tpu_torch.experiments.fed_launch --algo fedopt \\
        --dataset blob --server_optimizer adam [--fused_rounds 5] \\
        [--device cpu]

Each algorithm adds its flags to the shared federated set. The port runs
fedavg (the simulation and cross-silo runners of ``main_fedavg``),
fedavg_cross_silo, fedopt, fednova, fedavg_robust, hierarchical,
turboaggregate, centralized, decentralized and contribution on
``--device`` (default ``cuda``; without a GPU and without ``--device cpu``
it raises). The other algorithms of ``ALGOS`` raise ``NotImplementedError``
naming their ROADMAP item, before any data is built.
"""

from __future__ import annotations

import argparse
import copy
import logging

import numpy as np
import torch

from fedml_tpu_torch.core.robust import DEFENSES, ROBUST_AGGREGATORS
from fedml_tpu_torch.experiments.args import (add_federated_args,
                                              build_dataset_and_model)
from fedml_tpu_torch.experiments.main_fedavg import (BACKEND_RUNNERS,
                                                     _not_ported,
                                                     apply_ci_truncation,
                                                     make_train_config,
                                                     run_cross_silo)
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.metrics import MetricsSink

# the JAX launcher's list
ALGOS = ["fedavg", "fedavg_cross_silo", "fedopt", "fednova",
         "fedavg_robust", "hierarchical",
         "decentralized", "centralized", "fednas", "fedgkt",
         "turboaggregate", "fedseg", "split_nn", "vertical_fl",
         "contribution", "fedavg_async"]

#: algorithms the port does not run yet -> their ROADMAP Queue 1 item
NOT_PORTED = {"fednas": "item 27", "fedgkt": "item 27", "fedseg": "item 27",
              "split_nn": "item 27", "vertical_fl": "item 27",
              "fedavg_async": "Slice D item 22e"}

# algorithms whose inner loop does not take TrainConfig's optimizer
# factory: flags like --accum_steps do not reach them
_CUSTOM_LOOP_ALGOS = {"fednova", "decentralized"}


def add_algo_args(parser: argparse.ArgumentParser):
    # fedopt (main_fedopt.py:54-60)
    parser.add_argument("--server_optimizer", type=str, default="adam")
    parser.add_argument("--server_lr", type=float, default=1e-3)
    parser.add_argument("--server_momentum", type=float, default=0.0)
    # fednova
    parser.add_argument("--gmf", type=float, default=0.0)
    parser.add_argument("--prox_mu", type=float, default=0.0)
    # robust (main_fedavg_robust.py:56-63; median/trimmed_mean/krum are
    # Byzantine-robust aggregation rules beyond the reference pair)
    parser.add_argument("--defense_type", type=str,
                        default="norm_diff_clipping",
                        choices=[*DEFENSES, *sorted(ROBUST_AGGREGATORS)])
    parser.add_argument("--norm_bound", type=float, default=5.0)
    parser.add_argument("--stddev", type=float, default=0.025)
    parser.add_argument("--trim_ratio", type=float, default=0.1)
    parser.add_argument("--num_byzantine", type=int, default=1)
    parser.add_argument("--multi_m", type=int, default=1)
    # the reference's poisoned artifacts (edge_case_examples/
    # data_loader.py:283): the attacker client's local set becomes the
    # reference's clean + edge mix, and accuracy on the edge test set is
    # reported as backdoor_asr
    parser.add_argument("--poison_pkl", type=str, default=None,
                        help="reference-format poisoned train artifact "
                             "(.pkl southwest stack or .pt torch dataset). "
                             "TRUSTED PATHS ONLY: pickle/legacy torch.load "
                             "execute arbitrary code from the file")
    parser.add_argument("--poison_test_pkl", type=str, default=None,
                        help="edge-case test artifact for the attack-"
                             "success-rate metric (same trust caveat as "
                             "--poison_pkl)")
    parser.add_argument("--attacker_client", type=int, default=0)
    parser.add_argument("--target_label", type=int, default=9)
    parser.add_argument("--poison_num_edge", type=int, default=100)
    parser.add_argument("--poison_num_clean", type=int, default=400)
    # hierarchical (group_num = edge servers)
    parser.add_argument("--group_num", type=int, default=2)
    parser.add_argument("--group_comm_round", type=int, default=2)
    # decentralized online (main_decentralized_fl args)
    parser.add_argument("--mode", type=str, default="DOL",
                        choices=["DOL", "PUSHSUM"])
    parser.add_argument("--topology_neighbors_num_undirected", type=int,
                        default=4)
    # turboaggregate
    parser.add_argument("--frac_bits", type=int, default=16)


def _log_history(api, sink, fused_rounds: int = 0):
    """``api.train()``, or with ``--fused_rounds`` and an API that has a
    fused driver, ``FusedRounds.train()`` R rounds a dispatch. An API
    without a fusable round (a host-side stage, or a loop outside the
    FedAvg family) logs a warning and runs its host loop; a fused driver
    that fails while it runs raises."""
    if fused_rounds:
        try:
            driver = api.fused_rounds()
        except (AttributeError, TypeError, ValueError) as exc:
            logging.warning("--fused_rounds unsupported for %s (%s); "
                            "using the host loop", type(api).__name__, exc)
        else:
            final = driver.train(max_rounds_per_dispatch=fused_rounds)
            return _finish(api, sink, final)
    return _finish(api, sink, api.train())


def _finish(api, sink, final):
    for rec in getattr(api, "history", []):
        sink.log(rec, step=rec.get("round"))
    logging.info("final: %s", final)
    return final


def _warn_unwired(args) -> None:
    if args.accum_steps > 1 and args.algo in _CUSTOM_LOOP_ALGOS:
        logging.warning("--accum_steps is only wired for TrainConfig-based "
                        "algorithms; ignoring for %r", args.algo)
    if args.prefetch_depth != 2 and args.algo in _CUSTOM_LOOP_ALGOS:
        logging.warning("--prefetch_depth is not wired for %r's custom "
                        "loop; ignoring %d", args.algo, args.prefetch_depth)
    if args.checkpoint_dir:
        logging.warning("--checkpoint_dir is not wired for --algo %r (the "
                        "JAX launcher wires it for fedavg and "
                        "fedavg_cross_silo only); ignoring", args.algo)


def _refuse_unported(args) -> None:
    """Raise for the algorithms and flags whose paths the port does not
    run yet, before any data is built."""
    if args.algo in NOT_PORTED:
        raise NotImplementedError(
            f"--algo {args.algo} is not ported yet: ROADMAP Queue 1, "
            f"{NOT_PORTED[args.algo]}")
    if args.algo in ("fedavg", "fedavg_cross_silo"):
        _not_ported(args)
        if args.algo == "fedavg_cross_silo" and args.fused_rounds:
            raise ValueError("--fused_rounds fuses the simulation "
                             "backend's rounds; fedavg_cross_silo exchanges "
                             "a message a round")


def run_algo(args):
    ds, model, task = build_dataset_and_model(args)
    sink = MetricsSink(args.run_dir, config=vars(args),
                       use_wandb=args.use_wandb)
    try:
        return _dispatch(args, ds, model, task, sink)
    finally:
        sink.finish()


def _dispatch(args, ds, model, task, sink):
    dev = args.device
    tcfg = make_train_config(args)
    common = dict(comm_round=args.comm_round,
                  client_num_per_round=args.client_num_per_round,
                  frequency_of_the_test=args.frequency_of_the_test,
                  seed=args.seed, train=tcfg)
    # the FedAvgConfig family prefetches; FedNova's loop packs serially
    fedavg_common = dict(common, prefetch_depth=args.prefetch_depth)
    if args.algo == "fedavg":
        return BACKEND_RUNNERS[args.backend](args, ds, model, task, sink)
    if args.algo == "fedavg_cross_silo":
        # the cross-silo actor protocol, one silo a sampled client, over
        # the in-process router unless --backend names one
        silo_args = copy.copy(args)
        if silo_args.backend == "simulation":
            silo_args.backend = "inproc"
        return run_cross_silo(silo_args, ds, model, task, sink)
    _warn_unwired(args)
    if args.algo == "fedopt":
        from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, FedOptConfig
        api = FedOptAPI(ds, model, task=task, device=dev, config=FedOptConfig(
            server_optimizer=args.server_optimizer,
            server_lr=args.server_lr,
            server_momentum=args.server_momentum, **fedavg_common))
    elif args.algo == "fednova":
        from fedml_tpu_torch.algorithms.fednova import (FedNovaAPI,
                                                        FedNovaConfig)
        api = FedNovaAPI(ds, model, task=task, device=dev,
                         config=FedNovaConfig(gmf=args.gmf, mu=args.prox_mu,
                                              **common))
    elif args.algo == "fedavg_robust":
        return _run_robust(args, ds, model, task, sink, fedavg_common)
    elif args.algo == "hierarchical":
        from fedml_tpu_torch.algorithms.hierarchical import (
            HierarchicalConfig, HierarchicalFedAvgAPI)
        api = HierarchicalFedAvgAPI(ds, model, task=task, device=dev,
                                    config=HierarchicalConfig(
                                        global_comm_round=args.comm_round,
                                        group_comm_round=args.group_comm_round,
                                        group_num=args.group_num,
                                        client_num_per_round=(
                                            args.client_num_per_round),
                                        frequency_of_the_test=(
                                            args.frequency_of_the_test),
                                        seed=args.seed, train=tcfg))
    elif args.algo == "turboaggregate":
        from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
        from fedml_tpu_torch.algorithms.turboaggregate import (
            SecureFedAvgAPI, TurboAggregateConfig)
        api = SecureFedAvgAPI(ds, model, task=task, device=dev,
                              config=FedAvgConfig(**fedavg_common),
                              secure_config=TurboAggregateConfig(
                                  frac_bits=args.frac_bits, seed=args.seed))
    elif args.algo == "decentralized":
        return _run_decentralized(args, ds, sink)
    elif args.algo == "centralized":
        from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
        trainer = CentralizedTrainer(ds, model, task=task, cfg=tcfg,
                                     seed=args.seed, device=dev)
        for _ in range(args.comm_round):
            trainer.train()
        rec = trainer.evaluate()
        sink.log(rec)
        return rec
    else:  # contribution
        return _run_contribution(args, ds, model, task, sink,
                                 fedavg_common)
    return _log_history(api, sink, fused_rounds=args.fused_rounds)


def _run_robust(args, ds, model, task, sink, common):
    from fedml_tpu_torch.algorithms.fedavg import _normalized
    from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                          FedAvgRobustConfig)
    edge_test = None
    if args.poison_pkl:
        from fedml_tpu_torch.data.poisoned import (load_edge_case_artifact,
                                                   mix_edge_case_into_client)
        x_edge, y_edge = load_edge_case_artifact(
            args.poison_pkl, target_label=args.target_label)
        ds = mix_edge_case_into_client(
            ds, args.attacker_client, x_edge, y_edge,
            num_edge=args.poison_num_edge, num_clean=args.poison_num_clean,
            seed=args.seed)
        if args.poison_test_pkl:
            edge_test = load_edge_case_artifact(
                args.poison_test_pkl, target_label=args.target_label)
    api = FedAvgRobustAPI(ds, model, task=task, device=args.device,
                          config=FedAvgRobustConfig(
                              defense_type=args.defense_type,
                              norm_bound=args.norm_bound,
                              stddev=args.stddev, trim_ratio=args.trim_ratio,
                              num_byzantine=args.num_byzantine,
                              multi_m=args.multi_m, **common))
    final = _log_history(api, sink, fused_rounds=args.fused_rounds)
    if edge_test is not None:
        xh, yh = (torch.from_numpy(a).to(api.device) for a in edge_test)
        asr = _normalized(api._eval_fn(
            api.variables, xh, yh, torch.ones(len(xh), device=api.device)),
            "backdoor")
        final = {**final, "backdoor_asr": asr["backdoor_acc"]}
        sink.log({"backdoor_asr": final["backdoor_asr"]})
        logging.info("backdoor ASR on edge test set: %.4f",
                     final["backdoor_asr"])
    return final


def _run_decentralized(args, ds, sink):
    from fedml_tpu_torch.algorithms.decentralized import (
        DecentralizedConfig, DecentralizedOnlineAPI)
    # one sample stream a client from the global train set, labels made
    # binary: the online API is the reference's SUSY-style binary LR
    # (decentralized_fl_api.py), not a multi-class trainer
    xg, yg = ds.train_data_global
    n = args.client_num_in_total
    T = len(xg) // n
    if T < args.comm_round:
        raise SystemExit(
            f"--algo decentralized streams --comm_round={args.comm_round} "
            f"samples per client, but {args.dataset!r} only provides {T} "
            f"per client at --client_num_in_total={n}; lower --comm_round "
            "or --client_num_in_total")
    x = np.asarray(xg, np.float32).reshape(len(xg), -1)[:n * T]
    y = (np.asarray(yg).reshape(-1)[:n * T] % 2).astype(np.float32)
    api = DecentralizedOnlineAPI(x.reshape(n, T, -1), y.reshape(n, T),
                                 DecentralizedConfig(
                                     mode=args.mode,
                                     iteration_number=args.comm_round,
                                     learning_rate=args.lr,
                                     weight_decay=args.wd,
                                     topology_neighbors_num_undirected=(
                                         args.topology_neighbors_num_undirected),
                                     seed=args.seed), device=args.device)
    rec = {"regret": api.train(),
           "consensus_distance": api.consensus_distance()}
    sink.log(rec)
    logging.info("final: %s", rec)
    return rec


def _run_contribution(args, ds, model, task, sink, common):
    # the reference's contribution workflow (main_fedavg_contribution.py:
    # 366-380): the base federation, then one leave-one-out retrain a
    # client; each client's influence goes to the sink
    from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
    from fedml_tpu_torch.contribution.loo import LeaveOneOutMeasure
    measure = LeaveOneOutMeasure(ds, lambda: model,
                                 config=FedAvgConfig(**common), task=task,
                                 device=args.device)
    influence = measure.compute_influence()
    for k, v in enumerate(influence):
        sink.log({"client": k, "influence": v}, step=k)
    final = {"influence": influence, "ranked": measure.ranked()}
    sink.log({f"influence_client_{k}": v for k, v in enumerate(influence)})
    logging.info("final: %s", final)
    return final


def main(argv=None):
    parser = argparse.ArgumentParser("fedml_tpu_torch fed_launch")
    parser.add_argument("--algo", type=str, default="fedavg", choices=ALGOS)
    add_federated_args(parser)
    add_algo_args(parser)
    args = apply_ci_truncation(parser.parse_args(argv))
    resolve_device(args.device)  # no GPU and no --device cpu: raise now
    _refuse_unported(args)
    logging.basicConfig(level=logging.INFO)
    return run_algo(args)


if __name__ == "__main__":
    main()
