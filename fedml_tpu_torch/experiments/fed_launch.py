"""Generic multi-algorithm launcher, the port's counterpart of
``fedml_tpu/experiments/fed_launch.py`` (reference fed_launch: one main
that dispatches any algorithm, fedml_experiments/distributed/fed_launch/).

    python -m fedml_tpu_torch.experiments.fed_launch --algo fedopt \\
        --dataset blob --server_optimizer adam [--fused_rounds 5] \\
        [--device cpu]

Each algorithm adds its flags to the shared federated set. The port runs
fedavg (the simulation and cross-silo runners of ``main_fedavg``),
fedavg_cross_silo, fedopt, fednova, fedavg_robust, hierarchical,
turboaggregate, centralized, decentralized, contribution, fedseg
(``--dataset seg_shapes``, ``--seg_loss ce|focal``), split_nn and
vertical_fl (flat features, e.g. ``--dataset blob``; ``--party_num``),
fedgkt (``--epochs_client``, ``--epochs_server``, ``--alpha``,
``--temperature``, ``--pretrained_path``) and fednas (``--nas_variant
darts|gdas``, ``--arch_unrolled``, ``--arch_lr``,
``--nas_retrain_rounds``) on NHWC images, on ``--device`` (default
``cuda``; without a GPU and without ``--device cpu`` it raises).
``--checkpoint_dir`` / ``--resume`` reach fedavg and fedavg_cross_silo
(``--backend inproc|tcp|grpc``), as do the fault-tolerance flags
(``--round_deadline_s``, ``--min_quorum_frac``,
``--max_deadline_extensions``, ``--heartbeat_s``, ``--fault_plan``) and the
control plane's (``--server_checkpoint_dir``, ``--checkpoint_sync``,
``--pace_steering``, ``--join_rate_limit``).
fedavg_cross_silo also runs the WAN world (``--wan_trace``,
``--wan_profiles``, ``--wan_round_s``); other algorithms warn and ignore
those flags.
fedavg_async runs the straggler-tolerant servers over the in-process
router: ``--async_mode quorum`` (``--quorum``, ``--round_deadline_s``,
10 s when unset, and the control plane's flags) or ``fedasync``
(``--async_alpha``, ``--async_poly_a``, ``--max_updates``; it warns and
ignores the snapshot and steering flags, as the JAX launcher does).
"""

from __future__ import annotations

import argparse
import copy
import logging

import numpy as np
import torch

from fedml_tpu_torch.core.robust import DEFENSES, ROBUST_AGGREGATORS
from fedml_tpu_torch.experiments.args import (add_federated_args,
                                              build_dataset_and_model,
                                              resolve_max_extensions)
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
NOT_PORTED: dict = {}

# algorithms whose inner loop does not take TrainConfig's optimizer
# factory: flags like --accum_steps do not reach them
_CUSTOM_LOOP_ALGOS = {"fednova", "decentralized", "split_nn", "vertical_fl",
                      "fednas", "fedgkt"}


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
    # fedgkt (main_fedgkt.py)
    parser.add_argument("--epochs_client", type=int, default=1)
    parser.add_argument("--epochs_server", type=int, default=1)
    parser.add_argument("--pretrained_path", type=str, default=None,
                        help="torch .pth mirroring the GKT client model; "
                             "warm-starts every client feature extractor")
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--temperature", type=float, default=1.0)
    # decentralized online (main_decentralized_fl args)
    parser.add_argument("--mode", type=str, default="DOL",
                        choices=["DOL", "PUSHSUM"])
    parser.add_argument("--topology_neighbors_num_undirected", type=int,
                        default=4)
    # fednas (main_fednas: --arch_learning_rate; --nas_variant gdas =
    # gumbel-softmax single-path search; --arch_unrolled = 2nd order)
    parser.add_argument("--arch_lr", type=float, default=3e-4)
    parser.add_argument("--nas_variant", type=str, default="darts",
                        choices=["darts", "gdas"])
    parser.add_argument("--arch_unrolled", action="store_true")
    parser.add_argument("--nas_retrain_rounds", type=int, default=0,
                        help="after the search, FedAvg-train the derived "
                             "genotype network for N rounds (reference "
                             "search->train workflow)")
    # turboaggregate
    parser.add_argument("--frac_bits", type=int, default=16)
    # vertical_fl (guest = party 0 with labels + first feature block)
    parser.add_argument("--party_num", type=int, default=3)
    # fedseg (reference SegmentationLosses)
    parser.add_argument("--seg_loss", type=str, default="ce",
                        choices=["ce", "focal"])
    # fedavg_async (straggler tolerance; the deadline is the shared
    # --round_deadline_s, 10 s in quorum mode when unset)
    parser.add_argument("--async_mode", type=str, default="quorum",
                        choices=["quorum", "fedasync"],
                        help="quorum: close rounds at (all | deadline and "
                             "quorum); fedasync: merge every update with a "
                             "staleness-decayed weight")
    parser.add_argument("--quorum", type=int, default=1)
    parser.add_argument("--async_alpha", type=float, default=0.6)
    parser.add_argument("--async_poly_a", type=float, default=0.5)
    parser.add_argument("--max_updates", type=int, default=20,
                        help="fedasync: the update budget (the async "
                             "counterpart of --comm_round)")


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
        logging.warning("--checkpoint_dir is only wired for --algo fedavg "
                        "and fedavg_cross_silo; ignoring for %r", args.algo)
    if args.algo != "fedavg_async" and (
            args.server_checkpoint_dir or args.checkpoint_sync
            or args.pace_steering or args.join_rate_limit):
        logging.warning("the control plane's flags are only wired for the "
                        "cross-silo servers (fedavg's socket backends, "
                        "fedavg_cross_silo, fedavg_async); ignoring for %r",
                        args.algo)
    if args.obs_dir or args.job_id:
        # the JAX launcher threads the flight recorder through these two
        # paths alone
        logging.warning("--obs_dir/--job_id are only wired for --algo "
                        "fedavg and fedavg_cross_silo; ignoring for %r",
                        args.algo)


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


def _validate_before_sink(args, ds) -> None:
    """Shape and flag checks that refuse before a metrics run is opened."""
    x = ds.train_data_global[0]
    if args.algo in ("split_nn", "vertical_fl") and x.ndim != 2:
        raise SystemExit(
            f"{args.algo}'s generic wiring needs flat features (e.g. "
            f"--dataset blob); {args.dataset!r} samples have shape "
            f"{x.shape[1:]}")
    if args.algo == "vertical_fl" and not 0 < args.party_num <= x.shape[1]:
        raise SystemExit(
            f"--party_num {args.party_num} must be in [1, {x.shape[1]}] "
            f"(the feature dimension of {args.dataset!r})")
    if args.algo in ("fedgkt", "fednas") and x.ndim != 4:
        raise SystemExit(
            f"{args.algo} needs an NHWC image dataset (e.g. --dataset "
            f"img_blob); {args.dataset!r} samples have shape {x.shape[1:]}")


def run_algo(args):
    ds, model, task = build_dataset_and_model(args)
    _validate_before_sink(args, ds)
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
    if args.wan_trace and args.algo != "fedavg_cross_silo":
        logging.warning("--wan_trace/--wan_profiles are only wired for "
                        "--algo fedavg_cross_silo (the WAN world drives the "
                        "actor protocol's liveness and rejoin paths); "
                        "ignoring for %r", args.algo)
    if args.algo == "fedavg":
        return BACKEND_RUNNERS[args.backend](args, ds, model, task, sink)
    if args.algo == "fedavg_cross_silo":
        # the cross-silo actor protocol, one silo a sampled client, over
        # the in-process router unless --backend names one
        silo_args = copy.copy(args)
        if silo_args.backend == "simulation":
            silo_args.backend = "inproc"
        return run_cross_silo(silo_args, ds, model, task, sink, wan=True)
    _warn_unwired(args)
    if args.algo == "fedavg_async":
        return _run_async(args, ds, model, task, sink, tcfg)
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
    elif args.algo == "fedseg":
        from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig
        from fedml_tpu_torch.algorithms.fedseg import FedSegAPI
        if ds.train_data_global[1].ndim != 3:
            raise SystemExit(
                "fedseg needs per-pixel labels [N, H, W] (e.g. --dataset "
                f"seg_shapes); {args.dataset!r} labels have shape "
                f"{ds.train_data_global[1].shape[1:]}")
        api = FedSegAPI(ds, model, config=FedAvgConfig(**fedavg_common),
                        loss_mode=args.seg_loss, device=dev)
    elif args.algo == "decentralized":
        return _run_decentralized(args, ds, sink)
    elif args.algo == "split_nn":
        return _run_split_nn(args, ds, sink)
    elif args.algo == "vertical_fl":
        return _run_vertical_fl(args, ds, sink)
    elif args.algo == "fednas":
        return _run_fednas(args, ds, sink, tcfg)
    elif args.algo == "fedgkt":
        from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI, FedGKTConfig
        from fedml_tpu_torch.models.resnet_gkt import (resnet8_56,
                                                       resnet56_server)
        # the JAX launcher passes no --lr: both optimizers keep lr 0.01
        api = FedGKTAPI(ds, resnet8_56(ds.class_num),
                        resnet56_server(ds.class_num),
                        FedGKTConfig(comm_round=args.comm_round,
                                     epochs_client=args.epochs_client,
                                     epochs_server=args.epochs_server,
                                     batch_size=args.batch_size,
                                     alpha=args.alpha,
                                     temperature=args.temperature,
                                     seed=args.seed,
                                     pretrained_client_path=(
                                         args.pretrained_path)),
                        device=dev)
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


def _run_async(args, ds, model, task, sink, tcfg):
    """The quorum or FedAsync server over the in-process router, one silo
    a sampled client; the final record adds ``partial_rounds`` (quorum)
    or ``updates`` and ``mean_staleness`` (fedasync)."""
    from fedml_tpu_torch.algorithms.fedavg_async import run_fedavg_async
    _, history, server = run_fedavg_async(
        ds, model, task=task, worker_num=args.client_num_per_round,
        mode=args.async_mode, comm_round=args.comm_round,
        quorum=args.quorum,
        round_deadline_s=(args.round_deadline_s
                          if args.round_deadline_s is not None else 10.0),
        alpha=args.async_alpha, poly_a=args.async_poly_a,
        max_updates=args.max_updates, train_cfg=tcfg, seed=args.seed,
        compression=args.compression, heartbeat_s=args.heartbeat_s,
        fault_plan=args.fault_plan,
        server_checkpoint_dir=args.server_checkpoint_dir,
        checkpoint_sync=args.checkpoint_sync,
        pace_steering=args.pace_steering,
        join_rate_limit=args.join_rate_limit,
        max_deadline_extensions=resolve_max_extensions(args),
        device=args.device)
    for rec in history:
        sink.log(rec, step=rec["round"])
    final = dict(history[-1]) if history else {}
    if args.async_mode == "quorum":
        final["partial_rounds"] = list(server.partial_rounds)
    else:
        final["updates"] = len(server.update_log)
        final["mean_staleness"] = (
            float(np.mean([u["staleness"] for u in server.update_log]))
            if server.update_log else 0.0)
    sink.log({k: v for k, v in final.items() if not isinstance(v, list)})
    logging.info("final: %s", final)
    return final


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


def _run_split_nn(args, ds, sink):
    from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI, SplitNNConfig
    from fedml_tpu_torch.models.vfl import VFLDenseModel, VFLFeatureExtractor
    # the JAX launcher's cut: a (64, 32) dense bottom, a dense top
    bottom = VFLFeatureExtractor(ds.train_data_global[0].shape[1], (64, 32))
    top = VFLDenseModel(bottom.output_dim, ds.class_num, use_bias=True)
    api = SplitNNAPI(ds, bottom, top, config=SplitNNConfig(
        epochs_per_node=args.epochs, batch_size=args.batch_size, lr=args.lr,
        wd=args.wd, seed=args.seed), device=args.device)
    for r in range(args.comm_round):
        sink.log(api.train_one_rotation(r), step=r)
    logging.info("final: %s", api.history[-1])
    return api.history[-1]


def _run_vertical_fl(args, ds, sink):
    from fedml_tpu_torch.algorithms.vertical_fl import VFLConfig, build_vfl
    xg, yg = ds.train_data_global
    xt, yt = ds.test_data_global
    x_train = np.asarray(xg, np.float32)
    x_test = np.asarray(xt, np.float32)
    # the guest holds the labels (made binary: the reference VFL task is
    # binary logistic regression, party_models.py) and the first feature
    # block; the hosts hold the rest
    y_train = (np.asarray(yg).reshape(-1) % 2).astype(np.float32)
    y_test = (np.asarray(yt).reshape(-1) % 2).astype(np.float32)
    cuts = np.array_split(np.arange(x_train.shape[1]), args.party_num)
    fixture = build_vfl([len(c) for c in cuts],
                        VFLConfig(epochs=args.comm_round,
                                  batch_size=args.batch_size, lr=args.lr,
                                  seed=args.seed), device=args.device)
    final = fixture.fit([x_train[:, c] for c in cuts], y_train,
                        [x_test[:, c] for c in cuts], y_test)
    for rec in fixture.history:
        sink.log(rec, step=rec["epoch"])
    logging.info("final: %s", final)
    return final


def _run_fednas(args, ds, sink, tcfg):
    from fedml_tpu_torch.algorithms.fednas import FedNASAPI, FedNASConfig
    from fedml_tpu_torch.models.darts import DartsNetwork
    api = FedNASAPI(ds, DartsNetwork(C=8, num_classes=ds.class_num,
                                     layers=2),
                    FedNASConfig(comm_round=args.comm_round,
                                 epochs=args.epochs,
                                 batch_size=args.batch_size, lr=args.lr,
                                 arch_lr=args.arch_lr, seed=args.seed,
                                 variant=args.nas_variant,
                                 arch_unrolled=args.arch_unrolled),
                    device=args.device)
    for r in range(args.comm_round):
        rec = api.run_round(r)
        sink.log({k: v for k, v in rec.items() if k != "genotype"}, step=r)
        logging.info("round %d: search_loss=%.4f", r, rec["search_loss"])
    final = {**api.evaluate(), "genotype": str(api.history[-1]["genotype"])}
    if args.nas_retrain_rounds > 0:
        # the second half of the NAS workflow (reference model.py /
        # train.py): the searched genotype as a fixed network, trained
        # federated from scratch through FedAvg
        from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
        from fedml_tpu_torch.models.darts_eval import GenotypeNetwork
        eval_net = GenotypeNetwork(api.genotype(), C=8,
                                   num_classes=ds.class_num, layers=3,
                                   stem_multiplier=1)
        retrain = FedAvgAPI(ds, eval_net, device=args.device,
                            config=FedAvgConfig(
                                comm_round=args.nas_retrain_rounds,
                                client_num_per_round=(
                                    args.client_num_per_round),
                                frequency_of_the_test=(
                                    args.frequency_of_the_test),
                                seed=args.seed, train=tcfg))
        retrain_final = retrain.train()
        for rec in retrain.history:
            sink.log({f"retrain_{k}": v for k, v in rec.items()},
                     step=rec.get("round"))
        final.update({f"retrain_{k}": v for k, v in retrain_final.items()})
    sink.log({k: v for k, v in final.items() if k != "genotype"})
    logging.info("final: %s", final)
    return final


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
