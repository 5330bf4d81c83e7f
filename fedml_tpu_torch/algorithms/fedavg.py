"""FedAvg, the flagship algorithm, as a standalone simulation on one device.

Reference semantics (kept exactly, as ``fedml_tpu/algorithms/fedavg.py``
keeps them): per-round seeded client sampling (FedAVGAggregator.py:89-97),
local SGD from the current global model (FedAVGTrainer/MyModelTrainer),
sample-weighted averaging of the full model state (FedAVGAggregator.py:
58-87), periodic evaluation over the federation (fedavg_api.py:142-207).

One round here =

    for each sampled client: local_train (epochs x batches of SGD)
    -> stack the client state dicts -> aggregate_hook (weighted mean)

Clients train one after another on the device (a loop, not ``vmap``; see
PERF.md). Pad-and-mask packing (data/base.py) gives every client of a
round the same padded length, and the async cohort pipeline
(parallel/prefetch.py) packs and uploads round r+1 while round r runs. On a
CUDA device the default aggregation is the hand-written kernel's front end
(ops/aggregate.py); on the CPU it is the plain per-leaf mean.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.sampling import (eval_subsample, make_generator,
                                           round_keys, sample_clients)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule,
                                                make_eval, make_local_train,
                                                round_lr_scale,
                                                validate_accum_steps)
from fedml_tpu_torch.utils.device import resolve_device, synchronize
from fedml_tpu_torch.utils.tracing import RoundTimer

#: per-round heartbeat for long host loops, on its own logger so callers
#: can silence it alone
_progress_log = logging.getLogger("fedml_tpu_torch.progress")


def _normalized(stats, prefix: str) -> Dict[str, float]:
    """Stat sums -> {prefix}_{acc,loss,total} means."""
    total = max(1.0, float(stats["count"]))
    return {
        f"{prefix}_acc": float(stats["correct_sum"]) / total,
        f"{prefix}_loss": float(stats["loss_sum"]) / total,
        f"{prefix}_total": float(stats["count"]),
    }


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    """Round-level knobs (reference argparse: --comm_round
    --client_num_in_total --client_num_per_round --frequency_of_the_test);
    the fields of ``fedml_tpu.algorithms.fedavg.FedAvgConfig`` but
    ``job_id``, which only names flight records."""

    comm_round: int = 10
    client_num_per_round: int = 10
    frequency_of_the_test: int = 5
    seed: int = 0
    # evaluate on a fixed seeded subsample of the train / test union
    # (core.sampling.eval_subsample); None = the full union
    eval_train_subsample: Optional[int] = None
    eval_test_subsample: Optional[int] = None
    # "cohort" pads each round to the sampled cohort's pow-2 bucket,
    # "global" to the dataset-wide max; the trajectory is the same
    pack: str = "cohort"
    # cohorts packed ahead on a background thread (0 = serial;
    # $FEDML_TPU_TORCH_PREFETCH overrides); only partial participation
    prefetch_depth: int = 2
    # the flight recorder is not ported yet: setting obs_dir raises
    obs_dir: Optional[str] = None
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class FedAvgAPI:
    """Standalone simulation API (parity:
    fedml_api/standalone/fedavg/fedavg_api.py)."""

    def __init__(self, dataset: FederatedDataset, module: torch.nn.Module,
                 task: str = "classification",
                 config: Optional[FedAvgConfig] = None,
                 delete_client: Optional[int] = None,
                 aggregate_hook=None, device="cuda"):
        """``aggregate_hook(variables, stacked, weights, agg_seed) ->
        new_variables`` customizes server aggregation (``stacked`` holds
        the clients' state dicts stacked on a leading axis, ``weights``
        their sample counts, ``agg_seed`` the round's aggregation seed);
        the default is the sample-weighted mean. ``device`` defaults to
        CUDA and raises when no GPU is present."""
        self.device = resolve_device(device)
        self.dataset = dataset
        self.module = module
        self.task = task
        self.config = config or FedAvgConfig()
        self.delete_client = delete_client
        if self.config.obs_dir is not None:
            raise NotImplementedError(
                "obs_dir (the flight recorder) is not ported yet: ROADMAP "
                "Queue 1, item 24 (obs)")
        if self.config.pack not in ("cohort", "global"):
            raise ValueError(f"unknown pack policy: {self.config.pack!r}")
        cfg = self.config.train
        # raises NotImplementedError for the options this slice lacks
        self._local_train = make_local_train(module, task, cfg)
        validate_accum_steps(cfg, dataset.train_data_local_num_dict)
        if aggregate_hook is not None:
            self._hook = aggregate_hook
        elif self.device.type == "cuda":
            # the hand-written kernel over the whole [clients, params]
            # stack, one launch per round (ops/aggregate.py)
            from fedml_tpu_torch.ops.aggregate import tree_weighted_mean_fused

            def hook(variables, stacked, weights, agg_seed):
                return tree_weighted_mean_fused(stacked, weights)
            self._hook = hook
        else:
            def hook(variables, stacked, weights, agg_seed):
                return pt.tree_weighted_mean(stacked, weights)
            self._hook = hook
        self._eval_fn = make_eval(module, task)
        self._n_pad = dataset.padded_len(cfg.batch_size)

        # initialize on the CPU from the seed, so every device starts from
        # the same weights
        init_params(module, make_generator(self.config.seed))
        self.variables = {k: v.detach().clone().to(self.device)
                          for k, v in module.state_dict().items()}
        module.to(self.device)
        self.history: List[Dict] = []
        # packed-cohort cache for full participation: the same client set
        # every round skips host packing and re-upload
        self._pack_cache = None
        # eval unions live on the device across test rounds
        self._eval_cache = None
        # (prefetcher, dataset-at-build), built on the first partial round
        self._prefetch = None
        self.timer = RoundTimer()

    # -- one round ---------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _pack_cohort(self, idxs, dataset=None):
        """Cache-free pack + upload of one sampled cohort (thread-safe: the
        prefetcher worker calls this while the main thread dispatches)."""
        cfg = self.config
        ds = dataset if dataset is not None else self.dataset
        with self.timer.phase("pack"):
            n_pad = (ds.cohort_padded_len(idxs, cfg.train.batch_size)
                     if cfg.pack == "cohort" else self._n_pad)
            x, y, mask = ds.pack_clients(idxs, cfg.train.batch_size,
                                         n_pad=n_pad)
            weights = ds.client_weights(idxs)
        with self.timer.phase("upload"):
            return (self._upload(x), self._upload(y), self._upload(mask),
                    self._upload(weights), mask)

    def _round_plan(self, round_idx: int, idxs, mask_host: np.ndarray):
        """Per-round host work that depends on the round index: the seed
        chain and every client's batch schedule, whose row indices go to
        the device in one copy."""
        cfg = self.config.train
        n_pad = mask_host.shape[1]
        bsz = cfg.batch_size or n_pad
        _, seeds, agg_seed = round_keys(self.config.seed, round_idx, idxs)
        scheds = [make_batch_schedule(n_pad, cfg.epochs, bsz, cfg.shuffle,
                                      s, m)
                  for s, m in zip(seeds, mask_host)]
        rows = torch.from_numpy(np.stack([s.batch_idx for s in scheds]))
        if self.device.type == "cuda":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        scheds = [s._replace(batch_idx=rows[i]) for i, s in enumerate(scheds)]
        return seeds, scheds, agg_seed

    def _pack_round(self, round_idx: int):
        """The full host side of one round (seeded sampling, pack, upload,
        seeds and schedules) as a pure function of the round index: the
        prefetcher's ``produce``. The dataset reference is snapshot once so
        a mid-run swap can never mix two datasets inside one payload."""
        ds = self.dataset
        idxs = sample_clients(round_idx, ds.client_num,
                              self.config.client_num_per_round,
                              delete_client=self.delete_client)
        x, y, mask, w, mask_host = self._pack_cohort(idxs, dataset=ds)
        seeds, scheds, agg_seed = self._round_plan(round_idx, idxs,
                                                   mask_host)
        return ds, idxs, (x, y, mask, w, seeds, scheds, agg_seed)

    def _prepare_round(self, round_idx: int):
        """Serial host side of a round, with the full-participation pack
        cache."""
        cfg = self.config
        idxs = sample_clients(round_idx, self.dataset.client_num,
                              cfg.client_num_per_round,
                              delete_client=self.delete_client)
        # the key holds a strong reference to the dataset object (a mid-run
        # swap must invalidate); only full participation is cached
        cohort = tuple(int(i) for i in idxs)
        if (self._pack_cache is not None
                and self._pack_cache[0] is self.dataset
                and self._pack_cache[1] == cohort):
            packed = self._pack_cache[2]
        else:
            self._pack_cache = None  # free the old buffers before packing
            packed = self._pack_cohort(idxs)
            if len(idxs) == self.dataset.client_num:
                self._pack_cache = (self.dataset, cohort, packed)
        x, y, mask, w, mask_host = packed
        seeds, scheds, agg_seed = self._round_plan(round_idx, idxs,
                                                   mask_host)
        return idxs, (x, y, mask, w, seeds, scheds, agg_seed)

    def _round_prefetcher(self):
        """The cohort prefetcher, or None when the serial path runs: depth
        0 or full participation (the resident ``_pack_cache`` already skips
        pack+upload there, except under delete_client)."""
        from fedml_tpu_torch.parallel.prefetch import (RoundPrefetcher,
                                                       bind_prefetcher,
                                                       resolve_prefetch_depth)
        depth = resolve_prefetch_depth(self.config.prefetch_depth)
        if (depth <= 0 or (self.config.client_num_per_round
                           >= self.dataset.client_num
                           and self.delete_client is None)):
            if self._prefetch is not None:
                self._prefetch[0].invalidate()
            return None
        self._prefetch = bind_prefetcher(
            self._prefetch, self.dataset,
            lambda: RoundPrefetcher(self._pack_round, depth,
                                    name="fedavg-cohort-prefetch"))
        return self._prefetch[0]

    def prefetch_stats(self):
        """Prefetcher counters (hits/misses/wait_s/hidden_s) or None when
        the serial path ran."""
        return self._prefetch[0].stats() if self._prefetch else None

    def release_prefetch(self):
        """Drop every speculative slot without stopping the worker."""
        if self._prefetch is not None:
            self._prefetch[0].invalidate()

    def _host_round_inputs(self, round_idx: int):
        """Pipelined-or-serial host inputs for one round. Speculation is
        clamped to ``comm_round`` so the last rounds pack nothing that is
        never consumed."""
        pf = self._round_prefetcher()
        if pf is None:
            out = self._prepare_round(round_idx)
            self.timer.update_rss()
            return out
        from fedml_tpu_torch.parallel.prefetch import consume
        _, idxs, args = consume(pf, round_idx, self.timer, self.dataset,
                                self._pack_round,
                                round_bound=self.config.comm_round)
        return idxs, args

    def _round_fn(self, variables, x, y, mask, weights, seeds, scheds,
                  agg_seed, round_idx: int):
        """One round on the device: every client's local training, then
        the aggregation hook. Returns ``(new_variables, stat totals)``."""
        lr_scale = round_lr_scale(self.config.train, round_idx)
        trained, stats = [], []
        for i, (seed, sched) in enumerate(zip(seeds, scheds)):
            v, s = self._local_train(variables, x[i], y[i], mask[i], seed,
                                     lr_scale=lr_scale, schedule=sched)
            trained.append(v)
            stats.append(s)
        totals = {k: torch.stack([s[k] for s in stats]).sum(0)
                  for k in stats[0]}
        new_vars = self._hook(variables, pt.tree_stack(trained), weights,
                              agg_seed)
        return new_vars, totals

    def run_round(self, round_idx: int):
        self.timer.begin_round(round_idx)
        idxs, (x, y, mask, weights, seeds, scheds, agg_seed) = \
            self._host_round_inputs(round_idx)
        with self.timer.phase("dispatch"):
            self.variables, stats = self._round_fn(
                self.variables, x, y, mask, weights, seeds, scheds,
                agg_seed, round_idx)
        self.timer.end_round(round_idx,
                             extra={"cohort": [int(i) for i in idxs]})
        return idxs, stats

    # -- the outer loop (reference fedavg_api.py:46-95) ---------------------
    def train(self) -> Dict:
        cfg = self.config
        t0 = time.time()
        for round_idx in range(cfg.comm_round):
            _, train_stats = self.run_round(round_idx)
            _progress_log.info("round %d/%d dispatched (wall %.1fs)",
                               round_idx + 1, cfg.comm_round,
                               time.time() - t0)
            last = round_idx == cfg.comm_round - 1
            if round_idx % cfg.frequency_of_the_test == 0 or last:
                # launches are asynchronous: drain the queued round in its
                # own phase so the eval timer measures eval
                with self.timer.phase("device_wait"):
                    synchronize(self.device)
                with self.timer.phase("eval"):
                    rec = self.evaluate(round_idx)
                # mean local-optimization loss this round (distinct from the
                # post-aggregation train_loss evaluate() reports)
                rec["train_loss_local"] = float(train_stats["loss_sum"]) / max(
                    1.0, float(train_stats["count"]))
                rec["wall_s"] = time.time() - t0
                rec.update({f"phase_{k}_ms": v * 1e3
                            for k, v in self.timer.means().items()})
                self.history.append(rec)
                logging.info("round %d: %s", round_idx, rec)
        return self.history[-1] if self.history else {}

    # -- evaluation over the global unions ----------------------------------
    def _eval_arrays(self):
        """Device-resident eval unions, uploaded once per dataset (with the
        optional seeded subsamples)."""
        if self._eval_cache is None or self._eval_cache[0] is not self.dataset:
            def upload(x, y):
                return (self._upload(np.ascontiguousarray(x)),
                        self._upload(np.ascontiguousarray(y)),
                        torch.ones(len(x), device=self.device))
            xg, yg = self.dataset.train_data_global
            train = upload(*eval_subsample(xg, yg,
                                           self.config.eval_train_subsample,
                                           self.config.seed))
            xt, yt = self.dataset.test_data_global
            test = (upload(*eval_subsample(xt, yt,
                                           self.config.eval_test_subsample,
                                           self.config.seed))
                    if len(xt) else None)
            self._eval_cache = (self.dataset, train, test)
        return self._eval_cache[1], self._eval_cache[2]

    def evaluate(self, round_idx: int) -> Dict:
        """Normalized federation metrics: {train,test}_{acc,loss,total} as
        means over the global train/test unions."""
        rec = {"round": round_idx}
        train, test = self._eval_arrays()
        rec.update(_normalized(self._eval_fn(self.variables, *train),
                               "train"))
        if test is not None:
            rec.update(_normalized(self._eval_fn(self.variables, *test),
                                   "test"))
        return rec
