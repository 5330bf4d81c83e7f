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

:class:`FusedRounds` (``api.fused_rounds()``) runs R rounds per dispatch,
the counterpart of the JAX package's ``lax.scan`` over rounds: on a CUDA
device each round is one replay of a captured CUDA graph
(parallel/graphs.py), with the host only filling its input buffers in
between; on the CPU the same round body runs in a plain loop.

With ``config.obs_dir`` set, the host loop writes the flight recorder's
per-round timeline (``fedml_tpu_torch/obs``): a ``round`` record a round
and a ``perf`` record with its MFU, whose FLOP count is probed once, on
fake tensors, from the round about to dispatch (utils/flops.py). It is a
pure observer: the trajectory is the same bits with it off.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.sampling import (AGG_KEY_SENTINEL,
                                           device_round_key,
                                           device_sample_clients,
                                           eval_subsample, fold32,
                                           make_generator, round_keys,
                                           sample_clients)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.parallel.graphs import CapturedRound, GraphCache
from fedml_tpu_torch.trainer.functional import (BatchSchedule, TrainConfig,
                                                device_batch_schedule,
                                                make_batch_schedule,
                                                make_eval, make_local_train,
                                                round_lr_scale,
                                                round_lr_scales,
                                                stack_schedules,
                                                validate_accum_steps)
from fedml_tpu_torch.utils.device import resolve_device, synchronize
from fedml_tpu_torch.utils.tracing import RoundTimer

#: per-round heartbeat for long host loops, on its own logger so callers
#: can silence it alone
_progress_log = logging.getLogger("fedml_tpu_torch.progress")

#: the perf records' ``flops_source``: the port's dispatch-level count
FLOPS_SOURCE = "analytic_aten_dispatch"


def _normalized(stats, prefix: str) -> Dict[str, float]:
    """Stat sums -> {prefix}_{acc,loss,total} means."""
    total = max(1.0, float(stats["count"]))
    return {
        f"{prefix}_acc": float(stats["correct_sum"]) / total,
        f"{prefix}_loss": float(stats["loss_sum"]) / total,
        f"{prefix}_total": float(stats["count"]),
    }


def device_weighted_mean(device: torch.device):
    """The sample-weighted state-dict mean ``mean(stacked, weights)`` that
    the FedAvg family aggregates with on ``device``: on a CUDA device the
    hand-written kernel over the whole ``[clients, params]`` stack, one
    launch (ops/aggregate.py); on the CPU the plain per-leaf mean."""
    if device.type == "cuda":
        from fedml_tpu_torch.ops.aggregate import tree_weighted_mean_fused
        return tree_weighted_mean_fused
    return pt.tree_weighted_mean


@dataclasses.dataclass(frozen=True)
class FedAvgConfig:
    """Round-level knobs (reference argparse: --comm_round
    --client_num_in_total --client_num_per_round --frequency_of_the_test);
    the fields of ``fedml_tpu.algorithms.fedavg.FedAvgConfig``."""

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
    # observability (fedml_tpu_torch/obs): directory for the flight
    # recorder's per-round timeline (flight_rank0.jsonl), its perf records
    # (MFU) and anomaly-armed one-shot profiles. None (default) = off; on,
    # it is a pure observer: trajectories stay bit-exact
    obs_dir: Optional[str] = None
    # flight-record correlation id; unset derives a collision-safe
    # "sim-<8 hex>" per run (obs.default_job_id)
    job_id: Optional[str] = None
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
        if self.config.pack not in ("cohort", "global"):
            raise ValueError(f"unknown pack policy: {self.config.pack!r}")
        cfg = self.config.train
        self._local_train = make_local_train(module, task, cfg)
        validate_accum_steps(cfg, dataset.train_data_local_num_dict)
        self._mean = device_weighted_mean(self.device)
        if aggregate_hook is not None:
            self._hook = aggregate_hook
        else:
            def hook(variables, stacked, weights, agg_seed):
                return self._mean(stacked, weights)
            self._hook = hook
        self._eval_fn = make_eval(module, task)
        self._n_pad = dataset.padded_len(cfg.batch_size)

        # initialize on the CPU from the seed, so every device starts from
        # the same weights (a template an earlier API moved to the card
        # comes back first)
        init_params(module.cpu(), make_generator(self.config.seed))
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
        # observability (fedml_tpu_torch/obs): the flight recorder, the
        # slow-round profiler and the MFU accountant; config.obs_dir None
        # (default) keeps it fully off
        from fedml_tpu_torch.obs import build_observability, default_job_id
        self._obs = build_observability(
            self.config.obs_dir,
            # collision-safe default: two unconfigured runs sharing an obs
            # dir must not interleave under one literal id
            job_id=self.config.job_id or default_job_id("sim"),
            rank=0, role="server", perf_device=self.device)
        if self._obs is not None:
            self._obs.bind_timer(self.timer)
        # the round-FLOP count's parts, per round shape (_round_flops)
        self._flops_parts: Dict[tuple, tuple] = {}

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

    def _client_plans(self, round_idx: int, idxs, mask_host: np.ndarray):
        """Per-round host work that depends on the round index: the seed
        chain and every client's batch schedule, stacked ``[k, steps,
        ...]`` (numpy). Returns ``(plan, agg_seed)``."""
        cfg = self.config.train
        n_pad = mask_host.shape[1]
        bsz = cfg.batch_size or n_pad
        _, seeds, agg_seed = round_keys(self.config.seed, round_idx, idxs)
        plan = stack_schedules([
            make_batch_schedule(n_pad, cfg.epochs, bsz, cfg.shuffle, s, m,
                                cfg.accum_steps)
            for s, m in zip(seeds, mask_host)])
        return plan, agg_seed

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """An upload that does not wait: pinned and non-blocking on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _round_plan(self, round_idx: int, idxs, mask_host: np.ndarray):
        """The round's plan for the host loop: the row indices and the
        accumulation flags on the device, in one copy each; ``has_real``
        and the step seeds stay on the host, which skips padding-only steps
        and hashes dropout's site keys there."""
        plan, agg_seed = self._client_plans(round_idx, idxs, mask_host)
        return plan._replace(**{
            f: self._to_device(getattr(plan, f))
            for f in ("batch_idx", "emit", "acc_div")}), agg_seed

    def _pack_round(self, round_idx: int):
        """The full host side of one round (seeded sampling, pack, upload,
        schedules) as a pure function of the round index: the prefetcher's
        ``produce``. The dataset reference is snapshot once so a mid-run
        swap can never mix two datasets inside one payload."""
        ds = self.dataset
        idxs = sample_clients(round_idx, ds.client_num,
                              self.config.client_num_per_round,
                              delete_client=self.delete_client)
        x, y, mask, w, mask_host = self._pack_cohort(idxs, dataset=ds)
        plan, agg_seed = self._round_plan(round_idx, idxs, mask_host)
        return ds, idxs, (x, y, mask, w, plan, agg_seed)

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
        plan, agg_seed = self._round_plan(round_idx, idxs, mask_host)
        return idxs, (x, y, mask, w, plan, agg_seed)

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

    def _round_fn(self, variables, x, y, mask, weights, plan: BatchSchedule,
                  agg_seed, lr_scale=None, gated: bool = False):
        """One round on the device: every client's local training, then
        the aggregation hook. Returns ``(new_variables, stat totals)``.
        ``plan`` is the clients' stacked :class:`BatchSchedule`;
        ``lr_scale`` a 0-dim f32 tensor or None. ``gated`` runs every step
        of the schedule behind its device-side gate (the fused driver's
        capturable body) instead of skipping padding-only steps on the
        host; the two give the same bits."""
        trained, stats = [], []
        for i in range(x.shape[0]):
            v, s = self._local_train(variables, x[i], y[i], mask[i], None,
                                     lr_scale=lr_scale, schedule=plan.at(i),
                                     gated=gated)
            trained.append(v)
            stats.append(s)
        totals = {k: torch.stack([s[k] for s in stats]).sum(0)
                  for k in stats[0]}
        new_vars = self._hook(variables, pt.tree_stack(trained), weights,
                              agg_seed)
        return new_vars, totals

    def run_round(self, round_idx: int):
        # flight-recorder round boundary (a pure observer: no RNG, no
        # schedule effect; two dict copies when no recorder is bound)
        self.timer.begin_round(round_idx)
        if self._obs is not None:
            self._obs.round_begin(round_idx)
        idxs, (x, y, mask, weights, plan, agg_seed) = \
            self._host_round_inputs(round_idx)
        lr_scale = round_lr_scale(self.config.train, round_idx, self.device)
        variables = self.variables
        with self.timer.phase("dispatch"):
            stats = self._dispatch(x, y, mask, weights, plan, agg_seed,
                                   lr_scale)
        rec = self.timer.end_round(
            round_idx, extra={"cohort": [int(i) for i in idxs]})
        if self._obs is not None:
            # the roofline count of the round just dispatched, taken after
            # its wall closed (it reads shapes only: nothing launches, no
            # RNG is drawn, no state is written)
            self._obs.probe_round_flops(
                lambda: self._round_flops(variables, x, y, mask, weights,
                                          plan, agg_seed, lr_scale),
                source=FLOPS_SOURCE)
            self._obs.round_end(round_idx,
                                rec["duration_s"] if rec else None,
                                record=rec)
        return idxs, stats

    def _round_flops(self, variables, x, y, mask, weights, plan,
                     agg_seed, lr_scale) -> float:
        """The analytic FLOPs (utils/flops.py) of one host-loop round as it
        runs: every real step, the padding-only ones skipped, and the
        aggregation. For its shapes a round bills a fixed close and, for
        each client, one step program a real step (after the first, with
        one add of its stats), so a client's ``n`` real steps bill ``f(n)
        = f(1) + (n - 1) * (f(2) - f(1))`` for ``n >= 1`` and the round
        ``R0 + sum_i (f(n_i) - f(0))``, where ``R0`` is the round with no
        real step. Those counts are taken on fake tensors once a round
        shape (three client steps and no round step): a later round of
        the same shapes costs a sum."""
        from fedml_tpu_torch.utils.flops import analytic_flops
        has_real = np.asarray(plan.has_real, bool)
        key = (tuple(x.shape), tuple(y.shape), has_real.shape,
               lr_scale is None)
        parts = self._flops_parts.get(key)
        if parts is None:
            client = plan.at(0)

            def client_flops(n: int) -> float:
                cut = np.zeros_like(has_real[0])
                cut[:n] = True
                return analytic_flops(
                    self._local_train, variables, x[0], y[0], mask[0], None,
                    lr_scale=lr_scale, schedule=client._replace(has_real=cut))
            r0 = analytic_flops(self._round_fn, variables, x, y, mask,
                                weights,
                                plan._replace(has_real=np.zeros_like(
                                    has_real)),
                                agg_seed, lr_scale)
            parts = (r0, [client_flops(n) for n in
                          range(min(3, has_real.shape[1] + 1))])
            self._flops_parts[key] = parts
        r0, f = parts
        return r0 + sum((f[n] if n <= 2 else f[2] + (n - 2) * (f[2] - f[1]))
                        - f[0] for n in map(int, has_real.sum(1)))

    def _dispatch(self, x, y, mask, weights, plan, agg_seed, lr_scale):
        """Run one round's device work on the server state and return its
        stats (subclasses carrying more server state override this)."""
        self.variables, stats = self._round_fn(
            self.variables, x, y, mask, weights, plan, agg_seed, lr_scale)
        return stats

    def fused_rounds(self, device_sampling: bool = False) -> "FusedRounds":
        """The fused multi-round driver PAIRED with this API class
        (subclasses fusing richer server state override
        ``_fused_driver_cls``; subclasses whose round leaves the device set
        it to None); construct through here so an API is never mispaired
        with a driver that drops its server state."""
        if self._fused_driver_cls is None:
            raise TypeError(
                f"{type(self).__name__} cannot fuse rounds: its round has a "
                "host-side stage that cannot run inside a captured round")
        if self._obs is not None:
            # per-round boundaries do not exist inside a fused block: say
            # so instead of leaving an empty timeline to be discovered
            logging.warning(
                "observability is on but the fused multi-round driver "
                "dispatches whole round BLOCKS: the flight log gets no "
                "per-round records (and the slow-round detector no "
                "durations) for fused spans; use the host round loop "
                "for per-round timelines")
        return self._fused_driver_cls(self, device_sampling)

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


class FusedRounds:
    """Multi-round driver: R FedAvg rounds per dispatch, the counterpart of
    the JAX package's ``FusedRounds`` (``lax.scan`` over rounds). On a CUDA
    device one round's device work is captured once as a CUDA graph
    (parallel/graphs.py) and replayed R times, with the aggregation kernel
    inside it; the host only fills the graph's input buffers between
    replays and never waits. On a CPU device the same round body runs in a
    plain loop. Either way the round body is the host loop's
    (``FedAvgAPI._round_fn``) with every step of the schedule run behind
    its device-side gate, so the trajectory is the host loop's, bit for
    bit. Three modes:

    - **block** (partial participation, the default): the R cohorts are
      drawn on the host with the host loop's ``sample_clients`` (honouring
      ``delete_client``), packed as one ``[R, k, n_pad, ...]`` block at the
      block's cohort bucket (or the global pad under ``pack="global"``)
      and uploaded with their schedules;
    - **full** (``client_num_per_round == client_num``): the federation is
      packed and uploaded once; each block uploads its rounds' schedules;
    - **device** (``device_sampling=True``): the federation is resident and
      each round draws its cohort and every client's batch order on the
      device (core/sampling.py ``device_sample_clients``,
      trainer/functional.py ``device_batch_schedule``): no host work per
      round, but that mode's own sampling stream, not the host loop's.

    Graphs are cached by the shapes of their inputs (the pad bucket, k and
    the step count), at most ``graph_capacity`` at once. Stats come back
    stacked ``[R, ...]``."""

    graph_capacity = 4

    def __init__(self, api: FedAvgAPI, device_sampling: bool = False):
        if (api._fused_driver_cls is None
                or type(self) is not api._fused_driver_cls):
            # exact type: a subclass driver on a base API would pass an
            # isinstance check and fail deep in _round on missing state
            want = (api._fused_driver_cls.__name__
                    if api._fused_driver_cls else "no fused driver")
            raise TypeError(
                f"{type(api).__name__} pairs with {want} "
                f"(use api.fused_rounds()), not {type(self).__name__}")
        self.api = api
        cfg, ds = api.config, api.dataset
        self.k = min(cfg.client_num_per_round, ds.client_num)
        self.N = ds.client_num
        self.mode = ("device" if device_sampling
                     else "full" if self.k == self.N else "block")
        if api.delete_client is not None and self.mode != "block":
            raise ValueError(
                "full/device-sampled fused rounds do not honor "
                "delete_client (the cohort covers all clients or is drawn "
                "on the device); block mode (partial participation) "
                "samples on the host and honors it")
        if self.mode in ("full", "device"):
            # the federation resident on the device, packed once at the
            # global pad
            pool = np.arange(self.N)
            x, y, mask = ds.pack_clients(pool, cfg.train.batch_size,
                                         n_pad=api._n_pad)
            self._mask_host = mask
            self._data = tuple(api._upload(a) for a in (
                x, y, mask, ds.client_weights(pool)))
        else:
            self._data = None  # block mode packs per run_rounds call
        self.graphs = GraphCache(self.graph_capacity)

    # -- the host side of a block -------------------------------------------
    def _block_inputs(self, r0: int, rounds: int):
        """One block's inputs with a leading ``[R]`` axis, uploaded in one
        copy each: block mode packs the R cohorts drawn with the host
        loop's sampling stream as one ``[R, k, n_pad, ...]`` batch at the
        block's cohort bucket; full mode builds the rounds' schedules for
        the resident federation; device mode uploads only the round
        indices. Every mode adds the rounds' LR scales (or None)."""
        api, cfg, ds = self.api, self.api.config, self.api.dataset
        rs = np.arange(r0, r0 + rounds)
        scales = round_lr_scales(cfg.train, rs)
        lr = None if scales is None else api._to_device(scales)
        if self.mode == "device":
            return {"round": api._to_device(rs.astype(np.int64)),
                    "lr_scale": lr}
        if self.mode == "block":
            bsz = cfg.train.batch_size
            cohorts = [sample_clients(r, self.N, self.k,
                                      delete_client=api.delete_client)
                       for r in rs]
            flat = np.concatenate([np.asarray(c) for c in cohorts])
            n_pad = (max(ds.cohort_padded_len(c, bsz) for c in cohorts)
                     if cfg.pack == "cohort" else api._n_pad)
            x, y, mask = ds.pack_clients(flat, bsz, n_pad=n_pad)
            lead = (rounds, self.k)
            data = {"x": x.reshape(lead + x.shape[1:]),
                    "y": y.reshape(lead + y.shape[1:]),
                    "mask": mask.reshape(lead + mask.shape[1:]),
                    "weights": ds.client_weights(flat).reshape(lead)}
            masks = data["mask"]
        else:
            cohorts = [np.arange(self.N)] * rounds
            data, masks = {}, [self._mask_host] * rounds
        plans = [api._client_plans(r, c, m)
                 for r, c, m in zip(rs, cohorts, masks)]
        out = {k: api._to_device(a) for k, a in data.items()}
        out["plan"] = BatchSchedule(*(api._to_device(np.stack(f)) for f in
                                      zip(*(p for p, _ in plans))))
        out["agg_seed"] = api._to_device(np.array([a for _, a in plans],
                                                  dtype=np.int64))
        out["lr_scale"] = lr
        return out

    def _round_inputs(self, block, r: int) -> tuple:
        """Round ``r`` of a block as the arguments of :meth:`_step`."""
        def at(v):
            return None if v is None else pytree.tree_map(lambda t: t[r], v)
        if self.mode == "device":
            return (at(block["round"]), at(block["lr_scale"]))
        data = (self._data if self.mode == "full" else
                tuple(at(block[k]) for k in ("x", "y", "mask", "weights")))
        return (*data, at(block["plan"]), at(block["agg_seed"]),
                at(block["lr_scale"]))

    # -- carry protocol: subclasses fusing richer server state (e.g.
    #    FedOpt's optimizer) override these three -------------------------
    def _init_carry(self):
        return self.api.variables

    def _store_carry(self, carry) -> None:
        self.api.variables = carry

    def _round(self, carry, x, y, mask, weights, plan, agg_seed, lr_scale):
        """One round on the carry: the host loop's round body with every
        step gated on the device. Returns ``(new_carry, stats)``."""
        return self.api._round_fn(carry, x, y, mask, weights, plan,
                                  agg_seed, lr_scale, gated=True)

    def _step(self, carry, *args):
        if self.mode != "device":
            return self._round(carry, *args)
        # device sampling: the cohort, its data and its schedules from the
        # round index alone, on the device
        r, lr_scale = args
        cfg = self.api.config
        x_all, y_all, mask_all, w_all = self._data
        rk = device_round_key(cfg.seed, r)
        if self.k == self.N:
            idx = torch.arange(self.N, device=x_all.device)
        else:
            idx = device_sample_clients(rk, self.N, self.k)
        x, y, mask, w = (a.index_select(0, idx)
                         for a in (x_all, y_all, mask_all, w_all))
        tc = cfg.train
        plan = device_batch_schedule(
            fold32(rk, idx), mask, tc.epochs, tc.batch_size or x.shape[1],
            tc.shuffle, tc.accum_steps)
        return self._round(carry, x, y, mask, w, plan,
                           fold32(rk, AGG_KEY_SENTINEL), lr_scale)

    # -- dispatch ------------------------------------------------------------
    def _run_loop(self, block, rounds: int):
        carry, out = self._init_carry(), []
        for r in range(rounds):
            carry, stats = self._step(carry, *self._round_inputs(block, r))
            out.append(stats)
        return carry, {k: torch.stack([s[k] for s in out]) for k in out[0]}

    def _capture(self, args, carry_leaves, carry_spec) -> CapturedRound:
        """Capture one round. Its static inputs are copies of ``args``
        (the resident federation is used in place), its carry copies of
        ``carry_leaves``."""
        leaves, spec = pytree.tree_flatten(args)
        resident = {id(t) for t in self._data or ()}
        static = [t.clone() if torch.is_tensor(t) and id(t) not in resident
                  else t for t in leaves]
        carry = [t.clone() for t in carry_leaves]

        def fn(*flat):
            new_carry, stats = self._step(
                pytree.tree_unflatten(carry, carry_spec),
                *pytree.tree_unflatten(list(flat), spec))
            return pytree.tree_flatten(new_carry)[0], stats

        with self.api.timer.phase("capture"):
            return CapturedRound(fn, static, carry)

    def _run_graph(self, block, rounds: int):
        carry_leaves, carry_spec = pytree.tree_flatten(self._init_carry())
        args = self._round_inputs(block, 0)
        leaves = pytree.tree_flatten(args)[0]
        key = (self.mode, tuple((tuple(t.shape), t.dtype) if
                                torch.is_tensor(t) else t for t in leaves))
        graph = self.graphs.get(
            key, lambda: self._capture(args, carry_leaves, carry_spec))
        for dst, src in zip(graph.carry, carry_leaves):
            dst.copy_(src)
        stats = {k: torch.empty((rounds,) + tuple(v.shape), dtype=v.dtype,
                                device=v.device)
                 for k, v in graph.outputs.items()}
        for r in range(rounds):
            if r:
                leaves = pytree.tree_flatten(self._round_inputs(block, r))[0]
            for dst, src in zip(graph.inputs, leaves):
                if torch.is_tensor(dst) and dst is not src:
                    dst.copy_(src)
            graph.replay()
            for k, v in graph.outputs.items():
                stats[k][r].copy_(v)
        # a clone: the next replay overwrites the static carry
        carry = pytree.tree_unflatten([t.clone() for t in graph.carry],
                                      carry_spec)
        return carry, stats

    def run_rounds(self, r0: int, rounds: int):
        """Advance the api's model by ``rounds`` fused rounds starting at
        round index ``r0``; returns the rounds' stat totals stacked
        ``[rounds, ...]``."""
        api = self.api
        with api.timer.phase("pack"):
            block = self._block_inputs(r0, rounds)
        with api.timer.phase("dispatch"):
            run = (self._run_graph if api.device.type == "cuda"
                   else self._run_loop)
            carry, stats = run(block, rounds)
        self._store_carry(carry)
        return stats

    def cost_analysis(self, r0: int = 0, rounds: int = 1) -> Dict:
        """``{"flops", "bytes accessed", "flops_by_class"}`` of the block
        that :meth:`run_rounds` replays, whole-block totals (divide by
        ``rounds`` for per-round figures): the analytic count
        (utils/flops.py) of the block's first round through the gated
        round body, every padding-only step included, times ``rounds``.
        The block replays one captured round: its rounds have the same
        shapes and a gated round's count depends on shapes alone (as XLA
        bills a scan's body times its length). Nothing launches; bytes are
        counted before fusion. The host round's count (the padding-only
        steps skipped) is the perf record's ``round_flops``: without
        padding-only steps the two agree in matmul/conv FLOPs and differ
        by the gates' selects; with them, the gap is the padding's share
        of the fused work."""
        from fedml_tpu_torch.utils.flops import cost_analysis
        block = self._block_inputs(r0, rounds)
        one = cost_analysis(lambda args: self._step(self._init_carry(),
                                                    *args),
                            self._round_inputs(block, 0))
        return {"flops": one["flops"] * rounds,
                "bytes accessed": one["bytes accessed"] * rounds,
                "flops_by_class": {k: v * rounds for k, v in
                                   one["flops_by_class"].items()}}

    def train(self, max_rounds_per_dispatch: Optional[int] = None) -> Dict:
        """The ``FedAvgAPI.train`` loop with the rounds fused between eval
        points: records after rounds 0, freq, 2*freq, ... and the last
        round, as the host loop's; ``max_rounds_per_dispatch`` caps the
        rounds of one dispatch (the ``--fused_rounds`` value); None fuses
        each whole eval interval."""
        api, cfg = self.api, self.api.config
        if cfg.comm_round <= 0:
            return api.history[-1] if api.history else {}
        freq = cfg.frequency_of_the_test
        t0 = time.time()
        evals = sorted(set(range(0, cfg.comm_round, freq))
                       | {cfg.comm_round - 1})
        r = 0
        for e in evals:
            stats = None
            while r <= e:
                chunk = e + 1 - r
                if max_rounds_per_dispatch:
                    chunk = min(chunk, max_rounds_per_dispatch)
                stats = self.run_rounds(r, chunk)
                r += chunk
                _progress_log.info("fused rounds %d/%d dispatched (wall "
                                   "%.1fs)", r, cfg.comm_round,
                                   time.time() - t0)
            with api.timer.phase("device_wait"):
                synchronize(api.device)
            with api.timer.phase("eval"):
                rec = api.evaluate(r - 1)
            rec["train_loss_local"] = (
                float(stats["loss_sum"][-1])
                / max(1.0, float(stats["count"][-1])))
            rec["wall_s"] = time.time() - t0
            rec.update({f"phase_{k}_ms": v * 1e3
                        for k, v in api.timer.means().items()})
            api.history.append(rec)
            logging.info("fused round %d: %s", r - 1, rec)
        return api.history[-1] if api.history else {}


# the paired fused driver (set once both classes exist); subclasses fusing
# more server state override this attribute
FedAvgAPI._fused_driver_cls = FusedRounds
