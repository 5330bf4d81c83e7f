"""FedNova: federated normalized averaging (Wang et al., NeurIPS 2020).

The counterpart of ``fedml_tpu/algorithms/fednova.py``. Reference:
fedml_api/standalone/fednova/{fednova.py,fednova_trainer.py}. The client
runs a custom SGD that, per local step, applies momentum (dampening,
nesterov), weight decay and a proximal pull toward the round start,
accumulates ``cum_grad += lr * d_p`` and tracks the normalizing scalar
``a_i`` (fednova.py:96-151); the server recombines the normalized gradients
``ratio_i * cum_grad_i / a_i`` scaled by ``tau_eff = sum_i ratio_i * a_i``
(fednova.py:155-176, fednova_trainer.py:97-121), optionally through a
global momentum buffer (``gmf``).

``a_i`` counts real (non-padding) batches only, so clients of different
sizes take the different local step counts FedNova corrects for. The step
schedule is known on the host (trainer/functional.py), so the host skips
padding-only steps and computes the normalizers in float32 there, as the
JAX package's gated scan computes them on the device. The server's
combination ``sum_i (ratio_i / a_i) * cum_grad_i`` is a weighted sum over
the ``[clients, params]`` stack: FedAvg's weighted mean (the aggregation
kernel on a CUDA device) times the weights' sum. The collections (BatchNorm
statistics) move with each real step's train-mode forward, as the JAX
package carries them through its scan, and take FedAvg's mean with the
ratios.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (_normalized,
                                               device_weighted_mean)
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.sampling import (make_generator, round_keys,
                                           sample_clients)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.common import DropoutKey, init_params
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule,
                                                make_eval, make_forward,
                                                make_train_forward,
                                                next_colls)
from fedml_tpu_torch.trainer.tasks import TASK_HEADS
from fedml_tpu_torch.utils.device import resolve_device

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class FedNovaConfig:
    comm_round: int = 10
    client_num_per_round: int = 10
    frequency_of_the_test: int = 5
    seed: int = 0
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    gmf: float = 0.0  # global (server) momentum factor
    mu: float = 0.0  # proximal coefficient
    dampening: float = 0.0
    nesterov: bool = False


def make_fednova_local_train(module: torch.nn.Module, task: str,
                             cfg: FedNovaConfig):
    """Build ``local(params, colls, x, y, mask, schedule) -> (cum_grad,
    a_i, steps, colls, stats)``: the client side of FedNova over the
    real steps of ``schedule`` (a :class:`BatchSchedule` on the host).
    ``params``, ``cum_grad`` and the collections ``colls`` (as the last
    real step's forward left them) are ``{name: tensor}`` dicts; ``a_i``
    is a float32 and ``steps`` the count of real steps."""
    head = TASK_HEADS[task]
    forward = make_train_forward(module)
    eval_forward = make_forward(module)
    tc = cfg.train
    m, lr, etamu = tc.momentum, tc.lr, tc.lr * cfg.mu

    def local(params0: Dict[str, torch.Tensor], colls, x, y, mask,
              schedule):
        names = list(params0)
        p0 = [params0[n].detach() for n in names]
        params, buf = p0, [torch.zeros_like(p) for p in p0]
        cum = [torch.zeros_like(p) for p in p0]
        idx = torch.as_tensor(schedule.batch_idx, device=x.device)
        counter, a_i, steps, total = _F32(0), _F32(0), 0, None
        for s in np.flatnonzero(schedule.has_real):
            rows = idx[s]
            leaves = [p.requires_grad_(True) for p in
                      (q.detach() for q in params)]
            out, new_colls = forward(
                {**colls, **dict(zip(names, leaves))}, x[rows],
                DropoutKey(int(schedule.step_seeds[s])))
            stats = head(out, y[rows], mask[rows])
            grads = torch.autograd.grad(
                stats["loss_sum"] / stats["count"].clamp(min=1.0), leaves)
            with torch.no_grad():
                colls = next_colls(colls, new_colls)
                # d_p = grad + wd * p
                d_p = [g + tc.wd * p for g, p in zip(grads, params)]
                if m:
                    # buf = m * buf + (1 - dampening) * d_p, except that the
                    # first real step sets buf = d_p (fednova.py:112-117)
                    buf = (d_p if steps == 0 else
                           [m * b + (1.0 - cfg.dampening) * d
                            for b, d in zip(buf, d_p)])
                    d_p = ([d + m * b for d, b in zip(d_p, buf)]
                           if cfg.nesterov else buf)
                if cfg.mu:  # the proximal pull toward the round start
                    d_p = [d + cfg.mu * (p - q)
                           for d, p, q in zip(d_p, params, p0)]
                cum = [c + lr * d for c, d in zip(cum, d_p)]
                params = [p - lr * d for p, d in zip(params, d_p)]
            # the normalizer's recurrence (fednova.py:139-151), in float32
            counter = _F32(counter * _F32(m) + _F32(1.0))
            new_a = _F32(a_i + counter) if m else a_i
            if etamu:
                new_a = _F32(new_a * _F32(1.0 - etamu) + _F32(1.0))
            a_i = new_a if (m or etamu) else _F32(a_i + _F32(1.0))
            steps += 1
            stats = {k: v.detach() for k, v in stats.items()}
            total = stats if total is None else {
                k: total[k] + stats[k] for k in total}
        if total is None:  # no real row: zero stats
            with torch.no_grad():
                total = {k: torch.zeros_like(v) for k, v in head(
                    eval_forward({**colls, **params0}, x[:1], False), y[:1],
                    torch.zeros_like(mask[:1])).items()}
        return dict(zip(names, cum)), a_i, steps, colls, total

    return local


class FedNovaAPI:
    """Standalone FedNova simulation (parity: FedNovaTrainer.train).
    ``device`` defaults to CUDA and raises when no GPU is present."""

    def __init__(self, dataset: FederatedDataset, module: torch.nn.Module,
                 task: str = "classification",
                 config: Optional[FedNovaConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.module = module
        self.config = config or FedNovaConfig()
        cfg = self.config
        if cfg.train.lr_decay_round != 1.0:
            raise NotImplementedError(
                "lr_decay_round is not threaded through FedNova's "
                "normalized-gradient local program; use fedavg/fedopt for "
                "the round schedule")
        self._local = make_fednova_local_train(module, task, cfg)
        self._eval_fn = make_eval(module, task)
        self._mean = device_weighted_mean(self.device)
        init_params(module.cpu(), make_generator(cfg.seed))
        self.variables = {k: v.detach().clone().to(self.device)
                          for k, v in module.state_dict().items()}
        module.to(self.device)
        self._param_names = [n for n, _ in module.named_parameters()]
        self.momentum_buf = pt.tree_zeros_like(
            {n: self.variables[n] for n in self._param_names})
        self.history: List[Dict] = []

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def run_round(self, round_idx: int):
        cfg, tc, ds = self.config, self.config.train, self.dataset
        idxs = sample_clients(round_idx, ds.client_num,
                              cfg.client_num_per_round)
        # each round pads to its cohort's bucket; a_i counts only real
        # batches, so the padding changes no number
        n_pad = ds.cohort_padded_len(idxs, tc.batch_size)
        x, y, mask_host = ds.pack_clients(idxs, tc.batch_size, n_pad=n_pad)
        counts = ds.client_weights(idxs)
        ratios = counts / counts.sum()  # ratio_i = n_i / round_sample_num
        x, y, mask = (self._upload(a) for a in (x, y, mask_host))
        _, seeds, _ = round_keys(cfg.seed, round_idx, idxs)
        params = {n: self.variables[n] for n in self._param_names}
        buffers = {k: v for k, v in self.variables.items()
                   if k not in params}
        cums, a_is, steps, colls, stats = [], [], [], [], []
        for i, seed in enumerate(seeds):
            sched = make_batch_schedule(n_pad, tc.epochs,
                                        tc.batch_size or n_pad, tc.shuffle,
                                        seed, mask_host[i])
            out = self._local(params, buffers, x[i], y[i], mask[i], sched)
            for acc, v in zip((cums, a_is, steps, colls, stats), out):
                acc.append(v)
        a_is = np.asarray(a_is, _F32)
        # tau_eff = sum_i ratio_i * (steps_i under the proximal term, else
        # a_i); cum_grad = tau_eff * sum_i (ratio_i / a_i) * cum_grad_i
        tau = np.asarray(steps, _F32) if cfg.mu else a_is
        tau_eff = _F32(np.sum(ratios * tau, dtype=_F32))
        w = (ratios / a_is).astype(_F32)
        mean = self._mean(pt.tree_stack(cums), self._upload(w))
        scale = float(tau_eff * _F32(np.sum(w, dtype=_F32)))
        cum_grad = pt.tree_scale(mean, scale)
        with torch.no_grad():
            if cfg.gmf:
                self.momentum_buf = {
                    k: cfg.gmf * b + cum_grad[k] / tc.lr
                    for k, b in self.momentum_buf.items()}
                new_params = {k: p - tc.lr * self.momentum_buf[k]
                              for k, p in params.items()}
            else:
                new_params = pt.tree_sub(params, cum_grad)
        new_colls = (self._mean(pt.tree_stack(colls), self._upload(ratios))
                     if buffers else {})
        self.variables = {k: new_params[k] if k in new_params
                          else new_colls[k] for k in self.variables}
        totals = {k: torch.stack([s[k] for s in stats]).sum(0)
                  for k in stats[0]}
        return idxs, totals

    def evaluate(self, round_idx: int) -> Dict:
        rec = {"round": round_idx}
        xt, yt = self.dataset.test_data_global
        if len(xt):
            rec.update(_normalized(self._eval_fn(
                self.variables, self._upload(xt), self._upload(yt),
                torch.ones(len(xt), device=self.device)), "test"))
        return rec

    def train(self) -> Dict:
        cfg = self.config
        for round_idx in range(cfg.comm_round):
            self.run_round(round_idx)
            last = round_idx == cfg.comm_round - 1
            if round_idx % cfg.frequency_of_the_test == 0 or last:
                self.history.append(self.evaluate(round_idx))
        return self.history[-1] if self.history else {}
