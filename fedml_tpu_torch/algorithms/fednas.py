"""FedNAS: federated architecture search over the DARTS space. The
counterpart of ``fedml_tpu/algorithms/fednas.py``.

Reference (fedml_api/distributed/fednas/): each round every client
alternates an architecture step (the val batch's gradient on the alphas,
``Architect.step``, model/cv/darts/architect.py:13) with a weight step (a
train batch's SGD, FedNASTrainer.search, FedNASTrainer.py:34-90); the
server takes the sample-weighted mean of BOTH the weights and the alphas
(FedNASAggregator.__aggregate_weight :71, __aggregate_alpha :95) and logs
the derived genotype each round (record_model_global_architecture :173).

Every client trains every round, one after another on the device, from
the round's global weights and alphas with fresh optimizer states: the
weights SGD with momentum 0.9 and weight decay (``add_decayed_weights``
first), the alphas Adam with ``b1 = 0.5`` and an L2 ``arch_wd`` added to
the gradient before Adam (not AdamW). In each step the architecture step
on the val batch (``roll(batches, 1)``: the previous train batch) comes
first, with its BatchNorm statistics dropped, and the weight step uses the
updated alphas. ``arch_unrolled`` takes the alphas' gradient at the
one-step lookahead ``w - lr * grad_w L_train(w, a)``, differentiated
exactly through the virtual step (``create_graph=True``) where the
reference uses finite differences. Every batch of the permutation is a
step, padding-only ones too, as in the JAX package's scan.

The round's weights, BatchNorm statistics and both alphas go through one
sample-weighted mean: on a CUDA device one launch of the aggregation
kernel over the whole ``[clients, D]`` stack
(``ops/aggregate.tree_weighted_mean_fused``), on the CPU the plain mean.

The batch orders, and GDAS's uniform draws, are inputs of
:meth:`FedNASAPI.run_round`: by default ``torch.randperm`` and
``torch.rand`` from a generator seeded ``derive_seed(seed, round, c)``,
not the JAX package's ``jax.random`` streams; a test passes in the values
the JAX package drew.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.algorithms.fedavg import device_weighted_mean
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.sampling import derive_seed, make_generator
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.models.darts import (DartsNetwork, gdas_tau,
                                          gumbel_softmax_weights,
                                          init_alphas, parse_genotype)
from fedml_tpu_torch.trainer.functional import (decayed_adam, decayed_sgd,
                                                make_train_forward,
                                                next_colls, param_names)
from fedml_tpu_torch.utils.device import resolve_device

#: the alphas' names in the aggregated stack
ALPHA_KEYS = ("alphas.normal", "alphas.reduce")
#: rows of one eval-mode forward in :meth:`FedNASAPI.evaluate`
EVAL_BATCH = 512
#: the weights' and the alphas' L2 terms (reference --weight_decay,
#: --arch_weight_decay)
WEIGHT_DECAY = 3e-4
ARCH_WEIGHT_DECAY = 1e-3


@dataclasses.dataclass(frozen=True)
class FedNASConfig:
    comm_round: int = 5
    epochs: int = 1
    batch_size: int = 16
    lr: float = 0.025           # weight SGD (reference --learning_rate)
    arch_lr: float = 3e-4       # alpha Adam (reference --arch_learning_rate)
    seed: int = 0
    # "darts": the soft mixture (model_search.py); "gdas": the hard
    # gumbel-softmax single-path sample with ST gradients
    # (model_search_gdas.py)
    variant: str = "darts"
    # second-order DARTS (reference --arch_unrolled, Architect.step
    # architect.py:28-60)
    arch_unrolled: bool = False


def _grad(loss, leaves, create_graph=False):
    """``torch.autograd.grad`` with a zero gradient for a leaf the loss does
    not reach (the normal cells' alphas of a network whose every cell
    reduces), as ``jax.grad`` gives."""
    grads = torch.autograd.grad(loss, leaves, create_graph=create_graph,
                                allow_unused=True)
    return [torch.zeros_like(a) if g is None else g
            for a, g in zip(leaves, grads)]


def _masked_ce(logits, y, m):
    ce = F.cross_entropy(logits, y, reduction="none")
    return (ce * m).sum() / m.sum().clamp(min=1.0)


class FedNASAPI:
    """The standalone simulation: every client's search, then the weighted
    mean of weights and alphas. The weights come from a generator seeded
    ``seed``, the alphas from ``np.random.RandomState(seed)``, the JAX
    package's numpy stream (``init_alphas``)."""

    def __init__(self, dataset: FederatedDataset, model: DartsNetwork,
                 config: Optional[FedNASConfig] = None, device="cuda"):
        self.ds = dataset
        self.model = model
        self.cfg = cfg = config or FedNASConfig()
        self.device = resolve_device(device)
        if cfg.variant not in ("darts", "gdas"):
            raise ValueError(f"unknown FedNAS variant: {cfg.variant!r}")
        an, ar = init_alphas(model.steps, np.random.RandomState(cfg.seed))
        self.alphas = {"normal": torch.as_tensor(an, device=self.device),
                       "reduce": torch.as_tensor(ar, device=self.device)}
        init_params(model.cpu(), make_generator(cfg.seed))
        self.variables = {k: v.detach().clone().to(self.device)
                          for k, v in model.state_dict().items()}
        model.to(self.device)
        self._trained = param_names(model)
        self._train_forward = make_train_forward(model)
        self._opt_w = decayed_sgd(cfg.lr, 0.9, WEIGHT_DECAY)
        self._opt_a = decayed_adam(cfg.arch_lr, ARCH_WEIGHT_DECAY, b1=0.5)
        self._mean = device_weighted_mean(self.device)
        self._n_pad = dataset.padded_len(cfg.batch_size)
        self.history: List[Dict] = []

    # -- the network under given mixing weights ------------------------------
    def _apply(self, variables, w, wr, x, train: bool):
        """The forward; in train mode ``(logits, new BN statistics)``."""
        if train:
            return self._train_forward(variables, x, None, w, wr)
        return functional_call(self.model, variables, (x, w, wr),
                               {"train": False})

    def _mixing(self, alphas, uniforms, tau):
        """The mixing weights of the normal and the reduce cells: the
        softmax (DARTS) or GDAS's straight-through sample from
        ``uniforms`` (normal, reduce)."""
        if self.cfg.variant == "gdas":
            return tuple(gumbel_softmax_weights(a, u, tau)
                         for a, u in zip(alphas, uniforms))
        return tuple(torch.softmax(a, dim=-1) for a in alphas)

    # -- one client's search --------------------------------------------------
    def search_step(self, names, params, colls, alphas, opt_w, opt_a,
                    train_batch, val_batch, u_arch, u_weight, tau):
        """One alternation: the alphas' Adam step on the val batch, then the
        weights' SGD step on the train batch under the new alphas. ``u_*``
        are GDAS's uniforms (normal, reduce) of each step, or None."""
        cfg = self.cfg
        xt, yt, mt = train_batch
        xv, yv, mv = val_batch
        a_leaves = [a.detach().requires_grad_(True) for a in alphas]
        w_eval = params
        if cfg.arch_unrolled:
            inner = [p.detach().requires_grad_(True) for p in params]
            logits, _ = self._apply({**colls, **dict(zip(names, inner))},
                                    *self._mixing(a_leaves, u_weight, tau),
                                    xt, True)
            gw = _grad(_masked_ce(logits, yt, mt), inner, create_graph=True)
            w_eval = [p - cfg.lr * g for p, g in zip(inner, gw)]
        logits, _ = self._apply({**colls, **dict(zip(names, w_eval))},
                                *self._mixing(a_leaves, u_arch, tau), xv,
                                True)
        ga = _grad(_masked_ce(logits, yv, mv), a_leaves)
        with torch.no_grad():
            ua, opt_a = self._opt_a.update(list(ga), opt_a, alphas)
            alphas = torch._foreach_add(alphas, ua)
        leaves = [p.detach().requires_grad_(True) for p in params]
        logits, new_colls = self._apply(
            {**colls, **dict(zip(names, leaves))},
            *self._mixing(alphas, u_weight, tau), xt, True)
        loss = _masked_ce(logits, yt, mt)
        gw = _grad(loss, leaves)
        with torch.no_grad():
            uw, opt_w = self._opt_w.update(list(gw), opt_w, params)
            params = torch._foreach_add(params, uw)
        return (params, next_colls(colls, new_colls), alphas, opt_w, opt_a,
                loss.detach())

    def _client_search(self, x, y, mask, orders, uniforms, tau):
        bsz = self.cfg.batch_size
        nb = self._n_pad // bsz
        names = [k for k in self.variables if k in self._trained]
        params = [self.variables[k] for k in names]
        colls = {k: v for k, v in self.variables.items()
                 if k not in self._trained}
        alphas = [self.alphas["normal"], self.alphas["reduce"]]
        opt_w = self._opt_w.init(params)
        opt_a = self._opt_a.init(alphas)
        losses = []
        for e in range(self.cfg.epochs):
            batches = orders[e][:nb * bsz].view(nb, bsz)
            val_batches = torch.roll(batches, 1, 0)  # the previous as val
            for i in range(nb):
                t, v = batches[i], val_batches[i]
                u = uniforms[e, i] if uniforms is not None else (None,) * 4
                (params, colls, alphas, opt_w, opt_a,
                 loss) = self.search_step(
                    names, params, colls, alphas, opt_w, opt_a,
                    (x[t], y[t], mask[t]), (x[v], y[v], mask[v]),
                    u[:2], u[2:], tau)
                losses.append(loss)
        out = {**colls, **dict(zip(names, params))}
        state = {k: out[k] for k in self.variables}
        state.update(zip(ALPHA_KEYS, alphas))
        return state, torch.stack(losses).mean()

    # -- rounds ---------------------------------------------------------------
    def _default_draws(self, round_idx: int):
        cfg = self.cfg
        nb = self._n_pad // cfg.batch_size
        orders, uniforms = [], []
        k, n_ops = self.alphas["normal"].shape
        for c in range(self.ds.client_num):
            gen = make_generator(derive_seed(cfg.seed, round_idx, c))
            orders.append(np.stack([torch.randperm(
                self._n_pad, generator=gen).numpy()
                for _ in range(cfg.epochs)]))
            if cfg.variant == "gdas":
                uniforms.append(torch.rand(
                    (cfg.epochs, nb, 4, k, n_ops),
                    generator=gen).clamp_(min=1e-20).numpy())
        return np.stack(orders), (np.stack(uniforms) if uniforms else None)

    def run_round(self, round_idx: int, orders=None, uniforms=None) -> Dict:
        """One search round over every client. ``orders`` is ``[C, epochs,
        n_pad]``, each client's permutation of its padded rows an epoch;
        ``uniforms`` (GDAS only) ``[C, epochs, nb, 4, k, len(PRIMITIVES)]``,
        a step's draws in ``[1e-20, 1)`` for the architecture step's normal
        and reduce weights, then the weight step's. Both default to the
        port's own draws."""
        cfg = self.cfg
        if orders is None or (uniforms is None and cfg.variant == "gdas"):
            drawn = self._default_draws(round_idx)
            orders = drawn[0] if orders is None else orders
            uniforms = drawn[1] if uniforms is None else uniforms
        idxs = list(range(self.ds.client_num))
        x, y, mask = self.ds.pack_clients(idxs, cfg.batch_size,
                                          n_pad=self._n_pad)
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, dtype=torch.int64, device=self.device)
        mask = torch.as_tensor(mask, device=self.device).to(x.dtype)
        orders = torch.as_tensor(np.asarray(orders), dtype=torch.int64,
                                 device=self.device)
        if cfg.variant == "gdas":
            uniforms = torch.as_tensor(np.asarray(uniforms),
                                       device=self.device).to(
                self.alphas["normal"].dtype)
        else:
            uniforms = None
        # the JAX package hands the temperature in as a float32
        tau = float(np.float32(gdas_tau(round_idx, cfg.comm_round)))
        states, losses = [], []
        for i in range(len(idxs)):
            s, loss = self._client_search(
                x[i], y[i], mask[i], orders[i],
                None if uniforms is None else uniforms[i], tau)
            states.append(s)
            losses.append(loss)
        weights = torch.as_tensor(self.ds.client_weights(idxs),
                                  device=self.device)
        mean = self._mean(pt.tree_stack(states), weights)
        self.alphas = {"normal": mean.pop(ALPHA_KEYS[0]),
                       "reduce": mean.pop(ALPHA_KEYS[1])}
        self.variables = mean
        rec = {"round": round_idx,
               "search_loss": float(torch.stack(losses).mean()),
               "genotype": self.genotype()}
        self.history.append(rec)
        return rec

    def genotype(self):
        """The current global architecture (reference
        record_model_global_architecture, FedNASAggregator.py:173)."""
        return parse_genotype(self.alphas["normal"].cpu().numpy(),
                              self.alphas["reduce"].cpu().numpy(),
                              steps=self.model.steps,
                              multiplier=self.model.multiplier)

    @torch.no_grad()
    def evaluate(self) -> Dict:
        """Test accuracy of the global network under the softmaxed alphas
        (GDAS's too: a sample at eval would make it a random variable)."""
        xt, yt = self.ds.test_data_global
        if not len(xt):
            return {}
        w, wr = (torch.softmax(self.alphas[k], dim=-1)
                 for k in ("normal", "reduce"))
        correct = 0
        for i in range(0, len(xt), EVAL_BATCH):
            x = torch.as_tensor(np.ascontiguousarray(xt[i:i + EVAL_BATCH]),
                                device=self.device)
            y = torch.as_tensor(np.asarray(yt[i:i + EVAL_BATCH]),
                                dtype=torch.int64, device=self.device)
            logits = self._apply(self.variables, w, wr, x, False)
            correct += int((logits.argmax(-1) == y).sum())
        return {"test_acc": correct / len(xt)}
