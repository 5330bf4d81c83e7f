"""Decentralized online learning over a graph (DSGD and push-sum).

The counterpart of ``fedml_tpu/algorithms/decentralized.py``. Reference:
fedml_api/standalone/decentralized/: ClientDSGD and ClientPushsum run online
logistic regression over streaming samples (SUSY, RoomOccupancy), one
sample per client and iteration, exchanging parameters with their graph
neighbours:

- DSGD ("DOL"): x_i <- x_i - lr * grad_i(x_i), then x <- W x (W symmetric).
- Push-sum: gradients at the de-biased estimate z = x / omega; x and omega
  both mix by columns (x <- W^T x, omega <- W^T omega), the push-sum
  correction for directed graphs (client_pushsum.py:57-131).
- Regret: the mean cumulative loss over n_clients * T
  (decentralized_fl_api.py:11-17).

The T iterations run as a loop of device ops over the clients' stacked
parameters; each gossip exchange is one product of the mixing matrix with
them (the JAX package scans the same iteration). The gradient of the loss
is written out as JAX's autodiff takes it from the same stable form
``max(l, 0) - l * y + log1p(exp(-|l|))``, kinks included
(:func:`_bce_grad`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.core.sampling import locked_global_numpy_rng
from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                           SymmetricTopologyManager)
from fedml_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DecentralizedConfig:
    mode: str = "DOL"  # 'DOL' (DSGD) | 'PUSHSUM'
    iteration_number: int = 100
    learning_rate: float = 0.1
    weight_decay: float = 0.0001
    topology_neighbors_num_undirected: int = 4
    topology_neighbors_num_directed: int = 3
    b_symmetric: bool = True
    time_varying: bool = False
    seed: int = 0


def _make_topologies(n: int, cfg: DecentralizedConfig) -> np.ndarray:
    """[T, n, n] mixing matrices (a static topology tiled T times)."""
    def gen(seed):
        # the seed and the topology's coin flips on the locked global
        # stream, as the JAX package draws them
        with locked_global_numpy_rng(seed):
            if cfg.b_symmetric:
                mgr = SymmetricTopologyManager(
                    n, cfg.topology_neighbors_num_undirected)
            else:
                mgr = AsymmetricTopologyManager(
                    n, cfg.topology_neighbors_num_undirected,
                    cfg.topology_neighbors_num_directed)
            return mgr.generate_topology()

    if cfg.time_varying and not cfg.b_symmetric:
        # regenerated every iteration (reference client_pushsum.py:63-72),
        # from cfg.seed
        return np.stack(
            [gen(cfg.seed + t) for t in range(cfg.iteration_number)])
    # the symmetric generator is deterministic (a ring lattice, as the
    # reference's ws(n, k, p=0)), so a time-varying symmetric one is static
    W = gen(cfg.seed)
    return np.broadcast_to(W, (cfg.iteration_number, n, n)).copy()


def _bce_grad(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d/dl of ``max(l, 0) - l * y + log1p(exp(-|l|))`` piece by piece, as
    JAX differentiates it: ``max``'s derivative is 1/2 at the tie and
    ``|l|``'s is 1 at 0. It is ``sigmoid(l) - y`` except at a logit of
    exactly 0, where it is ``-y`` (every client's first iteration from zero
    weights)."""
    e = torch.exp(-logit.abs())
    dmax = torch.where(logit > 0, 1.0, torch.where(logit < 0, 0.0, 0.5))
    dabs = torch.where(logit >= 0, 1.0, -1.0)
    return dmax - y - e / (1 + e) * dabs


class DecentralizedOnlineAPI:
    """Online decentralized LR (parity: FedML_decentralized_fl).

    ``streaming_x``: [n_clients, T, dim]; ``streaming_y``: [n_clients, T]
    in {0, 1}: binary tasks like SUSY (BCE on a single logit). ``device``
    defaults to CUDA and raises when no GPU is present.
    """

    def __init__(self, streaming_x: np.ndarray, streaming_y: np.ndarray,
                 config: Optional[DecentralizedConfig] = None,
                 device="cuda"):
        self.config = config or DecentralizedConfig()
        self.device = resolve_device(device)
        cfg = self.config
        if cfg.mode not in ("DOL", "PUSHSUM"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        if cfg.mode == "DOL" and not cfg.b_symmetric:
            # column-mixing a row-stochastic-only W without the push-sum
            # omega correction is biased toward high-column-mass nodes
            raise ValueError(
                "DOL (DSGD) requires b_symmetric=True; use mode='PUSHSUM' "
                "for directed topologies")
        n, T, dim = streaming_x.shape
        if T < cfg.iteration_number:
            raise ValueError(f"{T} samples a client < iteration_number "
                             f"{cfg.iteration_number}")
        self.n_clients, self.dim = n, dim
        self.topologies = _make_topologies(n, cfg)
        T_used = cfg.iteration_number

        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=np.float32)).to(self.device)
        self._xs = upload(np.swapaxes(streaming_x[:, :T_used], 0, 1))
        self._ys = upload(np.swapaxes(streaming_y[:, :T_used], 0, 1))
        self._Ws = upload(self.topologies)
        self.w = None
        self.b = None
        self.losses = None

    @torch.no_grad()
    def _run(self):
        cfg, n, dev = self.config, self.n_clients, self.device
        push = cfg.mode == "PUSHSUM"
        lr, wd = cfg.learning_rate, cfg.weight_decay
        w_x = torch.zeros((n, self.dim), device=dev)
        b_x = torch.zeros((n,), device=dev)
        omega = torch.ones((n,), device=dev)
        losses = []
        for x_t, y_t, W in zip(self._xs, self._ys, self._Ws):
            z_w, z_b = ((w_x / omega[:, None], b_x / omega) if push
                        else (w_x, b_x))
            logit = (x_t * z_w).sum(-1) + z_b
            # stable BCE with logits (the reference applies sigmoid and
            # BCELoss)
            losses.append(torch.clamp(logit, min=0) - logit * y_t
                          + torch.log1p(torch.exp(-logit.abs())))
            g = _bce_grad(logit, y_t)
            w_x = w_x - lr * (g[:, None] * x_t + wd * z_w)
            b_x = b_x - lr * (g + wd * z_b)
            # gossip: column mixing x <- W^T x (push-sum); a symmetric W
            # makes it W x (DSGD)
            w_x, b_x = W.T @ w_x, W.T @ b_x
            if push:
                omega = W.T @ omega
        if push:
            w_x, b_x = w_x / omega[:, None], b_x / omega
        return w_x, b_x, torch.stack(losses)

    def train(self) -> float:
        self.w, self.b, self.losses = self._run()
        return self.regret()

    def regret(self) -> float:
        """Average cumulative loss per client per iteration
        (decentralized_fl_api.py:11-17)."""
        if self.losses is None:
            raise RuntimeError("call train() first")
        T = self.losses.shape[0]
        return float(self.losses.sum()) / (self.n_clients * T)

    def consensus_distance(self) -> float:
        """Mean distance of the client models from their mean: 0 at
        consensus."""
        mean_w = self.w.mean(dim=0, keepdim=True)
        return float(torch.linalg.vector_norm(self.w - mean_w, dim=1).mean())
