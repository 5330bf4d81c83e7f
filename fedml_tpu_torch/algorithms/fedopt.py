"""FedOpt: adaptive server optimization (FedAdam, FedAdagrad, FedYogi...).

The counterpart of ``fedml_tpu/algorithms/fedopt.py``. Reference semantics
(fedml_api/distributed/fedopt/FedOptAggregator.py:70-123 and
standalone/fedopt/fedopt_api.py): the FedAvg sample-weighted mean, the
pseudo-gradient ``w_old - w_avg``, and a step of a persistent server
optimizer on it; buffers that are not parameters (BN running statistics)
take the plain mean. The mean is FedAvg's (the aggregation kernel on a
CUDA device, the plain per-leaf mean on the CPU).

The server optimizers are optax's, written out by hand over lists of
tensors in the module's ``named_parameters`` order, with the defaults of
optax 0.2.6 (``OPTIMIZER_REPO``). Their state is a dict keyed by optax's
state field names (``count``, ``mu``, ``nu``, ``sum_of_squares``,
``trace``), so ``utils/convert.py`` carries an optax state across. The
step count is a 0-dim int32 tensor and every hyperparameter a Python
constant: a server step reads nothing on the host, so
:class:`FedOptFusedRounds` captures it in the round's CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from fedml_tpu_torch.algorithms.fedavg import (FedAvgAPI, FedAvgConfig,
                                               FusedRounds)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.trainer.functional import (Optimizer, _sgd,
                                                bias_correction,
                                                update_moment)


def _full_like(params, value: float):
    return [torch.full_like(p, value) for p in params]


def _counted(params, init: float = 0.0):
    """Adam's state: a 0-dim int32 step count and two moments."""
    return {"count": torch.zeros((), dtype=torch.int32,
                                 device=params[0].device),
            "mu": _full_like(params, init), "nu": _full_like(params, init)}


def _scaled(updates, lr: float):
    """optax's ``scale_by_learning_rate``: the update times ``-lr``."""
    return torch._foreach_mul(updates, -lr)


def _adam_direction(mu, nu, count, eps: float):
    """``mu_hat / (sqrt(nu_hat) + eps)`` (optax's ``eps_root`` is 0)."""
    return torch._foreach_div(
        bias_correction(mu, 0.9, count),
        torch._foreach_add(torch._foreach_sqrt(
            bias_correction(nu, 0.999, count)), eps))


def _adam(lr: float, eps: float = 1e-8, weight_decay: float = 0.0,
          trust_ratio: bool = False) -> Optimizer:
    """``optax.adam`` (b1 0.9, b2 0.999, ``eps``); with ``weight_decay``,
    ``optax.adamw``'s ``u + wd * p`` after Adam's scaling; with
    ``trust_ratio``, ``optax.lamb``'s per-leaf ``||p|| / ||u||``, 1 where
    either norm is 0."""

    def update(grads, state, params, emit=None, acc_div=None):
        mu = update_moment(grads, state["mu"], 0.9, 1)
        nu = update_moment(grads, state["nu"], 0.999, 2)
        count = state["count"] + 1
        u = _adam_direction(mu, nu, count, eps)
        if weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul(params,
                                                         weight_decay))
        if trust_ratio:
            u = [x * _trust(p, x) for p, x in zip(params, u)]
        return _scaled(u, lr), {"count": count, "mu": mu, "nu": nu}

    return Optimizer(_counted, update)


def _trust(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    return torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)


def _yogi(lr: float, eps: float = 1e-3, b2: float = 0.999) -> Optimizer:
    """``optax.yogi``: both moments start at 1e-6; ``nu`` moves by the sign
    of ``nu - g**2``: ``nu - (1 - b2) * sign(nu - g**2) * g**2``."""

    def update(grads, state, params, emit=None, acc_div=None):
        mu = update_moment(grads, state["mu"], 0.9, 1)
        g2 = torch._foreach_mul(grads, grads)
        nu = [v - (1 - b2) * torch.sign(v - s) * s
              for v, s in zip(state["nu"], g2)]
        count = state["count"] + 1
        u = _adam_direction(mu, nu, count, eps)
        return _scaled(u, lr), {"count": count, "mu": mu, "nu": nu}

    return Optimizer(lambda params: _counted(params, 1e-6), update)


def _adagrad(lr: float, initial_accumulator_value: float = 0.1,
             eps: float = 1e-7) -> Optimizer:
    """``optax.adagrad``: ``s = g**2 + s`` from 0.1; the update ``g *
    rsqrt(s + eps)`` where ``s > 0``, else 0."""

    def init(params):
        return {"sum_of_squares": _full_like(params,
                                             initial_accumulator_value)}

    def update(grads, state, params, emit=None, acc_div=None):
        s = torch._foreach_add(torch._foreach_mul(grads, grads),
                               state["sum_of_squares"])
        u = [torch.where(t > 0, torch.rsqrt(t + eps), 0.0) * g
             for t, g in zip(s, grads)]
        return _scaled(u, lr), {"sum_of_squares": s}

    return Optimizer(init, update)


def _rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """``optax.rmsprop`` (not centered, no momentum): ``nu`` from 0, the
    update ``g * rsqrt(nu + eps)`` (``eps`` inside the square root)."""

    def update(grads, state, params, emit=None, acc_div=None):
        nu = update_moment(grads, state["nu"], decay, 2)
        u = torch._foreach_mul(torch._foreach_rsqrt(
            torch._foreach_add(nu, eps)), grads)
        return _scaled(u, lr), {"nu": nu}

    return Optimizer(lambda params: {"nu": _full_like(params, 0.0)}, update)


#: name -> constructor(lr, **kw); parity with the reference's OptRepo
#: name lookup (optrepo.py:7) and the JAX package's optax registry
OPTIMIZER_REPO = {
    "sgd": lambda lr, momentum=0.0, **kw: _sgd(lr, momentum),
    "adam": lambda lr, **kw: _adam(lr, **kw),
    "adamw": lambda lr, weight_decay=1e-4, **kw: _adam(
        lr, weight_decay=weight_decay, **kw),
    "adagrad": lambda lr, **kw: _adagrad(lr, **kw),
    "yogi": lambda lr, **kw: _yogi(lr, **kw),
    "rmsprop": lambda lr, **kw: _rmsprop(lr, **kw),
    "lamb": lambda lr, **kw: _adam(lr, eps=1e-6, trust_ratio=True, **kw),
}


def get_server_optimizer(name: str, lr: float, **kw) -> Optimizer:
    try:
        return OPTIMIZER_REPO[name.lower()](lr, **kw)
    except KeyError:
        raise ValueError(
            f"unknown server_optimizer {name!r}; have {sorted(OPTIMIZER_REPO)}")


@dataclasses.dataclass(frozen=True)
class FedOptConfig(FedAvgConfig):
    """Adds the reference's --server_optimizer / --server_lr flags
    (main_fedopt.py:54-60)."""

    server_optimizer: str = "adam"
    server_lr: float = 1e-3
    server_momentum: float = 0.0


class FedOptAPI(FedAvgAPI):
    """FedAvg's round with a persistent server optimizer on the
    pseudo-gradient. ``config`` must be a FedOptConfig."""

    def __init__(self, dataset: FederatedDataset, module,
                 task: str = "classification",
                 config: Optional[FedOptConfig] = None,
                 delete_client: Optional[int] = None, device="cuda"):
        config = config or FedOptConfig()
        super().__init__(dataset, module, task, config,
                         delete_client=delete_client, device=device)
        kw = {}
        if config.server_optimizer == "sgd" and config.server_momentum:
            kw["momentum"] = config.server_momentum
        self._server_tx = get_server_optimizer(config.server_optimizer,
                                               config.server_lr, **kw)
        # the server steps the module's parameters; its buffers are not
        # told apart by name markers but by what the module registers
        self._param_names = [n for n, _ in module.named_parameters()]
        self.server_opt_state = self._server_tx.init(
            self._params(self.variables))

    def _params(self, variables) -> List[torch.Tensor]:
        return [variables[n] for n in self._param_names]

    def _fedopt_round(self, variables, opt_state, x, y, mask, weights, plan,
                      agg_seed, lr_scale=None, gated: bool = False):
        """FedAvg's round body, then the server step. Returns
        ``(new_variables, new_opt_state, stats)``."""
        avg, totals = self._round_fn(variables, x, y, mask, weights, plan,
                                     agg_seed, lr_scale, gated)
        params = self._params(variables)
        # pseudo-gradient: w_old - w_avg (the server walks opposite the
        # aggregate displacement; FedOptAggregator.py:109-123)
        pseudo_grad = torch._foreach_sub(params, self._params(avg))
        updates, opt_state = self._server_tx.update(pseudo_grad, opt_state,
                                                    params)
        new_vars = dict(avg)  # buffers keep the plain mean
        new_vars.update(zip(self._param_names,
                            torch._foreach_add(params, updates)))
        return new_vars, opt_state, totals

    def _dispatch(self, x, y, mask, weights, plan, agg_seed, lr_scale):
        self.variables, self.server_opt_state, stats = self._fedopt_round(
            self.variables, self.server_opt_state, x, y, mask, weights,
            plan, agg_seed, lr_scale)
        return stats


class FedOptFusedRounds(FusedRounds):
    """FusedRounds for FedOpt: the carry is ``(variables,
    server_opt_state)``, so the server optimizer steps inside every fused
    round (on a CUDA device, inside the round's captured graph, its state
    written back into the graph's static carry). The same seed chain as
    the host loop; FedOpt's aggregation ignores the round's aggregation
    seed, as ``FedOptAPI.run_round`` does."""

    def _init_carry(self):
        return (self.api.variables, self.api.server_opt_state)

    def _store_carry(self, carry) -> None:
        self.api.variables, self.api.server_opt_state = carry

    def _round(self, carry, x, y, mask, weights, plan, agg_seed, lr_scale):
        variables, opt_state = carry
        new_vars, new_opt, totals = self.api._fedopt_round(
            variables, opt_state, x, y, mask, weights, plan, agg_seed,
            lr_scale, gated=True)
        return (new_vars, new_opt), totals


FedOptAPI._fused_driver_cls = FedOptFusedRounds
