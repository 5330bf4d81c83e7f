"""Local training and evaluation programs over state dicts.

The counterpart of ``fedml_tpu/trainer/functional.py``. One call of
``local_train`` is the reference's ``ModelTrainer.train`` for one client
(fedml_api/distributed/fedavg/MyModelTrainer.py:19-49): a fresh optimizer,
``cfg.epochs`` passes with per-epoch reshuffling, a mask-weighted per-batch
mean loss. The model is a stateless ``nn.Module`` template driven through
``torch.func.functional_call`` over a ``{name: tensor}`` state dict, so
client state never lives inside the module.

Data layout per client: flat padded tensors ``x: [n_pad, ...]``, ``y``,
``mask: [n_pad]`` with ``n_pad`` a multiple of the batch size; the mask
weights the loss so padding rows contribute zero gradient.

The batch schedule (which rows form each step, the dropout seed of each
step, and whether the step holds any real row) is computed on the host from
the host copy of the mask, so a round never waits on the device to decide
what to launch. Steps whose batch holds only padding rows are skipped: the
JAX package gates them into exact no-ops (``has_real``), and skipping them is
the same no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from fedml_tpu_torch.core.sampling import derive_seed, make_generator
from fedml_tpu_torch.trainer.tasks import TASK_HEADS, TaskHead


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Local-training hyperparameters (reference argparse flags:
    --epochs --batch_size --client_optimizer --lr --wd). The same fields as
    ``fedml_tpu.trainer.functional.TrainConfig``; this slice runs
    ``client_optimizer="sgd"`` (with or without momentum), and
    :func:`make_local_train` raises ``NotImplementedError`` for the rest."""

    epochs: int = 1
    batch_size: Optional[int] = None  # None = full batch (one step per epoch)
    lr: float = 0.03
    client_optimizer: str = "sgd"  # "sgd" | "adam"
    # like the reference's optax.sgd path, plain SGD takes no weight decay:
    # wd is read only by the adam path
    wd: float = 0.0
    momentum: float = 0.0
    shuffle: bool = True
    compute_dtype: Optional[str] = None
    accum_steps: int = 1
    # per-ROUND exponential client-LR decay: the round's updates are scaled
    # by lr_decay_round ** round_idx. Exact, because the optimizer is fresh
    # every round and lr is a final multiplicative scale of the update.
    lr_decay_round: float = 1.0


def validate_accum_steps(cfg: TrainConfig, client_sizes) -> None:
    """Host-side accum_steps guard: a client whose ``epochs * ceil(n_i /
    bsz)`` is not a multiple of ``accum_steps`` would drop its trailing
    micro-batches. Drivers that know the federation's sizes call this at
    construction."""
    if cfg.accum_steps <= 1:
        return
    bad = {}
    for c, n in dict(client_sizes).items():
        bsz = cfg.batch_size or n
        real_steps = cfg.epochs * -(-n // bsz) if bsz else 0
        if real_steps % cfg.accum_steps != 0:
            bad[c] = real_steps
    if bad:
        some = dict(list(bad.items())[:5])
        raise ValueError(
            f"accum_steps={cfg.accum_steps} must divide every client's "
            f"epochs*ceil(n_i/batch_size); offending clients (first 5 of "
            f"{len(bad)}): {some} — trailing real micro-batches would be "
            "silently dropped")


def round_lr_scale(cfg: TrainConfig, round_idx) -> Optional[float]:
    """The per-round client-LR scale ``lr_decay_round ** round_idx``
    computed in float32 as the reference does, or None when the schedule
    is off."""
    if cfg.lr_decay_round == 1.0:
        return None
    return float(np.power(np.float32(cfg.lr_decay_round),
                          np.float32(round_idx)))


def check_supported(cfg: TrainConfig) -> None:
    """Raise for the TrainConfig options this slice does not run yet."""
    if cfg.client_optimizer == "adam":
        raise NotImplementedError(
            "client_optimizer='adam' (optax's amsgrad form) is not ported "
            "yet: ROADMAP Queue 1, Slice A item 4 (amsgrad)")
    if cfg.client_optimizer != "sgd":
        raise ValueError(f"unknown client_optimizer: {cfg.client_optimizer!r}")
    if cfg.accum_steps > 1:
        raise NotImplementedError(
            "accum_steps > 1 is not ported yet: ROADMAP Queue 1, Slice A "
            "item 4 (accum_steps)")
    if cfg.compute_dtype is not None:
        raise NotImplementedError(
            "compute_dtype is not ported yet: ROADMAP Queue 1, Slice A "
            "item 4 (compute_dtype)")


def make_forward(module: torch.nn.Module) -> Callable:
    """``forward(variables, x, train, generator=None)`` over a state dict."""

    def forward(variables, x, train: bool, generator=None):
        return functional_call(module, variables, (x,),
                               {"train": train, "generator": generator})

    return forward


class BatchSchedule(NamedTuple):
    # [epochs * nb, bsz] int64 row indices (numpy, or a tensor already on
    # the data's device)
    batch_idx: np.ndarray
    step_seeds: List[int]   # dropout seed of each step
    has_real: np.ndarray    # [epochs * nb] bool: the batch holds a real row


def make_batch_schedule(n_pad: int, epochs: int, bsz: int, shuffle: bool,
                        seed: int, mask: Optional[np.ndarray] = None
                        ) -> BatchSchedule:
    """Epochs x batches schedule for one client, on the host.

    PADDING-INVARIANT: each epoch permutes only the real rows (``mask >
    0``) with a generator seeded from ``(seed, epoch)``, and the padding
    rows follow in index order, so the order restricted to real rows, and
    with it the trajectory, is identical for every ``n_pad`` the caller
    packs to. Dropout seeds are per (epoch, batch position), so stochastic
    layers stay on the same trajectory too. With shuffle off the order is
    the identity (``pack_clients`` lays real rows first)."""
    if n_pad % bsz:
        raise ValueError(f"n_pad={n_pad} is not a multiple of bsz={bsz}")
    nb = n_pad // bsz
    real = (np.flatnonzero(mask > 0) if mask is not None
            else np.arange(n_pad))
    is_real = np.zeros(n_pad, bool)
    is_real[real] = True
    pad = np.flatnonzero(~is_real)
    orders = []
    for e in range(epochs):
        if shuffle:
            gen = make_generator(derive_seed(seed, 0, e))
            perm = torch.randperm(len(real), generator=gen).numpy()
            orders.append(np.concatenate([real[perm], pad]))
        else:
            orders.append(np.arange(n_pad))
    batch_idx = np.stack(orders).reshape(epochs * nb, bsz).astype(np.int64)
    step_seeds = [derive_seed(seed, 1, e, b)
                  for e in range(epochs) for b in range(nb)]
    return BatchSchedule(batch_idx, step_seeds,
                         is_real[batch_idx].any(axis=1))


def _add_stats(total, stats):
    if total is None:
        return {k: v.detach() for k, v in stats.items()}
    return {k: total[k] + stats[k].detach() for k in total}


def make_local_train(module: torch.nn.Module, task: str, cfg: TrainConfig):
    """Build ``local_train(variables, x, y, mask, seed, lr_scale=None,
    schedule=None) -> (variables, stats)``.

    ``variables`` is a ``{name: tensor}`` state dict on the data's device;
    the result is a new state dict (the input is not modified). ``stats``
    are the summed head stats over the client's real steps. ``schedule``
    is the client's :class:`BatchSchedule`; without one it is built from
    ``mask`` (which then waits for the device)."""
    check_supported(cfg)
    head: TaskHead = TASK_HEADS[task]
    forward = make_forward(module)
    lr, momentum = cfg.lr, cfg.momentum

    def local_train(variables, x, y, mask, seed: int, lr_scale=None,
                    schedule: Optional[BatchSchedule] = None):
        n_pad = x.shape[0]
        bsz = cfg.batch_size or n_pad
        if schedule is None:
            schedule = make_batch_schedule(n_pad, cfg.epochs, bsz,
                                           cfg.shuffle, seed,
                                           mask.cpu().numpy())
        idx = torch.as_tensor(schedule.batch_idx, device=x.device)
        names = list(variables)
        params = [variables[k].detach() for k in names]
        trace = None  # momentum buffer: optax.trace starts at zeros
        gen = torch.Generator(device=x.device)
        total = None
        for s in np.flatnonzero(schedule.has_real):
            rows = idx[s]
            gen.manual_seed(schedule.step_seeds[s])
            leaves = [p.requires_grad_(True) for p in params]
            out = forward(dict(zip(names, leaves)), x[rows], True, gen)
            stats = head(out, y[rows], mask[rows])
            loss = stats["loss_sum"] / stats["count"].clamp(min=1.0)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                # optax.sgd: trace t = g + momentum * t, update u = -lr * t
                if momentum:
                    t = (list(grads) if trace is None else torch._foreach_add(
                        list(grads), torch._foreach_mul(trace, momentum)))
                    trace = t
                else:
                    t = list(grads)
                updates = torch._foreach_mul(t, -lr)
                if lr_scale is not None:
                    torch._foreach_mul_(updates, lr_scale)
                params = torch._foreach_add([p.detach() for p in leaves],
                                            updates)
            total = _add_stats(total, stats)
        if total is None:  # no real row at all: zero stats, params as given
            with torch.no_grad():
                total = {k: torch.zeros_like(v) for k, v in head(
                    forward(variables, x[:1], False), y[:1],
                    torch.zeros_like(mask[:1])).items()}
        return dict(zip(names, params)), total

    return local_train


def make_eval(module: torch.nn.Module, task: str,
              eval_batch_size: int = 512):
    """Build ``evaluate(variables, x, y, mask) -> stat sums`` over fixed
    eval batches in deterministic mode (no dropout), the analogue of the
    reference's ``ModelTrainer.test`` loop (MyModelTrainer.py:51-96)."""
    head: TaskHead = TASK_HEADS[task]
    forward = make_forward(module)

    @torch.no_grad()
    def evaluate(variables, x, y, mask):
        n = x.shape[0]
        if n == 0:
            # empty eval set: run the head once on a zero dummy row with a
            # zero mask so the stat keys exist and all sums are 0
            dummy_x = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                                  device=x.device)
            dummy_y = torch.zeros((1,) + tuple(y.shape[1:]), dtype=y.dtype,
                                  device=y.device)
            return head(forward(variables, dummy_x, False), dummy_y,
                        torch.zeros(1, device=x.device))
        total = None
        for lo in range(0, n, eval_batch_size):
            hi = min(lo + eval_batch_size, n)
            out = forward(variables, x[lo:hi], False)
            total = _add_stats(total, head(out, y[lo:hi], mask[lo:hi]))
        return total

    return evaluate
