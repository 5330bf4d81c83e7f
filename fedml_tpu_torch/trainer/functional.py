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
step, whether the step holds any real row, and gradient accumulation's
emit flags) is computed on the host from the host copy of the mask, so a
round never waits on the device to decide what to launch. Every step runs
one step function (:func:`make_train_step`). Two ways to walk the steps:

- the host loop skips the steps whose batch holds only padding rows;
- ``gated=True`` runs every one of the ``epochs * nb`` steps and selects
  params, optimizer state and stats with ``torch.where(has_real, new,
  old)``, the JAX package's gating (``fedml_tpu/trainer/functional.py:
  293-303``). Its step count and every input are fixed by the shapes, so a
  CUDA graph can capture it (``algorithms/fedavg.py``, ``FusedRounds``).

Both leave padding-only batches true no-ops, so they give the same bits.

Params and collections: the state dict's parameters
(``module.named_parameters()``) are differentiated and stepped; every other
entry (BatchNorm's running statistics, ``models/common.BatchNorm``) is a
collection, the JAX package's non-``params`` variables. The train-mode
forward hands back the collections' new values, and the step selects them
with the same gate as the params (``fedml_tpu/trainer/functional.py:
124-141, 297-303``); they stay f32 under ``compute_dtype``. A model with no
collections runs exactly the ops it ran before they existed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from fedml_tpu_torch.core.sampling import (counter_bits, derive_seed, fold32,
                                           make_generator)
from fedml_tpu_torch.models.common import (BatchNorm, DropoutKey,
                                           collect_batch_stats)
from fedml_tpu_torch.trainer.tasks import TASK_HEADS, TaskHead


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Local-training hyperparameters (reference argparse flags:
    --epochs --batch_size --client_optimizer --lr --wd). The same fields as
    ``fedml_tpu.trainer.functional.TrainConfig``."""

    epochs: int = 1
    batch_size: Optional[int] = None  # None = full batch (one step per epoch)
    lr: float = 0.03
    client_optimizer: str = "sgd"  # "sgd" | "adam" (optax's amsgrad)
    # like the reference's optax.sgd path, plain SGD takes no weight decay:
    # wd is read only by the adam path
    wd: float = 0.0
    momentum: float = 0.0
    shuffle: bool = True
    # mixed precision: forward and backward in this dtype (e.g.
    # "bfloat16") off float32 masters; optimizer state, loss, stats and the
    # aggregation stay float32. None = pure f32 (parity tests).
    compute_dtype: Optional[str] = None
    # gradient accumulation (optax.MultiSteps, mean of the gradients): one
    # optimizer step every accum_steps real micro-batches
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


def round_lr_scales(cfg: TrainConfig, round_idxs) -> Optional[np.ndarray]:
    """The per-round client-LR scales ``lr_decay_round ** r`` computed in
    float32 as the reference does, or None when the schedule is off."""
    if cfg.lr_decay_round == 1.0:
        return None
    return np.power(np.float32(cfg.lr_decay_round),
                    np.asarray(round_idxs, dtype=np.float32))


def round_lr_scale(cfg: TrainConfig, round_idx,
                   device) -> Optional[torch.Tensor]:
    """One round's scale as a 0-dim f32 tensor on ``device`` (a device
    input, never a Python number a CUDA graph would freeze), or None."""
    scales = round_lr_scales(cfg, [round_idx])
    if scales is None:
        return None
    return torch.full((), float(scales[0]), dtype=torch.float32,
                      device=device)


def compute_dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    """``cfg.compute_dtype`` as a torch floating dtype (None: f32)."""
    if cfg.compute_dtype is None:
        return None
    dt = getattr(torch, str(cfg.compute_dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown compute_dtype: {cfg.compute_dtype!r}")
    return dt


# -- the client optimizers (optax's, by hand, over lists of tensors) ---------

class Optimizer(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params, emit,
    acc_div) -> (updates, state)`` over lists of tensors, optax's
    ``GradientTransformation`` in the port's idiom. ``emit`` and
    ``acc_div`` (0-dim tensors) are read only under ``accum_steps > 1``."""

    init: Callable
    update: Callable


def _sgd(lr: float, momentum: float) -> Optimizer:
    """``optax.sgd``: trace ``t = g + momentum * t`` (from zeros), update
    ``-lr * t``."""

    def init(params):
        return {"trace": [torch.zeros_like(p) for p in params]} \
            if momentum else {}

    def update(grads, state, params, emit=None, acc_div=None):
        if momentum:
            t = torch._foreach_add(grads,
                                   torch._foreach_mul(state["trace"],
                                                      momentum))
            state = {"trace": t}
        else:
            t = grads
        return torch._foreach_mul(t, -lr), state

    return Optimizer(init, update)


def decayed_sgd(lr: float, momentum: float = 0.0,
                wd: float = 0.0) -> Optimizer:
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``: ``g + wd
    * p`` into :func:`_sgd`. The optimizer of the algorithms that keep the
    reference's weight decay (split learning, FedNAS) or their own momentum
    (FedGKT), outside :class:`TrainConfig`."""
    inner = _sgd(lr, momentum)

    def update(grads, state, params, emit=None, acc_div=None):
        if wd:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        return inner.update(grads, state, params)

    return Optimizer(inner.init, update)


def update_moment(grads, moment, decay: float, order: int):
    """optax's ``update_moment``: ``(1 - decay) * g**order + decay * t``."""
    g = grads if order == 1 else torch._foreach_mul(grads, grads)
    return torch._foreach_add(torch._foreach_mul(g, 1 - decay),
                              torch._foreach_mul(moment, decay))


def bias_correction(moment, decay: float, count: torch.Tensor):
    """``t / (1 - decay**count)``, the power in the width optax takes it in:
    float32, or float64 for float64 moments (JAX's x64 mode). At float32, 1
    - 0.999 is 1.3e-5 away from its float64 value."""
    wide = moment[0].dtype == torch.float64
    steps = count.to(torch.float64 if wide else torch.float32)
    return torch._foreach_div(moment, 1 - torch.pow(decay, steps))


def decayed_adam(lr: float, wd: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 amsgrad: bool = False) -> Optimizer:
    """``optax.chain(add_decayed_weights(wd), adam(lr, b1, b2, eps))``, or
    with ``amsgrad`` optax 0.2.6's ``amsgrad``: ``g + wd * p``; ``mu =
    (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``; ``count += 1``; both
    moments divided by ``1 - b**count``; under ``amsgrad`` ``nu_max =
    max(nu_max, nu_hat)`` stands for ``nu_hat``; ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)``. The max is of the bias-corrected moment, which
    ``torch.optim.Adam(amsgrad=True)`` takes before the correction. The
    clients' Adam (:func:`make_optimizer`) is the amsgrad form; FedNAS's
    alphas take the plain one with ``b1 = 0.5``."""

    def init(params):
        n = 3 if amsgrad else 2
        zeros = [[torch.zeros_like(p) for p in params] for _ in range(n)]
        state = {"mu": zeros[0], "nu": zeros[1],
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=params[0].device)}
        if amsgrad:
            state["nu_max"] = zeros[2]
        return state

    def update(grads, state, params, emit=None, acc_div=None):
        if wd:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        mu = update_moment(grads, state["mu"], b1, 1)
        nu = update_moment(grads, state["nu"], b2, 2)
        count = state["count"] + 1
        mu_hat = bias_correction(mu, b1, count)
        nu_hat = bias_correction(nu, b2, count)
        new = {"mu": mu, "nu": nu, "count": count}
        if amsgrad:
            nu_hat = new["nu_max"] = torch._foreach_maximum(state["nu_max"],
                                                            nu_hat)
        u = torch._foreach_div(mu_hat, torch._foreach_add(
            torch._foreach_sqrt(nu_hat), eps))
        return torch._foreach_mul(u, -lr), new

    return Optimizer(init, update)


def _multi_steps(inner: Optimizer) -> Optimizer:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` with the mean of the
    gradients: ``acc + (g - acc) / (n + 1)`` (Welford, ``acc_div = n + 1``
    from the schedule); on an emitting step the inner update of ``acc``
    goes out and ``acc`` resets, otherwise the update is zero and the inner
    state holds. ``emit`` and ``acc_div`` come from the batch schedule
    (:func:`accum_flags`), so no counter lives in the state."""

    def init(params):
        return {"inner": inner.init(params),
                "acc": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params, emit=None, acc_div=None):
        acc = torch._foreach_add(state["acc"], torch._foreach_div(
            torch._foreach_sub(grads, state["acc"]), acc_div))
        u, new_inner = inner.update(acc, state["inner"], params)
        on = emit.to(torch.float32)
        return torch._foreach_mul(u, on), {
            "inner": tree_where(emit, new_inner, state["inner"]),
            "acc": torch._foreach_mul(acc, 1 - on)}

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """The client optimizer (reference MyModelTrainer.py:26-31): plain or
    momentum SGD, or Adam in optax's amsgrad form with ``wd`` folded into
    the gradient; wrapped in MultiSteps under ``accum_steps > 1``."""
    if cfg.client_optimizer == "sgd":
        opt = _sgd(cfg.lr, cfg.momentum)
    elif cfg.client_optimizer == "adam":
        opt = decayed_adam(cfg.lr, cfg.wd, amsgrad=True)
    else:
        raise ValueError(f"unknown client_optimizer: {cfg.client_optimizer!r}")
    return _multi_steps(opt) if cfg.accum_steps > 1 else opt


def tree_where(cond: torch.Tensor, new, old):
    """``torch.where(cond, new, old)`` over matching dicts and lists."""
    if isinstance(new, dict):
        return {k: tree_where(cond, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return [tree_where(cond, a, b) for a, b in zip(new, old)]
    return torch.where(cond, new, old)


# -- the batch schedule ------------------------------------------------------

class BatchSchedule(NamedTuple):
    """One client's steps (numpy on the host, or tensors on the data's
    device; a stacked schedule carries a leading client axis)."""

    # [epochs * nb, bsz] int64 row indices
    batch_idx: np.ndarray
    # [epochs * nb] the dropout seed of each step (63-bit ints; int64 once
    # stacked or on the device, where each step reads its 0-dim seed)
    step_seeds: List[int]
    has_real: np.ndarray    # [epochs * nb] bool: the batch holds a real row
    # gradient accumulation: the step emits the optimizer update, and the
    # divisor n + 1 of its micro-batch in the running mean (1.0 when off)
    emit: np.ndarray        # [epochs * nb] bool
    acc_div: np.ndarray     # [epochs * nb] float32

    def at(self, i) -> "BatchSchedule":
        """Client ``i`` of a stacked schedule."""
        return BatchSchedule(*(f[i] for f in self))


def accum_flags(has_real: np.ndarray, accum_steps: int):
    """MultiSteps' emit pattern as a pure function of the schedule: only
    real steps advance the mini-step counter, so real step ``j`` (from 0)
    has divisor ``j % k + 1`` and emits when that is ``k``. Padding-only
    steps emit nothing and divide by 1. ``accum_steps <= 1`` emits on
    every real step."""
    has_real = np.asarray(has_real, bool)
    mini = (np.cumsum(has_real) - 1) % max(1, accum_steps)
    emit = has_real & (mini == max(1, accum_steps) - 1)
    acc_div = np.where(has_real, mini + 1, 1).astype(np.float32)
    return emit, acc_div


def make_batch_schedule(n_pad: int, epochs: int, bsz: int, shuffle: bool,
                        seed: int, mask: Optional[np.ndarray] = None,
                        accum_steps: int = 1) -> BatchSchedule:
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
    has_real = is_real[batch_idx].any(axis=1)
    return BatchSchedule(batch_idx, step_seeds, has_real,
                         *accum_flags(has_real, accum_steps))


def stack_schedules(scheds: List[BatchSchedule]) -> BatchSchedule:
    """Clients' schedules stacked on a leading axis (numpy)."""
    return BatchSchedule(*(np.stack(f) for f in zip(*scheds)))


def device_batch_schedule(seeds: torch.Tensor, mask: torch.Tensor,
                          epochs: int, bsz: int, shuffle: bool,
                          accum_steps: int = 1) -> BatchSchedule:
    """The stacked schedule of ``k`` clients built on the device from their
    32-bit seeds (``[k]`` int64) and masks (``[k, n_pad]``), with no host
    work: the device-sampling mode's (``FusedRounds(device_sampling=True)``)
    counterpart of :func:`make_batch_schedule`, as the JAX package builds
    its order (``fedml_tpu/trainer/functional.py:165-176``): each epoch's
    order is the stable argsort of a per-row hash with padding rows last,
    so it is padding-invariant too. Its own stream: the host schedule's
    orders and seeds come from other generators."""
    k, n_pad = mask.shape
    if n_pad % bsz:
        raise ValueError(f"n_pad={n_pad} is not a multiple of bsz={bsz}")
    nb, dev = n_pad // bsz, mask.device
    epoch = torch.arange(epochs, dtype=torch.int64, device=dev)
    if shuffle:
        keys = fold32(fold32(seeds, 0)[:, None], epoch)     # [k, epochs]
        bits = counter_bits(keys, n_pad, dev)                # [k, e, n_pad]
        bits = torch.where(mask[:, None, :] > 0, bits, 1 << 32)
        order = torch.sort(bits, dim=-1, stable=True).indices
    else:
        order = torch.arange(n_pad, device=dev).expand(k, epochs, n_pad)
    batch_idx = order.reshape(k, epochs * nb, bsz)
    step_keys = fold32(fold32(seeds, 1)[:, None], epoch)    # [k, epochs]
    step_seeds = fold32(step_keys[..., None],
                        torch.arange(nb, device=dev)).reshape(k, -1)
    has_real = (mask.gather(1, batch_idx.reshape(k, -1)) > 0).reshape(
        k, -1, bsz).any(-1)
    k_acc = max(1, accum_steps)
    mini = (torch.cumsum(has_real, -1) - 1) % k_acc
    emit = has_real & (mini == k_acc - 1)
    acc_div = torch.where(has_real, mini + 1, 1).to(torch.float32)
    return BatchSchedule(batch_idx, step_seeds, has_real, emit, acc_div)


# -- one step, and local training -------------------------------------------

def make_forward(module: torch.nn.Module) -> Callable:
    """``forward(variables, x, train, generator=None)`` over a state dict;
    ``generator`` is a ``torch.Generator`` or a ``DropoutKey``."""

    def forward(variables, x, train: bool, generator=None):
        return functional_call(module, variables, (x,),
                               {"train": train, "generator": generator})

    return forward


def make_train_forward(module: torch.nn.Module) -> Callable:
    """``forward(variables, x, generator, *args) -> (out, colls)``: the
    train-mode forward over a state dict (``args`` follow ``x``, as DARTS's
    mixing weights do), with ``colls`` the new values of the collections it
    updated (``{"<layer>.running_mean": ..., ...}``, empty for a model
    without BatchNorm), never written into ``variables``."""
    owners = {m: name for name, m in module.named_modules()
              if isinstance(m, BatchNorm)}

    def forward(variables, x, generator, *args):
        with collect_batch_stats() as sink:
            out = functional_call(module, variables, (x, *args),
                                  {"train": True, "generator": generator})
        colls = {}
        for m, (mean, var) in sink.items():
            colls[f"{owners[m]}.running_mean"] = mean
            colls[f"{owners[m]}.running_var"] = var
        return out, colls

    return forward


def param_names(module: torch.nn.Module) -> set:
    """The state-dict names of ``module``'s parameters; the other names of
    its state dict are collections."""
    return {n for n, _ in module.named_parameters(remove_duplicate=False)}


def next_colls(colls, new) -> dict:
    """The collections after a step: the forward's new value of each one
    it updated, detached and in the collection's dtype (f32 under
    ``compute_dtype``), else the old value."""
    return {k: new[k].detach().to(v.dtype) if k in new else v
            for k, v in colls.items()}


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype) if t.is_floating_point() else t


def make_train_step(module: torch.nn.Module, task: str, cfg: TrainConfig):
    """Build ``(init, step)``: ``init(params) -> optimizer state`` and
    ``step(names, params, colls, state, xb, yb, mb, seed, lr_scale=None,
    has_real=None, emit=None, acc_div=None) -> (params, colls, state,
    stats)``, one SGD step of one client: ``params`` a list of tensors
    named by ``names``, ``colls`` the ``{name: tensor}`` collections (empty
    for a model without any), which come out of the train-mode forward.

    Under ``compute_dtype`` the params, the float inputs and the forward
    run in that dtype through explicit casts on the autograd path, and the
    output comes back ``.float()`` before the head, so the gradients, the
    optimizer and the stats stay f32 (not ``torch.autocast``, which keeps
    another set of ops in f32 than the JAX package). ``seed`` is the step's
    dropout seed (a Python int, or a 0-dim int64 tensor in a captured
    round); ``lr_scale`` a 0-dim f32 tensor or None.
    ``has_real`` (0-dim bool) gates the whole step into a no-op: params,
    optimizer state, collections and stats keep their old values (stats:
    zero)."""
    head: TaskHead = TASK_HEADS[task]
    forward = make_train_forward(module)
    opt = make_optimizer(cfg)
    cdtype = compute_dtype(cfg)

    def step(names, params, colls, state, xb, yb, mb, seed, lr_scale=None,
             has_real=None, emit=None, acc_div=None):
        leaves = [p.detach().requires_grad_(True) for p in params]
        variables = {**colls, **dict(zip(names, leaves))}
        if cdtype is not None:
            variables = {k: _cast(v, cdtype) for k, v in variables.items()}
            xb = _cast(xb, cdtype)
        out, new_colls = forward(variables, xb, DropoutKey(seed))
        if cdtype is not None:
            out = out.float()
        stats = head(out, yb, mb)
        loss = stats["loss_sum"] / stats["count"].clamp(min=1.0)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, new_state = opt.update(list(grads), state, params,
                                            emit, acc_div)
            if lr_scale is not None:
                updates = torch._foreach_mul(updates, lr_scale)
            new_params = torch._foreach_add(params, updates)
            new_colls = next_colls(colls, new_colls)
            stats = {k: v.detach() for k, v in stats.items()}
            if has_real is not None:
                new_params = tree_where(has_real, new_params, params)
                new_colls = tree_where(has_real, new_colls, colls)
                new_state = tree_where(has_real, new_state, state)
                stats = {k: torch.where(has_real, v, 0.0)
                         for k, v in stats.items()}
        return new_params, new_colls, new_state, stats

    return opt.init, step


def make_local_train(module: torch.nn.Module, task: str, cfg: TrainConfig):
    """Build ``local_train(variables, x, y, mask, seed, lr_scale=None,
    schedule=None, gated=False) -> (variables, stats)``.

    ``variables`` is a ``{name: tensor}`` state dict on the data's device;
    the result is a new state dict (the input is not modified), its
    parameters trained and its collections (BatchNorm statistics) as the
    last real step's forward left them. ``stats``
    are the summed head stats over the client's real steps. ``schedule``
    is the client's :class:`BatchSchedule`; without one it is built from
    ``mask`` (which then waits for the device). ``lr_scale`` is a 0-dim f32
    tensor (:func:`round_lr_scale`) or None.

    ``gated=False`` skips padding-only steps on the host (it reads
    ``schedule.has_real`` there); ``gated=True`` runs every step with the
    gate on the device, reads nothing on the host and so can be captured
    in a CUDA graph: then ``schedule``'s fields must be tensors on the
    data's device."""
    head: TaskHead = TASK_HEADS[task]
    forward = make_forward(module)
    init, step = make_train_step(module, task, cfg)
    accum = cfg.accum_steps > 1
    trained = param_names(module)

    def local_train(variables, x, y, mask, seed: int, lr_scale=None,
                    schedule: Optional[BatchSchedule] = None,
                    gated: bool = False):
        n_pad = x.shape[0]
        bsz = cfg.batch_size or n_pad
        if schedule is None:
            schedule = make_batch_schedule(n_pad, cfg.epochs, bsz,
                                           cfg.shuffle, seed,
                                           mask.cpu().numpy(),
                                           cfg.accum_steps)
        dev = x.device

        def on_dev(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        idx = on_dev(schedule.batch_idx, torch.int64)
        emit = on_dev(schedule.emit) if accum else None
        acc_div = on_dev(schedule.acc_div, torch.float32) if accum else None
        if gated:
            gate = on_dev(schedule.has_real)
            seeds = on_dev(schedule.step_seeds, torch.int64)
            steps = range(idx.shape[0])
        else:
            # the host reads the gates and the seeds (dropout's site keys
            # are then hashed on the host, not launched)
            has_real, seeds = (
                a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
                for a in (schedule.has_real, schedule.step_seeds))
            seeds = [int(v) for v in seeds]
            steps = np.flatnonzero(has_real)
        names = [k for k in variables if k in trained]
        params = [variables[k].detach() for k in names]
        colls = {k: v.detach() for k, v in variables.items()
                 if k not in trained}
        state = init(params)
        total = None
        for s in steps:
            rows = idx[s]
            params, colls, state, stats = step(
                names, params, colls, state, x[rows], y[rows], mask[rows],
                seeds[s], lr_scale, gate[s] if gated else None,
                emit[s] if accum else None, acc_div[s] if accum else None)
            total = stats if total is None else {
                k: total[k] + stats[k] for k in total}
        if total is None:  # no real row at all: zero stats, params as given
            with torch.no_grad():
                total = {k: torch.zeros_like(v) for k, v in head(
                    forward(variables, x[:1], False), y[:1],
                    torch.zeros_like(mask[:1])).items()}
        out = {**colls, **dict(zip(names, params))}
        return {k: out[k] for k in variables}, total

    return local_train


def make_eval(module: torch.nn.Module, task: str,
              eval_batch_size: int = 512):
    """Build ``evaluate(variables, x, y, mask) -> stat sums`` over fixed
    eval batches in deterministic mode (no dropout, BatchNorm on its
    running statistics), the analogue of the reference's
    ``ModelTrainer.test`` loop (MyModelTrainer.py:51-96)."""
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


def _add_stats(total, stats):
    if total is None:
        return dict(stats)
    return {k: total[k] + stats[k] for k in total}
