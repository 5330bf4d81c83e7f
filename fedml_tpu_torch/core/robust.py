"""Robust aggregation: the per-update defenses (norm-diff clipping, weak
DP) and the Byzantine-robust rules (coordinate median, trimmed mean,
(multi-)Krum), over stacked state dicts.

The counterpart of ``fedml_tpu/core/robust.py`` (reference
``RobustAggregator``, fedml_core/robustness/robust_aggregation.py:32-55).
Every function takes the clients' state dicts stacked on a leading ``[C]``
axis, where the JAX package maps a one-client function over them with
``vmap``. Nothing here reads a tensor on the host and every check is on a
shape, so a CUDA graph captures each of them inside the round.

The weight filter follows the reference (robust_aggregation.py:28): BN
running statistics take no clipping and no noise. It matches whole parts of
the state dict's dotted names (``bn.running_mean``), where the JAX package
splits flax's ``/`` paths.

Weak DP's noise comes from the port's counter hash (core/sampling.py), not
from ``jax.random``: element ``e`` of leaf ``j`` of the ``i``-th client of a
round draws ``N(0, stddev**2)`` through Box-Muller from the hashes of
(aggregation seed, i, j, e), so a replayed graph draws the same noise as
the host loop.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fedml_tpu_torch.core.pytree import StateDict
from fedml_tpu_torch.core.sampling import counter_bits, fold32

_NON_WEIGHT_MARKERS = ("running_mean", "running_var", "num_batches_tracked",
                       "batch_stats", "mean", "var")


def is_weight_param(name: str) -> bool:
    """True unless a part of the dotted name marks BN running statistics."""
    parts = name.lower().split(".")
    return not any(m in parts for m in _NON_WEIGHT_MARKERS)


def _clients(stacked: StateDict) -> int:
    return next(iter(stacked.values())).shape[0]


def _per_client(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A ``[C]`` vector shaped to broadcast over a ``[C, ...]`` leaf."""
    return v.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def norm_diff_clipping(stacked: StateDict, global_vars: StateDict,
                       norm_bound: float) -> StateDict:
    """Clip each client's L2 displacement from the global model: over the
    weight leaves, ``diff = local - global`` and ``scale = 1 / max(1,
    ||diff|| / bound)``; returns ``global + scale * diff``, the other leaves
    untouched (reference robust_aggregation.py:38-49)."""
    c = _clients(stacked)
    names = [k for k in stacked if is_weight_param(k)]
    if not names:
        return dict(stacked)
    sq = sum(((stacked[k] - global_vars[k]).reshape(c, -1) ** 2).sum(1)
             for k in names)
    scale = 1.0 / torch.clamp(torch.sqrt(sq) / norm_bound, min=1.0)
    out = dict(stacked)
    for k in names:
        g = global_vars[k]
        out[k] = g + (stacked[k] - g) * _per_client(scale, stacked[k])
    return out


def _key32(seed):
    """A 63-bit seed (a Python int, or an int64 tensor) folded to 32 bits,
    as ``DropoutKey`` folds a step seed."""
    if torch.is_tensor(seed):
        seed = seed.to(torch.int64)
    return (seed ^ (seed >> 32)) & 0xFFFFFFFF


def counter_normal(keys: torch.Tensor, n: int, device) -> torch.Tensor:
    """Standard normal f32 draws ``[..., n]`` from 32-bit keys (``[...]``
    int64) through Box-Muller over two counter-hash streams: ``u1`` in
    (0, 1) and ``u2`` in [0, 1), 24 bits each."""
    u1 = ((counter_bits(fold32(keys, 0), n, device) >> 8).to(torch.float32)
          + 0.5) * 2.0 ** -24
    u2 = (counter_bits(fold32(keys, 1), n, device) >> 8).to(
        torch.float32) * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def add_weak_dp_noise(stacked: StateDict, stddev: float, agg_seed
                      ) -> StateDict:
    """Add ``N(0, stddev**2)`` to every weight leaf of every client
    (reference add_noise, robust_aggregation.py:51-55), skipping BN
    statistics. ``agg_seed`` is the round's aggregation seed (a Python int,
    or a 0-dim int64 tensor in a captured round): client ``i``'s leaf ``j``
    draws from the keys of (seed, i, j)."""
    c = _clients(stacked)
    device = next(iter(stacked.values())).device
    client_keys = fold32(_key32(agg_seed),
                         torch.arange(c, dtype=torch.int64, device=device))
    out = {}
    for j, (k, leaf) in enumerate(stacked.items()):
        if not is_weight_param(k):
            out[k] = leaf
            continue
        noise = counter_normal(fold32(client_keys, j), leaf[0].numel(),
                               device)
        out[k] = leaf + stddev * noise.reshape(leaf.shape).to(leaf.dtype)
    return out


DEFENSES = ("none", "norm_diff_clipping", "weak_dp")


def apply_defense(stacked: StateDict, global_vars: StateDict,
                  defense_type: Optional[str], norm_bound: float,
                  stddev: float, agg_seed) -> StateDict:
    """The reference's --defense_type dispatch (norm_diff_clipping |
    weak_dp | None); weak_dp clips, then adds noise."""
    if defense_type is None or defense_type == "none":
        return stacked
    if defense_type == "norm_diff_clipping":
        return norm_diff_clipping(stacked, global_vars, norm_bound)
    if defense_type == "weak_dp":
        clipped = norm_diff_clipping(stacked, global_vars, norm_bound)
        return add_weak_dp_noise(clipped, stddev, agg_seed)
    raise ValueError(f"unknown defense_type: {defense_type!r}")


# -- Byzantine-robust aggregation rules (beyond the reference's pair) -------
# Each replaces the weighted mean and treats clients uniformly (a Byzantine
# client can lie about its sample count).


def coordinate_median(stacked: StateDict) -> StateDict:
    """Coordinate-wise median over the client axis (Yin et al., 2018), as
    ``jnp.median``: with an even client count the mean of the two middle
    values, ``(lo + hi) * 0.5`` (``torch.median`` would return the lower
    one)."""
    def med(leaf):
        c = leaf.shape[0]
        s = torch.sort(leaf, dim=0).values
        if c % 2:
            return s[c // 2]
        return (s[c // 2 - 1] + s[c // 2]) * 0.5
    return {k: med(v) for k, v in stacked.items()}


def trimmed_mean(stacked: StateDict, trim_ratio: float = 0.1) -> StateDict:
    """Coordinate-wise beta-trimmed mean: drop the ``beta * C`` smallest and
    largest values per coordinate, average the rest (Yin et al., 2018). A
    positive ``trim_ratio`` trims at least one value from each end."""
    def tm(leaf):
        c = leaf.shape[0]
        t = max(1, int(trim_ratio * c)) if trim_ratio > 0 else 0
        if 2 * t >= c:
            raise ValueError(
                f"trim_ratio {trim_ratio} with {c} clients would trim "
                f"{2 * t} >= {c} values — need more clients or less trim")
        s = torch.sort(leaf, dim=0).values
        return (s[t:c - t] if t else s).mean(dim=0)
    return {k: tm(v) for k, v in stacked.items()}


def _gram_f32(flat: torch.Tensor) -> torch.Tensor:
    """``flat @ flat.T`` in full f32: TF32 off for the product."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return flat @ flat.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def krum_scores(stacked: StateDict, num_byzantine: int) -> torch.Tensor:
    """Each client's Krum score: the sum of its squared distances to its
    ``C - f - 2`` nearest neighbours (Blanchard et al., 2017); lower is
    more trustworthy. Distances from the Gram matrix of the centered
    updates (pairwise distances are translation invariant, and centering
    keeps ``|a|^2 + |b|^2 - 2 a.b`` from cancelling)."""
    c = _clients(stacked)
    flat = torch.cat([v.reshape(c, -1).to(torch.float32)
                      for v in stacked.values()], dim=1)
    flat = flat - flat.mean(dim=0, keepdim=True)
    sq = (flat * flat).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * _gram_f32(flat),
                     min=0.0)
    d2 = d2 + torch.diag(torch.full((c,), math.inf, device=d2.device))
    k = max(1, c - num_byzantine - 2)
    return torch.sort(d2, dim=1).values[:, :k].sum(dim=1)


def krum(stacked: StateDict, num_byzantine: int, multi_m: int = 1
         ) -> StateDict:
    """(Multi-)Krum: the mean of the ``multi_m`` lowest-scoring clients
    (a stable order: tied scores pick the lower position). Needs ``C >=
    2f + 3`` for its guarantee, enforced."""
    c = _clients(stacked)
    if c < 2 * num_byzantine + 3:
        raise ValueError(
            f"Krum needs C >= 2f + 3 (C={c}, f={num_byzantine})")
    chosen = torch.argsort(krum_scores(stacked, num_byzantine),
                           stable=True)[:multi_m]
    return {k: v[chosen].mean(dim=0) for k, v in stacked.items()}


ROBUST_AGGREGATORS = {
    "median": coordinate_median,
    "trimmed_mean": trimmed_mean,
    "krum": krum,
}
