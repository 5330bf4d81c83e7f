"""State-dict algebra.

The JAX package carries model state as a pytree; here it is a flat
``{name: tensor}`` dict in the module's ``state_dict`` order (the
reference's own currency, FedAVGAggregator.py:58-87). Leaf order is dict
insertion order, which is what ``tree_ravel``/``tree_unravel`` and the
aggregation front end rely on.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

StateDict = Dict[str, torch.Tensor]


def tree_weighted_mean(stacked: StateDict, weights: torch.Tensor) -> StateDict:
    """Weighted mean over the leading axis of every leaf.

    ``stacked`` holds leaves with a leading ``num_clients`` axis;
    ``weights`` is ``[num_clients]``. Normalizes by ``weights.sum()``, the
    sample-weighted FedAvg rule (reference FedAVGAggregator.py:72-80)."""
    total = weights.sum()

    def leaf_mean(x):
        w = weights.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
        return (x * w).sum(dim=0) / total.to(x.dtype)

    return {k: leaf_mean(v) for k, v in stacked.items()}


def tree_add(a: StateDict, b: StateDict) -> StateDict:
    """Leafwise ``a + b``."""
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: StateDict, b: StateDict) -> StateDict:
    """Leafwise ``a - b``."""
    return {k: a[k] - b[k] for k in a}


# -- streaming weighted fold --------------------------------------------------
# The three steps of a weighted mean computed as an in-order left fold:
#   acc = init(x_0, w_0); acc = step(acc, x_i, w_i) ...; out = finish(acc, W)
# Folding updates one at a time, as they arrive, instead of stacking the
# cohort lets the cross-silo server aggregate with O(1) live state. The fold
# is the canonical reduction: two evaluations that apply these steps in the
# same index order give bit-identical results. Weights are f32 scalars
# (numpy float32 or Python floats holding one); a Python float multiplies
# an f32 tensor in f32.

def tree_weighted_fold_init(x: StateDict, w) -> StateDict:
    """First fold term: ``x * w`` per leaf. Deliberately not zeros + add:
    ``0.0 + (-0.0)`` is ``+0.0``, so seeding with zeros would flip signed
    zeros."""
    return {k: v * float(w) for k, v in x.items()}


def tree_weighted_fold_step(acc: StateDict, x: StateDict, w) -> StateDict:
    """Fold one update in: ``acc + x * w`` per leaf."""
    return {k: acc[k] + x[k] * float(w) for k in acc}


def tree_fold_finish(acc: StateDict, total) -> StateDict:
    """Normalize the folded sum by the total weight."""
    return {k: v / float(total) for k, v in acc.items()}


def tree_stack(trees: Sequence[StateDict]) -> StateDict:
    """Stack congruent state dicts along a new leading axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def tree_size(tree: StateDict) -> int:
    """Total number of scalars in the state dict."""
    return sum(v.numel() for v in tree.values())


def tree_ravel(tree: StateDict) -> torch.Tensor:
    """Flatten every leaf, in leaf order, into one 1-D vector."""
    if not tree:
        return torch.zeros(0)
    return torch.cat([v.reshape(-1) for v in tree.values()])


def tree_unravel(tree_like: StateDict, flat: torch.Tensor) -> StateDict:
    """Inverse of :func:`tree_ravel` given a template state dict."""
    out, off = {}, 0
    for k, leaf in tree_like.items():
        n = leaf.numel()
        out[k] = flat[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
    return out
