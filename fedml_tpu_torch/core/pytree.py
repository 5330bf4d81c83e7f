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
