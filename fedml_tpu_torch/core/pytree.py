"""State-dict algebra.

The JAX package carries model state as a pytree; here it is a flat
``{name: tensor}`` dict in the module's ``state_dict`` order (the
reference's own currency, FedAVGAggregator.py:58-87). Leaf order is dict
insertion order, which is what ``tree_ravel``/``tree_unravel`` and the
aggregation front end rely on.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

StateDict = Dict[str, torch.Tensor]


def tree_zeros_like(tree: StateDict) -> StateDict:
    """Zeros of every leaf's shape and dtype."""
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_scale(tree: StateDict, s) -> StateDict:
    """Leafwise ``x * s``."""
    return {k: v * s for k, v in tree.items()}


def tree_axpy(a, x: StateDict, y: StateDict) -> StateDict:
    """Leafwise ``a * x + y``."""
    return {k: a * x[k] + y[k] for k in x}


def tree_dot(a: StateDict, b: StateDict) -> torch.Tensor:
    """Sum of elementwise products across the whole state dict (a 0-dim
    tensor), summed leaf by leaf in leaf order."""
    dots = [torch.vdot(a[k].reshape(-1), b[k].reshape(-1)) for k in a]
    return torch.stack(dots).sum() if dots else torch.zeros(())


def tree_norm(tree: StateDict) -> torch.Tensor:
    """Global L2 norm over all leaves."""
    return torch.sqrt(tree_dot(tree, tree))


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


def tree_mean(stacked: StateDict) -> StateDict:
    """Unweighted mean over the leading axis of every leaf."""
    return {k: v.mean(dim=0) for k, v in stacked.items()}


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


def tree_unstack(stacked: StateDict, n: int) -> List[StateDict]:
    """Inverse of :func:`tree_stack`: a list of ``n`` state dicts."""
    return [tree_index(stacked, i) for i in range(n)]


def tree_index(stacked: StateDict, i) -> StateDict:
    """Slice client ``i`` out of a stacked state dict."""
    return {k: v[i] for k, v in stacked.items()}


def tree_cast(tree: StateDict, dtype) -> StateDict:
    return {k: v.to(dtype) for k, v in tree.items()}


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


def tree_map_with_path_filter(fn: Callable, tree: StateDict,
                              predicate: Callable[[str], bool]) -> StateDict:
    """Apply ``fn`` only to the leaves whose name satisfies ``predicate``;
    the other leaves pass through unchanged. Names are the state dict's
    dotted module paths (``conv1.weight``, ``bn.running_mean``), where the
    JAX package's filter sees flax's ``/``-joined key paths. With
    ``core.robust.is_weight_param`` as the predicate it is the reference's
    weight-param filter (robust_aggregation.py:28-36); the defenses in
    ``core/robust.py`` apply that predicate in their own loops, since a
    clipped or noised leaf needs its name and position as well."""
    return {k: fn(v) if predicate(k) else v for k, v in tree.items()}
