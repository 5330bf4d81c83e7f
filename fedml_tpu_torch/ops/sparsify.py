"""Magnitude top-k sparsification for the cross-silo wire (DGC-style).

The counterpart of ``fedml_tpu/ops/sparsify.py``. Deep Gradient
Compression (Lin et al., 2018) ships only the largest-magnitude entries of
the model delta; the int8 quantizer (ops/quantize.py) compresses the
survivors further. Top-k is a BIASED compressor, so the un-sent remainder
must be fed back: the caller adds the returned ``residual`` to the next
round's delta before compressing again (EF-SGD, Karimireddy et al., 2019).

The wire contract is "largest |x| first, lowest index on ties", what
``jax.lax.top_k`` does. ``torch.topk`` promises neither order, so the
selection is a stable descending sort of ``|x|``. The selection runs
outside any kernel in the JAX package too (XLA's top_k); only the int8
quantize and dequantize of the survivors are the hand-written kernels.

The JAX package's ``*_donated`` variants exist for XLA buffer donation;
here :func:`topk_sparsify` takes ``inplace=True`` and writes the residual
into the caller's flat temporary instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fedml_tpu_torch.ops.quantize import dequantize_int8, quantize_int8


def k_for(d: int, frac: float) -> int:
    """Survivor count for a ``d``-entry delta at keep-fraction ``frac``
    (ceil, clamped to [1, d] so degenerate tiny models still send)."""
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"topk fraction {frac} outside (0, 1]")
    return max(1, min(d, math.ceil(d * frac)))


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``|x|``, largest first, lowest index
    first among equal magnitudes (int64)."""
    return torch.sort(x.abs(), descending=True, stable=True).indices[:k]


def topk_sparsify(x: torch.Tensor, k: int, inplace: bool = False):
    """Keep the ``k`` largest-|x| entries of a flat ``[d]`` f32 vector.

    Returns ``(idx int32[k], vals f32[k], residual f32[d])``, where
    ``residual`` is ``x`` with the selected entries set to +0.0: exactly
    the mass the wire does NOT carry. ``inplace=True`` writes the residual
    into ``x`` itself (a caller's flat temporary) instead of a copy."""
    idx = topk_indices(x, k)
    vals = x[idx]
    residual = x if inplace else x.clone()
    residual[idx] = 0.0
    return idx.to(torch.int32), vals, residual


def topk_sparsify_reference(x, k: int):
    """Pure-numpy parity oracle for :func:`topk_sparsify`, the JAX
    package's own: a stable descending argsort over ``|x|``."""
    x = np.asarray(x, np.float32)
    k = max(1, min(int(x.size), int(k)))
    idx = np.argsort(-np.abs(x), kind="stable")[:k].astype(np.int32)
    vals = x[idx]
    residual = x.copy()
    residual[idx] = 0.0
    return idx, vals, residual


def topk_densify(idx: torch.Tensor, vals: torch.Tensor,
                 d: int) -> torch.Tensor:
    """Scatter sparse ``(idx, vals)`` back to a dense ``[d]`` f32 vector."""
    out = torch.zeros(d, dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals.to(torch.float32)
    return out


def topk_quantize(x: torch.Tensor, bits: torch.Tensor, k: int,
                  inplace: bool = False):
    """Sparsify, then int8-quantize the survivors (the uplink hot path).

    ``bits`` are the quantizer's random bits for the ``k`` survivors.
    Returns ``(idx int32[k], q int8[k], scales f32[ceil(k/512)],
    residual f32[d])``. The residual charges BOTH error sources: the
    dropped entries keep their full value, and each kept slot becomes
    ``0.0 + (val - q * scale)``, the add of the JAX package's
    ``residual.at[idx].add`` (it turns a -0.0 error into +0.0).
    ``val - q * scale`` comes from the quantize kernel itself, in the same
    launch, rounded once, as XLA fuses the JAX package's ``vals -
    dequantize(q)``."""
    idx, vals, residual = topk_sparsify(x, k, inplace=inplace)
    q, scales, err = quantize_int8(vals, bits, residual=True)
    residual[idx.long()] += err
    return idx, q, scales, residual


def topk_dequantize(idx: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                    d: int) -> torch.Tensor:
    """Inverse of :func:`topk_quantize`: the dense ``[d]`` f32 rebuild."""
    vals = dequantize_int8(q, scales, q.numel())
    return topk_densify(idx, vals, d)
