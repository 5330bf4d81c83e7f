"""Delta compression for the cross-silo wire: int8 and top-k + EF payloads.

The counterpart of ``fedml_tpu/comm/compression.py``. The reference ships
every model update at full precision (pickled tensors over MPI,
mpi_send_thread.py:27; JSON float lists over MQTT, fedavg/utils.py:12).
Here two payload families compress the DELTA against a base model both
ends hold:

- ``delta_int8``: int8 block-scaled quantization of the full delta (4x)
  with the hand-written kernels (ops/quantize.py). Stochastic rounding
  keeps the quantizer unbiased, so the server's weighted mean of
  dequantized deltas is an unbiased estimate of the uncompressed one.
- ``topk_ef`` / ``topk_ef_int8``: magnitude top-k sparsification of the
  delta (ops/sparsify.py), optionally int8-quantizing the survivors. Top-k
  is biased: callers MUST run the error-feedback loop; :func:`compress_topk`
  returns the un-sent residual, which the caller adds to the next delta.

Models are state dicts (``{name: tensor}``) on one device; the encode runs
there (the kernels on a CUDA tensor, their plain versions on a CPU one) and
the payload is a plain dict of numpy arrays and scalars, ready for the
codec. The receiver rebuilds against its own base on the base's device.

Random bits: ``key`` is either a ``torch.Generator``, from which the bits
are drawn on its device, or an int32 tensor of precomputed bits (at least
as many as the quantizer takes; the tests pass the JAX package's bits).

The structure fingerprint hashes each leaf's (state-dict name, shape,
dtype). The JAX package hashes flax key paths instead, so a JAX peer and a
port peer do not share a wire (out of scope).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from fedml_tpu_torch.comm import serialization
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.ops.quantize import (dequantize_tree, flatten,
                                          quantize_tree, random_bits,
                                          unflatten_like)
from fedml_tpu_torch.ops.sparsify import (k_for, topk_dequantize,
                                          topk_densify, topk_quantize,
                                          topk_sparsify)

COMPRESSED_FLAG = "__delta_int8__"
TOPK_FLAG = "__topk_ef__"

Key = Union[torch.Generator, torch.Tensor]
Tree = Dict[str, Any]


def _bits(key: Key, n: int, device: torch.device) -> torch.Tensor:
    """``n`` random uint32 words (int32) on ``device``: drawn from a
    generator, or the first ``n`` of a precomputed bits tensor."""
    if isinstance(key, torch.Generator):
        if torch.device(key.device).type != device.type:
            raise ValueError(f"generator on {key.device}, data on {device}")
        return random_bits(n, key)
    if key.numel() < n:
        raise ValueError(f"{key.numel()} random words for {n} values")
    return key.reshape(-1)[:n].to(device)


def _dtype_name(leaf) -> str:
    dtype = leaf.dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def tree_fingerprint(tree: Tree) -> str:
    """Structure hash over each leaf's (name, shape, dtype), the same for a
    state dict of tensors and its numpy copy.

    A parameter count alone admits version skew that keeps the count (a
    transposed layer, swapped widths) and would silently corrupt the
    rebuilt model; the fingerprint rejects it."""
    parts = [f"{k}:{tuple(np.shape(v))}:{_dtype_name(v)}"
             for k, v in tree.items()]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def to_numpy(tree: Tree) -> Dict[str, np.ndarray]:
    """A state dict as host numpy arrays (the wire's currency)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A wire array (often a read-only view into a received frame) as a
    tensor on ``device``, copied so it never aliases the frame."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tree_to_device(tree: Tree, device: torch.device) -> Dict[str,
                                                             torch.Tensor]:
    return {k: to_device(v, device) for k, v in tree.items()}


def _device_of(tree: Tree) -> torch.device:
    return next(iter(tree.values())).device


def compress_delta(new_tree: Tree, base_tree: Tree,
                   key: Key) -> Dict[str, Any]:
    """int8-quantize ``new - base``; returns a codec-ready payload dict (no
    structure on the wire: the receiver rebuilds against its own base)."""
    delta = pt.tree_sub(new_tree, base_tree)
    d = pt.tree_size(delta)
    vals, scales, _ = quantize_tree(delta, _bits(key, d, _device_of(delta)))
    return {COMPRESSED_FLAG: True, "q": vals.cpu().numpy(),
            "s": scales.cpu().numpy(), "d": d,
            "fp": tree_fingerprint(base_tree)}


def _check_base(payload: Dict[str, Any], base_tree: Tree) -> int:
    """Shared skew guards: parameter count + structure fingerprint."""
    expected = pt.tree_size(base_tree)
    if int(payload["d"]) != expected:
        raise ValueError(
            f"compressed delta carries {payload['d']} parameters but the "
            f"receiver's model has {expected}: model-version skew or a "
            "malformed payload; refusing to rebuild")
    if "fp" in payload:
        fp = tree_fingerprint(base_tree)
        if payload["fp"] != fp:
            raise ValueError(
                f"compressed delta structure fingerprint {payload['fp']} "
                f"does not match the receiver's model ({fp}): the sender "
                "trained a differently-shaped model; refusing to rebuild")
    return expected


def decompress_delta(payload: Dict[str, Any], base_tree: Tree) -> Tree:
    """Rebuild the full model: base + dequantized delta (leaf names, order
    and shapes from the receiver's own ``base_tree``)."""
    d = _check_base(payload, base_tree)
    dev = _device_of(base_tree)
    spec = ([(k, tuple(v.shape), v.dtype) for k, v in base_tree.items()], d)
    delta = dequantize_tree(to_device(payload["q"], dev),
                            to_device(payload["s"], dev), spec)
    return pt.tree_add(base_tree, delta)


def compress_topk(new_tree: Tree, base_tree: Tree,
                  residual: Optional[torch.Tensor], key: Key, *,
                  frac: float = 0.01, quantize: bool = True):
    """Top-k (+ optional int8) compress ``(new - base) + residual``.

    Returns ``(payload, new_residual)``: the payload dict and the flat f32
    error-feedback residual the caller must carry into the NEXT call (pass
    ``None`` the first time). Dropping the residual turns the biased top-k
    into plain, non-converging truncation. The flat delta is a fresh
    temporary, so the residual is written into it in place."""
    flat = flatten(pt.tree_sub(new_tree, base_tree))
    d = flat.numel()
    if residual is not None:
        flat += residual.to(flat.device)
    k = k_for(d, frac)
    payload: Dict[str, Any] = {TOPK_FLAG: True, "d": d,
                               "fp": tree_fingerprint(base_tree)}
    if quantize:
        idx, q, scales, res = topk_quantize(
            flat, _bits(key, k, flat.device), k, inplace=True)
        payload.update(i=idx.cpu().numpy(), q=q.cpu().numpy(),
                       s=scales.cpu().numpy())
    else:
        idx, vals, res = topk_sparsify(flat, k, inplace=True)
        payload.update(i=idx.cpu().numpy(), v=vals.cpu().numpy())
    return payload, res


def decompress_topk(payload: Dict[str, Any], base_tree: Tree) -> Tree:
    """Rebuild the full model from a :func:`compress_topk` payload: base +
    the densified sparse delta."""
    d = _check_base(payload, base_tree)
    idx = np.asarray(payload["i"])
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= d):
        # a scatter would fail or write out of bounds: refuse a corrupted
        # frame loudly, like every other malformed-payload path here
        raise ValueError(
            f"top-k payload carries indices outside [0, {d}): corrupted or "
            "malformed frame; refusing to rebuild")
    dev = _device_of(base_tree)
    if "q" in payload:
        dense = topk_dequantize(to_device(idx, dev),
                                to_device(payload["q"], dev),
                                to_device(payload["s"], dev), d)
    else:
        dense = topk_densify(to_device(idx, dev),
                             to_device(payload["v"], dev), d)
    return pt.tree_add(base_tree, unflatten_like(dense, base_tree))


def decompress(payload: Dict[str, Any], base_tree: Tree) -> Tree:
    """Rebuild any compressed payload family against ``base_tree``."""
    if payload.get(TOPK_FLAG):
        return decompress_topk(payload, base_tree)
    return decompress_delta(payload, base_tree)


def compress_for_policy(new_tree: Tree, base_tree: Tree,
                        residual: Optional[torch.Tensor], key: Key, policy):
    """Encode ``new_tree`` against ``base_tree`` per a CompressionPolicy
    (comm/policy.py). Returns ``(payload, new_residual)``; the residual is
    None for the non-top-k policies (int8 stochastic rounding is unbiased,
    so no error feedback is needed)."""
    if policy.uplink_topk:
        return compress_topk(new_tree, base_tree, residual, key,
                             frac=policy.topk_frac,
                             quantize=policy.uplink_int8)
    if policy.name == "delta_int8":
        return compress_delta(new_tree, base_tree, key), None
    return to_numpy(new_tree), None


def is_compressed(payload) -> bool:
    return isinstance(payload, dict) and bool(
        payload.get(COMPRESSED_FLAG) or payload.get(TOPK_FLAG))


def wire_bytes(payload) -> int:
    """The payload's size on the wire: the encoded frame's length (header,
    scalars and framing included)."""
    return sum(len(p) for p in serialization.dumps_parts(payload))
