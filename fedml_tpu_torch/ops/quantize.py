"""Block-scaled int8 quantization for the compressed cross-silo wire.

The counterpart of ``fedml_tpu/ops/quantize.py``. A flat f32 vector becomes
int8 values plus one f32 scale per 512-value block, with stochastic
rounding (unbiased: E[q] = x, so the server's weighted mean of dequantized
deltas stays unbiased). The random bits are an input, one uint32 a value,
as on the TPU, so the tests can hand both packages the same bits.

On a CUDA tensor, :func:`quantize_int8` and :func:`dequantize_int8` launch
the hand-written Hopper kernels in ``csrc/quantize.cu`` (the counterparts
of the Pallas kernels ``_quant_kernel`` and ``_dequant_kernel``); on a CPU
tensor they run the plain versions :func:`quantize_int8_reference` and
:func:`dequantize_int8_reference`. ``quantize_int8(..., residual=True)``
also returns the quantization error ``x - dequantize(q)`` (rounded once),
from the quantize kernel's registers: top-k's error feedback encodes in
one launch. There is no fallback between the two: a
CUDA tensor launches the kernel or raises. Both routes are bit-exact
against the TPU kernels: the scale is ``max(absmax, 1e-12) * f32(1/127)``
(XLA turns the TPU kernel's ``/ 127.0`` into that multiply), ``x / scale``
is a true division, and ``bits >> 8`` is a logical shift of a uint32.

Random bits travel as int32 tensors holding the uint32 bit pattern (torch
has no full uint32 arithmetic); uint32 tensors are accepted too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.ops.build import load_library
from fedml_tpu_torch.utils.flops import is_fake

BLOCK = 512  # values per scale block
#: f32(1/127) = 0x3C010204, the reciprocal XLA multiplies by
INV127 = float(np.float32(1.0 / 127.0))


@functools.cache
def _kernel():
    """The built library with every launcher's signature declared (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    lib = load_library("quantize").lib
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fedml_quantize_int8.argtypes = [p, p, p, p, p, i64, p]
    lib.fedml_quantize_int8.restype = ctypes.c_int
    lib.fedml_dequantize_int8.argtypes = [p, p, p, p, i64, p]
    lib.fedml_dequantize_int8.restype = ctypes.c_int
    lib.fedml_empty_kernel.argtypes = [p]
    lib.fedml_empty_kernel.restype = ctypes.c_int
    lib.fedml_quantize_int8_is_vec.argtypes = [p, p, p, p]
    lib.fedml_quantize_int8_is_vec.restype = ctypes.c_int
    lib.fedml_dequantize_int8_is_vec.argtypes = [p, p, p]
    lib.fedml_dequantize_int8_is_vec.restype = ctypes.c_int
    lib.fedml_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def num_blocks(d: int) -> int:
    """Scale blocks of a ``d``-value vector: ``ceil(d / BLOCK)``."""
    return -(-d // BLOCK)


def random_bits(n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform uint32 words as an int32 tensor, drawn on the
    generator's device (every bit pattern, top bit included)."""
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                         generator=generator, device=generator.device)


def _as_int32_bits(bits: torch.Tensor) -> torch.Tensor:
    if bits.dtype == getattr(torch, "uint32", None):
        return bits.view(torch.int32)
    if bits.dtype != torch.int32:
        raise TypeError(f"bits must be int32 or uint32, got {bits.dtype}")
    return bits


def _check_quant_inputs(x: torch.Tensor, bits: torch.Tensor):
    if x.dim() != 1 or x.dtype != torch.float32:
        raise TypeError(f"x must be a flat float32 vector, got {x.dtype} "
                        f"{tuple(x.shape)}")
    bits = _as_int32_bits(bits)
    if tuple(bits.shape) != tuple(x.shape):
        raise ValueError(f"bits {tuple(bits.shape)} must match x "
                         f"{tuple(x.shape)}")
    if bits.device != x.device:
        raise ValueError(f"bits on {bits.device}, x on {x.device}")
    return bits


def quantize_int8_reference(x: torch.Tensor, bits: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, the TPU kernel's arithmetic on zero-padded
    ``[rows, 512]`` blocks: returns ``(int8 [D], f32 scales [rows])``."""
    bits = _check_quant_inputs(x, bits)
    d, rows = x.numel(), num_blocks(x.numel())
    xp = torch.zeros(rows * BLOCK, dtype=torch.float32, device=x.device)
    xp[:d] = x
    # the logical shift of a uint32: widen to int64 and mask the sign
    # extension away before shifting
    bp = torch.zeros(rows * BLOCK, dtype=torch.int64, device=x.device)
    bp[:d] = bits.to(torch.int64) & 0xFFFFFFFF
    xp, bp = xp.view(rows, BLOCK), bp.view(rows, BLOCK)
    # amax and clamp keep NaN: a NaN block gets a NaN scale and q = 0
    absmax = xp.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp(min=1e-12) * INV127
    scaled = xp / scale
    u = (bp >> 8).to(torch.float32) * 2.0**-24
    low = torch.floor(scaled)
    q = (low + (u < scaled - low).to(torch.float32)).clamp(-127.0, 127.0)
    q = torch.nan_to_num(q, nan=0.0)
    return q.to(torch.int8).reshape(-1)[:d], scale[:, 0]


def dequantize_int8_reference(values: torch.Tensor, scales: torch.Tensor,
                              subtract_from: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain version: ``float(q) * scale[i // 512]`` as f32 ``[D]``,
    or ``subtract_from - float(q) * scale`` rounded once.

    The single rounding goes through f64: ``q * scale`` is exact there (8
    by 24 bits), and so is the difference, except where ``|q| = 1`` and
    ``|v|`` is below ``2**-28 * scale``; there ``scale - |v|`` rounds to
    ``scale`` from f64 as from the exact value."""
    d = values.numel()
    per_value = scales.to(torch.float32).repeat_interleave(BLOCK)[:d]
    if subtract_from is None:
        return values.to(torch.float32) * per_value
    return (subtract_from.double()
            - values.double() * per_value.double()).float()


def quantize_int8(x: torch.Tensor, bits: torch.Tensor,
                  residual: bool = False) -> Tuple[torch.Tensor, ...]:
    """Quantize a flat f32 vector to ``(int8 values [D], f32 scales
    [ceil(D/512)])`` with stochastic rounding from ``bits`` (one uint32 a
    value, as int32 or uint32). With ``residual=True`` it returns ``(q,
    scales, x - dequantize(q))`` instead, the error rounded once, as
    :func:`dequantize_int8` with ``subtract_from=x`` computes it. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (one
    launch either way), counted in ``quantize_int8.launches``. A fake
    tensor (the FLOP counter's, utils/flops.py) takes the plain version,
    which it bills."""
    bits = _check_quant_inputs(x, bits)
    if x.device.type == "cpu" or is_fake(x):
        q, scales = quantize_int8_reference(x, bits)
        if residual:
            return q, scales, dequantize_int8_reference(q, scales, x)
        return q, scales
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, bits = x.contiguous(), bits.contiguous()
    d = x.numel()
    q = torch.empty(d, dtype=torch.int8, device=x.device)
    scales = torch.empty(num_blocks(d), dtype=torch.float32, device=x.device)
    res = torch.empty_like(x) if residual else None
    out = (q, scales, res) if residual else (q, scales)
    if d == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(x.device):
        rc = lib.fedml_quantize_int8(
            x.data_ptr(), bits.data_ptr(), q.data_ptr(), scales.data_ptr(),
            None if res is None else res.data_ptr(), d,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("quantize kernel launch failed: "
                           + lib.fedml_cuda_error_string(rc).decode())
    quantize_int8.launches += 1
    return out


quantize_int8.launches = 0


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor, d: int,
                    subtract_from: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: the f32 ``[d]`` vector. Given
    ``subtract_from`` (f32 ``[d]``, the quantized values themselves), it
    returns ``subtract_from - dequantized`` rounded once instead: the
    quantization error that top-k's error feedback keeps. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, counted in
    ``dequantize_int8.launches``. A fake tensor (the FLOP counter's) takes
    the plain version, which it bills."""
    if values.dtype != torch.int8 or tuple(values.shape) != (d,):
        raise TypeError(f"values must be int8 [{d}], got {values.dtype} "
                        f"{tuple(values.shape)}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (
            num_blocks(d),):
        raise TypeError(f"scales must be float32 [{num_blocks(d)}], got "
                        f"{scales.dtype} {tuple(scales.shape)}")
    if scales.device != values.device:
        raise ValueError(f"scales on {scales.device}, values on "
                         f"{values.device}")
    if subtract_from is not None and (
            subtract_from.dtype != torch.float32
            or tuple(subtract_from.shape) != (d,)
            or subtract_from.device != values.device):
        raise TypeError(f"subtract_from must be float32 [{d}] on "
                        f"{values.device}, got {subtract_from.dtype} "
                        f"{tuple(subtract_from.shape)} on "
                        f"{subtract_from.device}")
    if values.device.type == "cpu" or is_fake(values):
        return dequantize_int8_reference(values, scales, subtract_from)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    values, scales = values.contiguous(), scales.contiguous()
    minuend = None if subtract_from is None else subtract_from.contiguous()
    out = torch.empty(d, dtype=torch.float32, device=values.device)
    if d == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(values.device):
        rc = lib.fedml_dequantize_int8(
            values.data_ptr(), scales.data_ptr(),
            None if minuend is None else minuend.data_ptr(),
            out.data_ptr(), d,
            torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("dequantize kernel launch failed: "
                           + lib.fedml_cuda_error_string(rc).decode())
    dequantize_int8.launches += 1
    return out


dequantize_int8.launches = 0


def takes_vec_paths(x, bits, q, out, minuend=None,
                    residual=None) -> Tuple[bool, bool]:
    """Whether the quantize kernel reads ``x``/``bits`` and writes ``q``
    (and ``residual``), and the dequantize kernel reads ``q`` (and
    ``minuend``) and writes ``out``, with vector accesses; otherwise each
    takes its scalar path."""
    lib = _kernel()
    return (bool(lib.fedml_quantize_int8_is_vec(
                x.data_ptr(), _as_int32_bits(bits).data_ptr(),
                q.data_ptr(),
                None if residual is None else residual.data_ptr())),
            bool(lib.fedml_dequantize_int8_is_vec(
                q.data_ptr(), None if minuend is None else minuend.data_ptr(),
                out.data_ptr())))


# -- state-dict front ends ---------------------------------------------------

def flatten(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every leaf, in state-dict order, as one flat f32 vector (the wire's
    layout)."""
    return torch.cat([v.reshape(-1).to(torch.float32)
                      for v in tree.values()])


def unflatten_like(flat: torch.Tensor,
                   tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten` against ``tree``'s names, shapes and
    dtypes."""
    out, off = {}, 0
    for k, leaf in tree.items():
        n = leaf.numel()
        out[k] = flat[off:off + n].reshape(leaf.shape).to(leaf.dtype)
        off += n
    return out


def quantize_tree(tree: Dict[str, torch.Tensor], bits: torch.Tensor):
    """Quantize a state dict; returns ``(values, scales, spec)``, where
    ``spec`` lists each leaf's ``(name, shape, dtype)`` and the total size
    (what :func:`dequantize_tree` rebuilds from)."""
    flat = flatten(tree)
    vals, scales = quantize_int8(flat, bits)
    spec: Tuple[List, int] = ([(k, tuple(v.shape), v.dtype)
                               for k, v in tree.items()], flat.numel())
    return vals, scales, spec


def dequantize_tree(values: torch.Tensor, scales: torch.Tensor, spec):
    """Rebuild the state dict from :func:`quantize_tree` output."""
    leaf_meta, d = spec
    flat = dequantize_int8(values, scales, d)
    out, off = {}, 0
    for name, shape, dtype in leaf_meta:
        n = int(np.prod(shape)) if shape else 1
        out[name] = flat[off:off + n].reshape(shape).to(dtype)
        off += n
    return out
