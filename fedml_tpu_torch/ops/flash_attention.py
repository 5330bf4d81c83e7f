"""Flash attention with a blockwise backward, as three hand-written kernels.

The counterpart of ``fedml_tpu/ops/flash_attention.py``: softmax attention
over ``[B, S, H, D]`` inputs with the online softmax, the ``lse``
(log-sum-exp) of every row saved for the backward, and the FlashAttention-2
backward (P recomputed from ``lse``, ``dS = P * (dP - delta) * scale``, the
``[S, S]`` score matrix never stored). On CUDA tensors each of the three
steps launches its kernel from ``csrc/flash_attention.cu``:

- :func:`flash_fwd` -> ``(out, lse)``, the counterpart of ``_fwd_kernel``;
- :func:`flash_bwd_dkdv` -> ``(dk, dv)``, of ``_bwd_dkdv_kernel``;
- :func:`flash_bwd_dq` -> ``dq``, of ``_bwd_dq_kernel``.

On CPU tensors each runs its plain version (:func:`fwd_reference`,
:func:`bwd_dkdv_reference`, :func:`bwd_dq_reference`), which go through the
dense ``[B, H, S, S]`` scores. There is no fallback between the two: a CUDA
tensor launches the kernel or raises. ``delta = rowsum(dO * O)`` is plain
torch between the forward and the backward kernels, as the JAX package
leaves it to XLA. All three run on the tensor cores in f32-accurate
3xTF32 (the source's header says how).

:func:`flash_attention` is the differentiable function and
:func:`make_flash_attention` the transformer's ``attn_fn`` factory. The
``block_q``/``block_k`` arguments are the TPU kernel's tile sizes, kept for
its shape contract (blocks clamp to ``S`` and must divide it); the CUDA
kernels pick their own 64-row tiles and take any ``S``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from fedml_tpu_torch.ops.build import load_library
from fedml_tpu_torch.utils.flops import is_fake
from fedml_tpu_torch.parallel.sequence import _NEG_INF

#: the head widths the CUDA kernels are built for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    """The built library with every launcher's signature declared."""
    lib = load_library("flash_attention").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fedml_flash_fwd.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, p]
    lib.fedml_flash_bwd_dkdv.argtypes = [i, i, p, p, p, p, p, p, p, p, p,
                                         i, i, i, i, p]
    lib.fedml_flash_bwd_dq.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                       i, i, i, i, p]
    for fn in (lib.fedml_flash_fwd, lib.fedml_flash_bwd_dkdv,
               lib.fedml_flash_bwd_dq):
        fn.restype = ctypes.c_int
    lib.fedml_flash_error_string.argtypes = [ctypes.c_int]
    lib.fedml_flash_error_string.restype = ctypes.c_char_p
    return lib


# -- plain versions (the kernels' oracles; the CPU path) --------------------

def _scores(q, k, causal: bool) -> torch.Tensor:
    """``(q * scale) k^T`` in f32 as ``[B, H, S, S]``, causal entries set to
    ``_NEG_INF`` (the TPU kernel scales q before the product)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        torch.full_like(s, _NEG_INF))
    return s


def fwd_reference(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, S, H, D] in q's dtype, lse [B, H, S] f32)`` through the
    dense scores, with the kernel's finalization: ``out = acc / max(l,
    1e-30)``, ``lse = m + log(max(l, 1e-30))``."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, causal: bool):
    """P recomputed from ``lse`` and ``dS = P * (dP - delta) * scale``
    (``_bwd_block_grads``), both ``[B, H, S, S]`` f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def bwd_dkdv_reference(q, k, v, do, lse, delta, causal: bool):
    """``(dk, dv)``: ``dV = P^T dO``, ``dK = dS^T Q`` (Q unscaled; dS
    carries the scale)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_dq_reference(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """``dq = dS K``."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, as ``[B, H, S]``."""
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


# -- the kernels' wrappers --------------------------------------------------

def _check_cuda(tensors, names):
    """Raise on what the kernels do not take; return the tensors with a
    unit stride on D (a tensor without one is copied)."""
    q = tensors[0]
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} has no CUDA kernel; built for "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernels' grid (65535)")
    out = []
    for t, name in zip(tensors, names):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != (b, s, h, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q has "
                             f"{(b, s, h, d)}")
        out.append(t if t.stride(-1) == 1 else t.contiguous())
    return out


def takes_async_copies(*tensors) -> bool:
    """Whether the kernels copy these inputs' tiles with 16-byte
    ``cp.async`` (every row 16-byte aligned: the data pointer and the
    (b, s, h) strides in bytes) rather than their scalar copy path, as
    ``rows_aligned16`` in ``csrc/flash_attention.cu`` decides."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:3]) for t in tensors)


def _strides(*tensors):
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _bwd_operands(q, k, v, do, lse, delta):
    """The backward kernels' checked operands; ``lse`` and ``delta`` as
    contiguous f32 ``[B, H, S]``."""
    q, k, v, do = _check_cuda((q, k, v, do), ("q", "k", "v", "do"))
    b, s, h, _ = q.shape
    rows = []
    for t, name in ((lse, "lse"), (delta, "delta")):
        if tuple(t.shape) != (b, h, s) or t.device != q.device:
            raise ValueError(f"{name} must be {(b, h, s)} on {q.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        rows.append(t.to(torch.float32).contiguous())
    return q, k, v, do, *rows


def _launch(what: str, launcher: str, q, *args) -> None:
    """Call ``launcher`` with ``args`` and q's current stream, with q's
    device made current (the kernels' shared-memory opt-in and launch go to
    the current device); raise on a nonzero return."""
    lib = _kernel()
    with torch.cuda.device(q.device):
        rc = getattr(lib, launcher)(
            *args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           + lib.fedml_flash_error_string(rc).decode())


def _device_kind(q: torch.Tensor) -> str:
    """"cpu" for a tensor that takes the plain version: a CPU tensor, or a
    fake one of the FLOP counter (utils/flops.py), whichever device it
    names (it holds no data, so nothing launches); else "cuda"."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return "cpu" if is_fake(q) else q.device.type


def flash_fwd(q, k, v, causal: bool):
    """Forward: ``(out, lse)`` for ``[B, S, H, D]`` q, k, v. A CUDA tensor
    launches the forward kernel (counted in ``flash_fwd.launches``)."""
    if _device_kind(q) == "cpu":
        return fwd_reference(q, k, v, causal)
    q, k, v = _check_cuda((q, k, v), ("q", "k", "v"))
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("forward", "fedml_flash_fwd", q,
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out), b, h, s,
            int(causal))
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool):
    """dK/dV: ``(dk, dv)`` from the saved ``lse`` and ``delta`` (f32
    ``[B, H, S]``). A CUDA tensor launches the dK/dV kernel (counted in
    ``flash_bwd_dkdv.launches``)."""
    if _device_kind(q) == "cpu":
        return bwd_dkdv_reference(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    dk = torch.empty_like(q, memory_format=torch.contiguous_format)
    dv = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("dK/dV", "fedml_flash_bwd_dkdv", q,
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, do, dk, dv), b, h, s,
            int(causal))
    flash_bwd_dkdv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    """dQ from the saved ``lse`` and ``delta``. A CUDA tensor launches the
    dQ kernel (counted in ``flash_bwd_dq.launches``)."""
    if _device_kind(q) == "cpu":
        return bwd_dq_reference(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _bwd_operands(q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("dQ", "fedml_flash_bwd_dq", q,
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), b, h, s, int(causal))
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, then, on the backward, delta in plain torch and
    the dK/dV and dQ kernels (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        delta = attention_delta(out, do)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """softmax(QK^T/sqrt(d) [+ causal mask]) V for ``[B, S, H, D]`` inputs
    of one dtype (float32 or bfloat16, f32 accumulation); the result has
    q's dtype. Blocks clamp to ``S`` and must divide it, as on the TPU."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash attention takes float32 or bfloat16, "
                            f"got {t.dtype}")
    s = q.shape[1]
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(
            f"block sizes ({bq},{bk}) must evenly divide seq len {s}")
    return _FlashAttention.apply(q, k, v, causal)


def make_flash_attention(block_q=128, block_k=128):
    """``attn_fn`` factory for :class:`TransformerLM`: ``(q, k, v,
    causal=True) -> out`` through :func:`flash_attention`."""
    if block_q == "auto" or block_k == "auto":
        raise NotImplementedError(
            "make_flash_attention('auto') needs the attention autotuner "
            "(ops/autotune.py), which is not ported yet: ROADMAP Queue 1, "
            "Slice E item 25 (autotune)")

    def attn(q, k, v, causal: bool = True):
        return flash_attention(q, k, v, causal, block_q, block_k)
    return attn
