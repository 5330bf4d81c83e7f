"""Sample-weighted client aggregation, the FedAvg server rule, as one kernel.

``w_global = sum_i n_i * w_i / sum_i n_i`` (reference FedAVGAggregator.py:
72-80) over client updates stacked as an f32 ``[C, D]`` matrix. On a CUDA
tensor, :func:`weighted_mean_flat` launches the hand-written Hopper kernel
in ``csrc/aggregate.cu`` (the counterpart of the Pallas kernel
``fedml_tpu/ops/aggregate.py::_wmean_kernel``); on a CPU tensor it runs the
plain version :func:`weighted_mean_flat_reference`. There is no fallback
between the two: a CUDA tensor launches the kernel or raises.

:func:`tree_weighted_mean_fused` is the state-dict front end (the
counterpart of ``tree_weighted_mean_pallas``): it copies every leaf into
one ``[C, D]`` buffer, launches once, and returns views of the result. Its
buffer's rows are padded to a multiple of 4 floats, so the kernel reads
every row with 16-byte loads; the padding is never read.

Under the FLOP counter (``utils/flops.py``) neither front end launches:
each sees a fake tensor and bills a formula from its shapes,
:func:`weighted_mean_flat_flops` and :func:`tree_weighted_mean_flops`,
equal to what its plain version's ops bill.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fedml_tpu_torch.core.pytree import tree_weighted_mean
from fedml_tpu_torch.ops.build import load_library
from fedml_tpu_torch.utils import flops

#: dynamic shared memory holds the C weights; 48 KB without opting in
MAX_CLIENTS = 48 * 1024 // 4


@functools.cache
def _kernel():
    """The built library with every launcher's signature declared (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    lib = load_library("aggregate").lib
    lib.fedml_wmean_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    lib.fedml_wmean_f32.restype = ctypes.c_int
    lib.fedml_wmean_f32_is_vec4.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.fedml_wmean_f32_is_vec4.restype = ctypes.c_int
    lib.fedml_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fedml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def weighted_mean_flat_reference(stacked: torch.Tensor,
                                 weights: torch.Tensor) -> torch.Tensor:
    """The plain version: ``w/sum(w) @ stacked`` written out in torch."""
    w = weights.to(torch.float32)
    w = w / w.sum()
    return (w[:, None] * stacked.to(torch.float32)).sum(dim=0)


def weighted_mean_flat_flops(c: int, d: int) -> float:
    """FLOPs of :func:`weighted_mean_flat_reference` on ``[C, D]``: the
    weights' sum (C) and division (C), the products (C D) and their sum
    over clients (C D)."""
    return 2.0 * c + 2.0 * c * d


def tree_weighted_mean_flops(c: int, d: int) -> float:
    """FLOPs of the per-leaf mean ``core.pytree.tree_weighted_mean`` (the
    CPU path's aggregation, and the JAX package's) over a state dict of
    ``d`` values a client: the weights' sum (C), then per leaf of n values
    the products (C n), their sum over clients (C n) and the division by
    the total (n)."""
    return float(c) + 2.0 * c * d + float(d)


def _row_stride(stacked: torch.Tensor) -> int:
    c, d = stacked.shape
    # a single row's stride is never followed; round D up so the 16-byte
    # path stays open
    return stacked.stride(0) if c > 1 else -(-d // 4) * 4


def weighted_mean_flat(stacked: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Sample-weighted mean over the client axis of an f32 ``[C, D]``
    stack; returns an f32 ``[D]`` tensor. ``weights`` are the per-client
    sample counts; they are normalized by their sum first, as the
    reference does.

    ``stacked`` may be contiguous or a view whose rows are contiguous and
    at least D apart (the front end's row-padded buffer). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel, counted in
    ``weighted_mean_flat.launches``."""
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be [C, D], got {tuple(stacked.shape)}")
    if stacked.dtype != torch.float32:
        raise TypeError(f"stacked must be float32, got {stacked.dtype}")
    c, d = stacked.shape
    if tuple(weights.shape) != (c,):
        raise ValueError(f"weights must be [{c}], got {tuple(weights.shape)}")
    if weights.device != stacked.device:
        raise ValueError(f"weights on {weights.device}, stacked on "
                         f"{stacked.device}")
    if flops.is_fake(stacked):
        return flops.bill_kernel(
            "wmean_f32", weighted_mean_flat_flops(c, d),
            4.0 * (c * d + c + d), weighted_mean_flat_reference, stacked,
            weights)
    if stacked.device.type == "cpu":
        return weighted_mean_flat_reference(stacked, weights)
    if stacked.device.type != "cuda":
        raise ValueError(f"unsupported device {stacked.device}")
    if c > MAX_CLIENTS:
        raise ValueError(f"{c} clients > {MAX_CLIENTS} the kernel holds")
    if (d and stacked.stride(1) != 1) or (c > 1 and stacked.stride(0) < d):
        raise ValueError("stacked rows must be contiguous and not overlap "
                         f"(strides {stacked.stride()})")
    w = weights.to(torch.float32)
    w = (w / w.sum()).contiguous()
    out = torch.empty(d, dtype=torch.float32, device=stacked.device)
    lib = _kernel()
    rc = lib.fedml_wmean_f32(
        stacked.data_ptr(), _row_stride(stacked), w.data_ptr(),
        out.data_ptr(), c, d,
        torch.cuda.current_stream(stacked.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("aggregate kernel launch failed: "
                           + lib.fedml_cuda_error_string(rc).decode())
    weighted_mean_flat.launches += 1
    return out


weighted_mean_flat.launches = 0


def takes_vec4_path(stacked: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel reads ``stacked`` with 16-byte loads."""
    return bool(_kernel().fedml_wmean_f32_is_vec4(
        stacked.data_ptr(), _row_stride(stacked), out.data_ptr()))


def flatten_stack(stacked_tree) -> torch.Tensor:
    """Copy a stacked state dict (leaves ``[C, ...]``) into one f32 buffer
    with rows padded to a multiple of 4 floats; returns the ``[C, D]``
    view of it."""
    leaves = list(stacked_tree.values())
    c = leaves[0].shape[0]
    sizes = [leaf[0].numel() for leaf in leaves]
    d = sum(sizes)
    buf = torch.empty((c, -(-d // 4) * 4), dtype=torch.float32,
                      device=leaves[0].device)
    off = 0
    for leaf, n in zip(leaves, sizes):
        buf[:, off:off + n] = leaf.reshape(c, n)
        off += n
    return buf[:, :d]


def tree_weighted_mean_fused(stacked_tree, weights):
    """State-dict front end: flatten every leaf into one ``[C, D]`` buffer,
    launch :func:`weighted_mean_flat` once, and unflatten. Drop-in for
    :func:`fedml_tpu_torch.core.pytree.tree_weighted_mean`.

    Each leaf comes back in a tensor of its own, as the per-leaf mean's do,
    not as a view into the ``[D]`` result: a host loop that trained its
    next round on such views left the bits of a captured round, which
    trains on its own buffers (most likely cuDNN and cuBLAS take other
    kernels, with other rounding, for a view whose offset is not 16-byte
    aligned).

    Under the FLOP counter it launches nothing and bills
    :func:`tree_weighted_mean_flops`, the count of the per-leaf mean."""
    leaves = list(stacked_tree.values())
    if flops.is_fake(leaves[0]):
        c, d = leaves[0].shape[0], sum(leaf[0].numel() for leaf in leaves)
        return flops.bill_kernel(
            "wmean_f32", tree_weighted_mean_flops(c, d),
            4.0 * (c * d + c + d), tree_weighted_mean, stacked_tree, weights)
    mean = weighted_mean_flat(flatten_stack(stacked_tree), weights)
    out, off = {}, 0
    for k, leaf in stacked_tree.items():
        n = leaf[0].numel()
        out[k] = mean[off:off + n].reshape(leaf.shape[1:]).to(
            leaf.dtype, copy=True)
        off += n
    return out
