"""Plain softmax attention, the transformer's default ``attn_fn``.

The port's counterpart of ``reference_attention`` in
``fedml_tpu/parallel/sequence.py``: the unsharded oracle over ``[B, S, H,
D]`` inputs, which materializes the ``[B, H, S, S]`` score matrix. The
sequence-parallel schemes of that module (ring, Ulysses) are not ported
yet.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """softmax(QK^T / sqrt(d) [+ causal mask]) V in f32, cast back to the
    dtype of q."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        s = torch.where((pos[:, None] >= pos[None, :])[None, None], s,
                        torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
