"""Decoder-only transformer LM (``fedml_tpu/models/transformer.py``).

A causal LM that scores every position (logits ``[B, T, vocab]``) for the
federated next-word-prediction task. Its attention is an injectable
callable over ``[B, S, H, D]``:

- ``attn_fn=None``: the plain softmax oracle,
  :func:`fedml_tpu_torch.parallel.sequence.reference_attention`;
- ``attn_fn=make_flash_attention(bq, bk)``: the hand-written flash kernels
  (``fedml_tpu_torch/ops/flash_attention.py``);
- any ``(q, k, v, causal=...) -> out`` callable.

The layers follow flax's, so converted weights give the same forward pass:
LayerNorm with eps 1e-6, the tanh form of GELU, a qkv projection without a
bias whose output splits into q, k, v in that order along the last axis.
q, k and v stay views of that projection (row stride ``3 * width``); the
flash kernels read them in place. The dense MLP only: the MoE FFN,
``attn_fn="auto"`` (the autotuner) and ``remat`` are not ported yet and
raise.

Dropout draws its masks from the ``generator`` the caller passes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import dropout
from fedml_tpu_torch.parallel.sequence import reference_attention

AttnFn = Callable[..., torch.Tensor]  # (q, k, v, causal=...) -> out
LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _resolve_attn(attn_fn) -> AttnFn:
    if isinstance(attn_fn, str):
        if attn_fn == "auto":
            raise NotImplementedError(
                "attn_fn='auto' needs the attention autotuner "
                "(ops/autotune.py), which is not ported yet: ROADMAP Queue "
                "1, Slice E item 25 (autotune)")
        raise ValueError(f"unknown attn_fn {attn_fn!r}")
    return attn_fn or reference_attention


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + attn(LN(x))``, then ``x + MLP(LN(x))``."""

    #: torch submodule -> flax module name inside the block
    flax_names = {"ln1": "LayerNorm_0", "qkv": "Dense_0", "proj": "Dense_1",
                  "ln2": "LayerNorm_1", "fc1": "Dense_2", "fc2": "Dense_3"}

    def __init__(self, width: int, num_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, attn_fn: Optional[AttnFn] = None):
        super().__init__()
        if width % num_heads:
            raise ValueError(f"width {width} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.attn = _resolve_attn(attn_fn)
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.qkv = nn.Linear(width, 3 * width, bias=False)
        self.proj = nn.Linear(width, width, bias=False)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, mlp_ratio * width)
        self.fc2 = nn.Linear(mlp_ratio * width, width)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, s, width = x.shape
        shape4 = (b, s, self.num_heads, width // self.num_heads)
        q, k, v = self.qkv(self.ln1(x)).split(width, dim=-1)
        out = self.attn(q.view(shape4), k.view(shape4), v.view(shape4),
                        causal=True)
        out = self.proj(out.reshape(b, s, width))
        x = x + dropout(out, self.dropout, train, generator)
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + dropout(h, self.dropout, train, generator)


class TransformerLM(nn.Module):
    """Causal LM scoring every position (``[B, T, vocab]``)."""

    def __init__(self, vocab_size: int = 10004, width: int = 256,
                 depth: int = 4, num_heads: int = 4, max_len: int = 2048,
                 dropout: float = 0.0, attn_fn: Optional[AttnFn] = None,
                 moe_experts: int = 0, remat: bool = False):
        super().__init__()
        if moe_experts > 0:
            raise NotImplementedError(
                "the MoE FFN (moe_experts > 0) is not ported yet: ROADMAP "
                "Queue 1, Slice E item 25 (MoE)")
        if remat:
            raise NotImplementedError(
                "remat=True (per-block rematerialization) is not ported "
                "yet: ROADMAP Queue 1, Slice E item 25 (remat)")
        self.max_len = max_len
        self.embed = nn.Embedding(vocab_size, width)
        self.pos_embed = nn.Embedding(max_len, width)
        self.blocks = nn.ModuleList(
            TransformerBlock(width, num_heads, dropout=dropout,
                             attn_fn=attn_fn) for _ in range(depth))
        self.ln_f = nn.LayerNorm(width, eps=LN_EPS)
        self.head = nn.Linear(width, vocab_size)
        #: torch submodule -> flax module path (utils/convert.py)
        self.flax_names: Dict[str, str] = {"embed": "Embed_0",
                                           "pos_embed": "pos_embed",
                                           "ln_f": "LayerNorm_0",
                                           "head": "Dense_0"}
        for i in range(depth):
            for t, f in TransformerBlock.flax_names.items():
                self.flax_names[f"blocks.{i}.{t}"] = \
                    f"TransformerBlock_{i}/{f}"

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                pos_offset: int = 0) -> torch.Tensor:
        # pos_offset: global position of the first token (a sequence shard)
        b, s = x.shape
        if s > self.max_len:
            raise ValueError(f"sequence length {s} > max_len {self.max_len}; "
                             "the position table has no row for it")
        pos = torch.arange(s, device=x.device) + pos_offset
        h = self.embed(x) + self.pos_embed(pos)[None]
        for block in self.blocks:
            h = block(h, train, generator)
        return self.head(self.ln_f(h))
