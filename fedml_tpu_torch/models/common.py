"""Pieces shared by the model zoo: flax-matching initialization and
dropout from an explicit key (a ``torch.Generator`` or a graph-safe
:class:`DropoutKey`)."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn

from fedml_tpu_torch.core.sampling import counter_bits, fold32

# std of a unit normal truncated to [-2, 2]; flax's truncated lecun_normal
# divides by it so the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize every Linear, Conv and Embedding layer the way flax's
    defaults do: kernel ``lecun_normal`` (truncated normal, variance
    1/fan_in), bias zeros, embedding a plain normal of variance 1/width,
    drawn from ``generator``; LayerNorms keep torch's ones and zeros, which
    are flax's too. The distributions match the JAX package's; the numbers
    do not (different generators)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, math.sqrt(1.0 / m.embedding_dim),
                            generator=generator)
    return module


class DropoutKey:
    """The dropout key of one training step: an int64 seed, and a site
    counter that the host advances at each dropout call of the forward
    pass, so every layer draws its own mask. The mask of element ``i`` of
    site ``s`` is a hash of (seed, s, i) alone: it does not depend on the
    padded length a batch came from, on the device, or on whether a CUDA
    graph replays it. The seed is a Python int (the host loop: the site
    keys are then hashed on the host) or a 0-dim tensor (safe to capture:
    a replayed graph reads a new seed from the same memory); both give the
    same bits."""

    def __init__(self, seed):
        self.seed = seed
        self.site = 0
        self._folded = None

    def bits(self, shape, device) -> torch.Tensor:
        """The next site's 32-bit hash values (int64), one for every
        element of ``shape`` in row-major order of the logical shape."""
        if self._folded is None:
            s = self.seed
            if torch.is_tensor(s):
                s = s.to(torch.int64)
            self._folded = (s ^ (s >> 32)) & 0xFFFFFFFF
        key = fold32(self._folded, self.site)
        self.site += 1
        return counter_bits(key, math.prod(shape), device).view(shape)


DropoutRng = Union[torch.Generator, DropoutKey]


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[DropoutRng]) -> torch.Tensor:
    """Inverted dropout as flax applies it: keep with probability ``1-p``
    and scale kept values by ``1/(1-p)``. The mask comes from ``generator``:
    a ``torch.Generator`` (``torch.rand``), or a :class:`DropoutKey` (a
    counter hash, kept where its 32 bits are at least ``p * 2**32``);
    training without one raises rather than reading torch's global RNG."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit generator")
    if isinstance(generator, DropoutKey):
        keep = generator.bits(x.shape, x.device) >= round(p * 2.0 ** 32)
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)
