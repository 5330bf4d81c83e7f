"""Pieces shared by the model zoo: flax-matching initialization and
explicit-generator dropout."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

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


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax applies it: keep with probability ``1-p``
    and scale kept values by ``1/(1-p)``. The mask comes from
    ``generator``; training without one raises rather than reading torch's
    global RNG."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
