"""Logistic regression (reference: fedml_api/model/linear/lr.py:4-13).

Emits raw logits, as the JAX package does; the task head applies the link.
Unlike flax, torch needs the input width at construction (``in_features``,
the product of one example's feature shape).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class LogisticRegression(nn.Module):
    #: torch submodule -> flax module name (utils/convert.py)
    flax_names = {"linear": "Dense_0"}

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.linear = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1))
