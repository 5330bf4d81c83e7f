"""Vertical-FL party networks, the counterpart of ``fedml_tpu/models/vfl.py``
(reference fedml_api/model/finance/).

:class:`VFLFeatureExtractor` is the reference's 2-layer dense extractor
(vfl_models_standalone.py / vfl_feature_extractor.py ``LocalModel``: linear
then ReLU, a layer each width); :class:`VFLDenseModel` is ``DenseModel``,
one linear map from a party's features to its logit component. The guest's
has a bias and the hosts' have none (party_models.py:21, 90). Split
learning uses the same two as its bottom and top networks. flax infers
input widths, so the port's modules take them as arguments.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class VFLFeatureExtractor(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (32, 16)):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        dims = (input_dim, *self.hidden_dims)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        self.flax_names = {f"layers.{i}": f"Dense_{i}"
                           for i in range(len(self.layers))}

    @property
    def output_dim(self) -> int:
        return self.hidden_dims[-1]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = F.relu(layer(x))
        return x


class VFLDenseModel(nn.Module):
    flax_names = {"dense": "Dense_0"}

    def __init__(self, input_dim: int, output_dim: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.dense = nn.Linear(input_dim, output_dim, bias=use_bias)

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.dense(z)
