"""The FedAvg 2-conv CNN ("Adaptive Federated Optimization", arXiv:2003.00295).

Reference: fedml_api/model/cv/cnn.py:75-144 ``CNN_DropOut``:

    28x28x1 -> conv3x3(32) VALID + relu -> conv3x3(64) VALID + relu
    -> maxpool2x2 -> dropout(.25) -> flatten(9216) -> dense(128) + relu
    -> dropout(.5) -> dense(10 | 62)

1,206,590 parameters for the 62-class variant. Inputs keep the JAX
package's NHWC layout (``[B, 28, 28]`` or ``[B, 28, 28, 1]``) and are
converted to NCHW once at entry. The features are flattened in (h, w, c)
order, as flax flattens NHWC, so weights converted from the JAX package
give the same forward pass.

Dropout draws its masks from the ``generator`` the caller passes, never
from torch's global RNG.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import dropout


class CNN_DropOut(nn.Module):
    #: torch submodule -> flax module name (utils/convert.py)
    flax_names = {"conv1": "Conv_0", "conv2": "Conv_1", "fc1": "Dense_0",
                  "fc2": "Dense_1"}

    def __init__(self, only_digits: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 3)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.fc1 = nn.Linear(9216, 128)
        self.fc2 = nn.Linear(128, 10 if only_digits else 62)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.max_pool2d(x, 2, 2)
        x = dropout(x, 0.25, train, generator)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c) order, as flax
        x = F.relu(self.fc1(x))
        x = dropout(x, 0.5, train, generator)
        return self.fc2(x)
