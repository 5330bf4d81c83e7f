"""MobileNet v1 (depthwise-separable), CIFAR variant.

The counterpart of ``fedml_tpu/models/mobilenet.py`` (reference
fedml_api/model/cv/mobilenet.py:60, the reference's default model and its
cross-silo CIFAR benchmark model): a stride-1 3x3 stem for 32x32 inputs,
thirteen blocks of a 3x3 depthwise convolution (``groups=C``) and a 1x1
pointwise one, each followed by BatchNorm and ReLU, the channel ladder
32-64-128-256-512(x5)-1024 scaled by ``width_multiplier``, global average
pool, a linear head. 3,309,476 parameters and 21,888 BN statistics at 100
classes.

Every norm is the flax-semantics :class:`~fedml_tpu_torch.models.common.
BatchNorm` (momentum 0.9, eps 1e-5). Inputs are NHWC, NCHW inside; every
3x3 convolution pads 1 on both sides, as the JAX model's explicit
``padding=1`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import BatchNorm, nested_flax_names


class DepthwiseSeparable(nn.Module):
    #: torch submodule -> flax module name, inside the block
    flax_names = {"dw": "Conv_0", "bn1": "BatchNorm_0", "pw": "Conv_1",
                  "bn2": "BatchNorm_1"}

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.dw = nn.Conv2d(in_ch, in_ch, 3, stride, 1, groups=in_ch,
                            bias=False)
        self.bn1 = BatchNorm(in_ch)
        self.pw = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(self.bn1(self.dw(x), train))
        return F.relu(self.bn2(self.pw(x), train))


# (output channels, stride) of the thirteen blocks at width 1.0
_LADDER = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           *((512, 1),) * 5, (1024, 2), (1024, 1))


class MobileNet(nn.Module):
    def __init__(self, num_classes: int = 100,
                 width_multiplier: float = 1.0):
        super().__init__()

        def ch(c):
            return int(c * width_multiplier)
        self.stem = nn.Conv2d(3, ch(32), 3, 1, 1, bias=False)
        self.stem_bn = BatchNorm(ch(32))
        blocks, in_ch = [], ch(32)
        for out, stride in _LADDER:
            blocks.append(DepthwiseSeparable(in_ch, ch(out), stride))
            in_ch = ch(out)
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(in_ch, num_classes)
        self.flax_names = nested_flax_names(
            {"stem": "Conv_0", "stem_bn": "BatchNorm_0", "fc": "Dense_0"},
            [(f"blocks.{i}", f"DepthwiseSeparable_{i}", b)
             for i, b in enumerate(blocks)])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.stem_bn(self.stem(x), train))
        for blk in self.blocks:
            x = blk(x, train)
        return self.fc(x.mean((2, 3)))
