"""EfficientNet B0-B7.

The counterpart of ``fedml_tpu/models/efficientnet.py`` (reference
fedml_api/model/cv/efficientnet.py:138, the Landmarks model): a 3x3
stride-2 stem, seven stages of MBConv blocks (a 1x1 expansion unless the
expand ratio is 1, a depthwise convolution, squeeze-excitation through two
1x1 convolutions with bias, a 1x1 projection), a 1x1 head, global average
pool and a linear classifier; swish throughout, width and depth scaled per
variant (Tan & Le 2019). 4,135,648 parameters and 42,016 BN statistics for
B0 at 100 classes.

As in the JAX model: every convolution pads as flax's ``"SAME"`` does
(:class:`~fedml_tpu_torch.models.common.SameConv2d`; asymmetric at stride
2), every norm is BatchNorm with momentum 0.99 and eps 1e-3 (not the zoo's
0.9 and 1e-5), a stride-1 block whose channels do not change adds its input
back through per-example drop-connect at rate ``0.2 * block / blocks``, and
the head's dropout runs in train mode only. The masks come from the step's
:class:`~fedml_tpu_torch.models.common.DropoutKey`, so a captured round
replays them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import (BatchNorm, DropoutRng, SameConv2d,
                                           drop_connect, dropout,
                                           nested_flax_names)

# (width_mult, depth_mult, resolution, dropout) per variant
PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}

# (expand, channels, repeats, stride, kernel): the B0 baseline stages
BASE_STAGES: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=0.99, eps=1e-3)


class MBConv(nn.Module):
    def __init__(self, C_in: int, C_out: int, expand: int, kernel: int,
                 stride: int, se_ratio: float = 0.25,
                 drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.residual = stride == 1 and C_in == C_out
        C_mid = C_in * expand
        self.expand = None
        if expand != 1:
            self.expand = nn.Conv2d(C_in, C_mid, 1, bias=False)
            self.bn0 = _bn(C_mid)
        self.dw = SameConv2d(C_mid, C_mid, kernel, stride, groups=C_mid)
        self.bn1 = _bn(C_mid)
        se_ch = max(1, int(C_in * se_ratio))
        self.se_reduce = nn.Conv2d(C_mid, se_ch, 1)
        self.se_expand = nn.Conv2d(se_ch, C_mid, 1)
        self.project = nn.Conv2d(C_mid, C_out, 1, bias=False)
        self.bn2 = _bn(C_out)
        # flax numbers the modules it creates, so the expansion's shift
        # the others' names
        first = ["expand", "bn0"] if expand != 1 else []
        convs = first[:1] + ["dw", "se_reduce", "se_expand", "project"]
        bns = first[1:] + ["bn1", "bn2"]
        self.flax_names = {**{t: f"Conv_{i}" for i, t in enumerate(convs)},
                           **{t: f"BatchNorm_{i}" for i, t in enumerate(bns)}}

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[DropoutRng]) -> torch.Tensor:
        h = x
        if self.expand is not None:
            h = F.silu(self.bn0(self.expand(h), train))
        h = F.silu(self.bn1(self.dw(h), train))
        s = h.mean((2, 3), keepdim=True)  # squeeze-excitation
        s = torch.sigmoid(self.se_expand(F.silu(self.se_reduce(s))))
        h = self.bn2(self.project(h * s), train)
        if self.residual:
            h = drop_connect(h, self.drop_rate, train, generator) + x
        return h


class EfficientNet(nn.Module):
    def __init__(self, variant: str = "efficientnet-b0",
                 num_classes: int = 1000):
        super().__init__()
        width, depth, _, self.dropout_rate = PARAMS[variant]
        c = round_filters(32, width)
        self.stem = SameConv2d(3, c, 3, 2)
        self.stem_bn = _bn(c)
        total = sum(round_repeats(r, depth) for _, _, r, _, _ in BASE_STAGES)
        blocks = []
        for expand, channels, repeats, stride, kernel in BASE_STAGES:
            c_out = round_filters(channels, width)
            for r in range(round_repeats(repeats, depth)):
                blocks.append(MBConv(c, c_out, expand, kernel,
                                     stride if r == 0 else 1,
                                     drop_rate=0.2 * len(blocks) / total))
                c = c_out
        self.blocks = nn.ModuleList(blocks)
        c_head = round_filters(1280, width)
        self.head = nn.Conv2d(c, c_head, 1, bias=False)
        self.head_bn = _bn(c_head)
        self.fc = nn.Linear(c_head, num_classes)
        self.flax_names = nested_flax_names(
            {"stem": "Conv_0", "stem_bn": "BatchNorm_0", "head": "Conv_1",
             "head_bn": "BatchNorm_1", "fc": "Dense_0"},
            [(f"blocks.{i}", f"MBConv_{i}", b) for i, b in enumerate(blocks)])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[DropoutRng] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        h = F.silu(self.stem_bn(self.stem(x), train))
        for blk in self.blocks:
            h = blk(h, train, generator)
        h = F.silu(self.head_bn(self.head(h), train)).mean((2, 3))
        h = dropout(h, self.dropout_rate, train, generator)
        return self.fc(h)


def efficientnet(variant: str = "efficientnet-b0",
                 num_classes: int = 1000) -> EfficientNet:
    if variant not in PARAMS:
        raise ValueError(f"unknown variant {variant}")
    return EfficientNet(variant, num_classes)
