"""SegNet, FedSeg's model: a compact DeepLab-style encoder, ASPP and a
bilinear-upsample head.

The counterpart of ``fedml_tpu/models/segnet.py``: two 3x3 stride-2
convolutions and a 3x3 one (output stride 4), an atrous spatial pyramid
(a 1x1 branch, 3x3 branches at dilations 1, 2 and 4, and an image-pool
branch, concatenated and projected by a 1x1 convolution), a 1x1
classifier with bias, and a bilinear upsample back to the input's size.
GroupNorm with ``min(8, C)`` groups and flax's eps 1e-6 after every
convolution but the classifier, so no running state: every entry of the
state dict is a parameter. 196,067 parameters at width 32 and 3 classes.

Every 3x3 convolution pads as flax's ``"SAME"`` does
(:class:`~fedml_tpu_torch.models.common.SameConv2d`: (0, 1) at stride 2 on
an even size). The upsample is ``F.interpolate(mode="bilinear",
align_corners=False)``, which equals ``jax.image.resize(..., "bilinear")``
when it enlarges (jax's antialiasing acts only when it shrinks). Inputs
are NHWC and so are the logits, ``[B, H, W, classes]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import SameConv2d, nested_flax_names


def _gn(channels: int, groups: int = 8) -> nn.GroupNorm:
    return nn.GroupNorm(min(groups, channels), channels, eps=1e-6)


class ASPP(nn.Module):
    def __init__(self, in_ch: int, channels: int,
                 rates: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.branches = nn.ModuleList(
            [nn.Conv2d(in_ch, channels, 1, bias=False)]
            + [SameConv2d(in_ch, channels, 3, dilation=r) for r in rates])
        self.pool = nn.Conv2d(in_ch, channels, 1, bias=False)
        self.project = nn.Conv2d(channels * (len(rates) + 2), channels, 1,
                                 bias=False)
        self.norm = _gn(channels)
        n = len(self.branches)
        self.flax_names = {
            **{f"branches.{i}": f"Conv_{i}" for i in range(n)},
            "pool": f"Conv_{n}", "project": f"Conv_{n + 1}",
            "norm": "GroupNorm_0"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = self.pool(x.mean((2, 3), keepdim=True)).expand(
            -1, -1, x.shape[2], x.shape[3])
        cat = torch.cat([b(x) for b in self.branches] + [pooled], 1)
        return F.relu(self.norm(self.project(cat)))


class SegNet(nn.Module):
    """Encoder (stride 4) -> ASPP -> classifier -> bilinear upsample."""

    def __init__(self, num_classes: int = 21, width: int = 32):
        super().__init__()
        self.conv1 = SameConv2d(3, width, 3, 2)
        self.norm1 = _gn(width)
        self.conv2 = SameConv2d(width, width * 2, 3, 2)
        self.norm2 = _gn(width * 2)
        self.conv3 = SameConv2d(width * 2, width * 2, 3)
        self.norm3 = _gn(width * 2)
        self.aspp = ASPP(width * 2, width * 2)
        self.classifier = nn.Conv2d(width * 2, num_classes, 1)
        self.flax_names = nested_flax_names(
            {"conv1": "Conv_0", "norm1": "GroupNorm_0", "conv2": "Conv_1",
             "norm2": "GroupNorm_1", "conv3": "Conv_2",
             "norm3": "GroupNorm_2", "classifier": "Conv_3"},
            [("aspp", "ASPP_0", self.aspp)])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        y = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        y = F.relu(self.norm1(self.conv1(y)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        logits = self.classifier(self.aspp(y))
        logits = F.interpolate(logits, size=(h, w), mode="bilinear",
                               align_corners=False, antialias=False)
        return logits.permute(0, 2, 3, 1)  # NHWC, as the JAX model
