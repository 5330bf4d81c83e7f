"""ResNet-18 with GroupNorm, the fed_cifar100 benchmark model.

The counterpart of ``fedml_tpu/models/resnet_gn.py`` (reference
fedml_api/model/cv/resnet_gn.py:183 ``resnet18`` with GroupNorm in place of
BatchNorm, the normalization "Adaptive Federated Optimization",
arXiv:2003.00295, uses for cross-device FL): basic blocks [2, 2, 2, 2] at
64/128/256/512 planes, ``GroupNorm(max(1, C // 32))`` with flax's eps 1e-6,
a 3x3 stem for the 24x24 fed_cifar100 crops (``small_images``) or the
ImageNet 7x7 stride-2 stem and max pool. GroupNorm holds no running state,
so every entry of the state dict is a parameter. 11,220,132 parameters at
100 classes.

Inputs keep the JAX package's NHWC layout and become NCHW once at entry.
Padding follows flax's: the 3x3 convolutions pad 1 on both sides, the 1x1
stride-2 shortcut pads nothing (flax's ``"SAME"`` for a 1x1 kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _gn(channels: int, channels_per_group: int) -> nn.GroupNorm:
    return nn.GroupNorm(max(1, channels // channels_per_group), channels,
                        eps=1e-6)


class GNBasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 channels_per_group: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.norm1 = _gn(planes, channels_per_group)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.norm2 = _gn(planes, channels_per_group)
        self.shortcut = None
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Conv2d(in_planes, planes, 1, stride, 0,
                                      bias=False)
            self.shortcut_norm = _gn(planes, channels_per_group)

    #: torch submodule -> flax module name, inside the block
    flax_names = {"conv1": "Conv_0", "norm1": "GroupNorm_0",
                  "conv2": "Conv_1", "norm2": "GroupNorm_1",
                  "shortcut": "Conv_2", "shortcut_norm": "GroupNorm_2"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        identity = x
        if self.shortcut is not None:
            identity = self.shortcut_norm(self.shortcut(x))
        return F.relu(out + identity)


class ResNetGN(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 100,
                 channels_per_group: int = 32, small_images: bool = True):
        super().__init__()
        self.small_images = small_images
        if small_images:
            self.stem = nn.Conv2d(3, 64, 3, 1, 1, bias=False)
        else:
            self.stem = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_norm = _gn(64, channels_per_group)
        blocks, in_planes = [], 64
        for stage, n in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(GNBasicBlock(in_planes, planes, stride,
                                           channels_per_group))
                in_planes = planes
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(in_planes, num_classes)
        self.flax_names = {"stem_norm": "GroupNorm_0", "stem": "Conv_0",
                           "fc": "Dense_0"}
        for i, blk in enumerate(blocks):
            for t, f in blk.flax_names.items():
                if getattr(blk, t, None) is not None:
                    self.flax_names[f"blocks.{i}.{t}"] = \
                        f"GNBasicBlock_{i}/{f}"

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.stem_norm(self.stem(x)))
        if not self.small_images:
            x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks:
            x = blk(x)
        return self.fc(x.mean((2, 3)))


def resnet18_gn(num_classes: int = 100, channels_per_group: int = 32,
                small_images: bool = True) -> ResNetGN:
    return ResNetGN([2, 2, 2, 2], num_classes, channels_per_group,
                    small_images)
