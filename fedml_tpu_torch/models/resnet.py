"""CIFAR ResNet-56/110 with bottleneck blocks and BatchNorm throughout.

The counterpart of ``fedml_tpu/models/resnet.py`` (reference
fedml_api/model/cv/resnet.py): a 3x3 stem at 16 channels, no max pool,
three stages at 16/32/64 planes of bottleneck blocks (expansion 4), depth
[6, 6, 6] (``resnet56``) or [12, 12, 12] (``resnet110``), global average
pool, a linear head. ``kd=True`` returns ``(features, logits)``, the
distillation output.

Every norm is the flax-semantics :class:`~fedml_tpu_torch.models.common.
BatchNorm`: its running statistics are buffers of the state dict, which the
trainer selects and the round averages like the params. Inputs are NHWC,
NCHW inside; the 1x1 stride-2 shortcut pads nothing, the 3x3 convolutions
pad 1 on both sides, as flax's do.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import BatchNorm


class BottleneckBlock(nn.Module):
    expansion = 4
    #: torch submodule -> flax module name, inside the block
    flax_names = {"conv1": "Conv_0", "bn1": "BatchNorm_0",
                  "conv2": "Conv_1", "bn2": "BatchNorm_1",
                  "conv3": "Conv_2", "bn3": "BatchNorm_2",
                  "shortcut": "Conv_3", "shortcut_bn": "BatchNorm_3"}

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.shortcut = None
        if stride != 1 or in_planes != out:
            self.shortcut = nn.Conv2d(in_planes, out, 1, stride, 0,
                                      bias=False)
            self.shortcut_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = x
        if self.shortcut is not None:
            identity = self.shortcut_bn(self.shortcut(x), train)
        return F.relu(out + identity)


def block_flax_names(top, blocks) -> Dict[str, str]:
    """A model's ``flax_names``: ``top`` and each ``blocks.i`` bottleneck's
    under ``BottleneckBlock_i`` (its shortcut's only where it has one)."""
    names = dict(top)
    for i, blk in enumerate(blocks):
        for t, f in blk.flax_names.items():
            if getattr(blk, t, None) is not None:
                names[f"blocks.{i}.{t}"] = f"BottleneckBlock_{i}/{f}"
    return names


class CifarResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10,
                 kd: bool = False):
        super().__init__()
        self.kd = kd
        self.stem = nn.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.stem_bn = BatchNorm(16)
        blocks, in_planes = [], 16
        for stage, n in enumerate(stage_sizes):
            planes = 16 * 2 ** stage
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(BottleneckBlock(in_planes, planes, stride))
                in_planes = planes * BottleneckBlock.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(in_planes, num_classes)
        self.flax_names = block_flax_names(
            {"stem": "Conv_0", "stem_bn": "BatchNorm_0", "fc": "Dense_0"},
            blocks)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.relu(self.stem_bn(self.stem(x), train))
        for blk in self.blocks:
            x = blk(x, train)
        feats = x.mean((2, 3))  # global average pool
        logits = self.fc(feats)
        return (feats, logits) if self.kd else logits


def resnet56(num_classes: int = 10, **kw) -> CifarResNet:
    return CifarResNet([6, 6, 6], num_classes, **kw)


def resnet110(num_classes: int = 10, **kw) -> CifarResNet:
    return CifarResNet([12, 12, 12], num_classes, **kw)
