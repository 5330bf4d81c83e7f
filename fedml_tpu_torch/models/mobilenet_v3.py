"""MobileNetV3 (LARGE / SMALL) with squeeze-excite and h-swish.

The counterpart of ``fedml_tpu/models/mobilenet_v3.py`` (reference
fedml_api/model/cv/mobilenet_v3.py:137): inverted-residual bottlenecks with
a per-block expand size, an optional squeeze-excite module (two dense
layers on the pooled vector, reduction 4, hard-sigmoid gate), ReLU or
h-swish, a width multiplier, dropout before the classifier. The block
tables follow the paper's layout (Howard et al., arXiv:1905.02244, Table
1), as the JAX package's do. 4,328,586 parameters and 24,432 BN statistics
for LARGE at 100 classes.

Convolutions pad ``kernel // 2`` on both sides (the JAX model's explicit
padding); ``small_images`` keeps the stem at stride 1 for CIFAR-size
inputs. Every norm is the flax-semantics
:class:`~fedml_tpu_torch.models.common.BatchNorm` (momentum 0.9, eps 1e-5).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import (BatchNorm, DropoutRng, dropout,
                                           nested_flax_names)

# (kernel, exp_size, out_ch, SE, nonlinearity, stride) per block
LARGE: Sequence[Tuple] = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2),
    (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1),
    (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2),
    (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
]
SMALL: Sequence[Tuple] = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
]


def hswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def act(name: str):
    return hswish if name == "hswish" else F.relu


class SqueezeExcite(nn.Module):
    flax_names = {"fc1": "Dense_0", "fc2": "Dense_1"}

    def __init__(self, ch: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(ch, max(1, ch // reduction))
        self.fc2 = nn.Linear(max(1, ch // reduction), ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean((2, 3))))
        s = hsigmoid(self.fc2(s))
        return x * s[:, :, None, None]


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, kernel: int, exp_size: int,
                 out_channels: int, se: bool, nonlinearity: str,
                 stride: int):
        super().__init__()
        self.fn = act(nonlinearity)
        self.residual = stride == 1 and in_ch == out_channels
        self.expand = nn.Conv2d(in_ch, exp_size, 1, bias=False)
        self.bn1 = BatchNorm(exp_size)
        self.dw = nn.Conv2d(exp_size, exp_size, kernel, stride, kernel // 2,
                            groups=exp_size, bias=False)
        self.bn2 = BatchNorm(exp_size)
        self.se = SqueezeExcite(exp_size) if se else None
        self.project = nn.Conv2d(exp_size, out_channels, 1, bias=False)
        self.bn3 = BatchNorm(out_channels)
        self.flax_names = nested_flax_names(
            {"expand": "Conv_0", "bn1": "BatchNorm_0", "dw": "Conv_1",
             "bn2": "BatchNorm_1", "project": "Conv_2", "bn3": "BatchNorm_2"},
            [("se", "SqueezeExcite_0", self.se)] if se else [])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = self.fn(self.bn1(self.expand(x), train))
        out = self.fn(self.bn2(self.dw(out), train))
        if self.se is not None:
            out = self.se(out)
        out = self.bn3(self.project(out), train)
        return out + x if self.residual else out


class MobileNetV3(nn.Module):
    def __init__(self, num_classes: int = 1000, model_mode: str = "LARGE",
                 multiplier: float = 1.0, dropout_rate: float = 0.0,
                 small_images: bool = True):
        super().__init__()
        large = model_mode.upper() == "LARGE"
        cfg = LARGE if large else SMALL
        m = multiplier
        self.dropout_rate = dropout_rate
        stem_stride = 1 if small_images else 2
        in_ch = int(16 * m)
        self.stem = nn.Conv2d(3, in_ch, 3, stem_stride, 1, bias=False)
        self.stem_bn = BatchNorm(in_ch)
        blocks = []
        for k, exp, out, se, nl, s in cfg:
            blocks.append(InvertedResidual(in_ch, k, int(exp * m),
                                           int(out * m), se, nl, s))
            in_ch = int(out * m)
        self.blocks = nn.ModuleList(blocks)
        last_exp = int((960 if large else 576) * m)
        self.last = nn.Conv2d(in_ch, last_exp, 1, bias=False)
        self.last_bn = BatchNorm(last_exp)
        self.hidden = nn.Linear(last_exp, 1280 if large else 1024)
        self.fc = nn.Linear(self.hidden.out_features, num_classes)
        self.flax_names = nested_flax_names(
            {"stem": "Conv_0", "stem_bn": "BatchNorm_0", "last": "Conv_1",
             "last_bn": "BatchNorm_1", "hidden": "Dense_0", "fc": "Dense_1"},
            [(f"blocks.{i}", f"InvertedResidual_{i}", b)
             for i, b in enumerate(blocks)])

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[DropoutRng] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = hswish(self.stem_bn(self.stem(x), train))
        for blk in self.blocks:
            x = blk(x, train)
        x = hswish(self.last_bn(self.last(x), train))
        x = hswish(self.hidden(x.mean((2, 3))))
        x = dropout(x, self.dropout_rate, train, generator)
        return self.fc(x)
