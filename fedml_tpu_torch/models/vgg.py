"""VGG-11/13/16/19 with optional BatchNorm.

The counterpart of ``fedml_tpu/models/vgg.py`` (reference
fedml_api/model/cv/vgg.py:13-159): torchvision's config letters ('A', 'B',
'D', 'E': channel lists with 'M' for a 2x2 max pool), 3x3 convolutions with
bias padded 1 on both sides, optional BatchNorm (off by default), and a
4096-4096-classes classifier with two dropouts of 0.5. 28,512,740
parameters for VGG-11 at 100 classes and 32x32 inputs.

The classifier's input size follows the image size, which a torch module
must know when it is built (``image_size``; the JAX model's Dense infers
it). The features are flattened in (h, w, c) order, as flax flattens NHWC:
at 32x32 the last map is 1x1 and either order gives the same vector, at
64x64 only this one matches the JAX model's weights. Inputs smaller than
32x32 raise (five 2x2 max pools), as in the JAX model.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import BatchNorm, DropoutRng, dropout

CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}
ARCH_TO_CFG = {"vgg11": "A", "vgg13": "B", "vgg16": "D", "vgg19": "E"}


def _check_size(h: int, w: int) -> None:
    if h < 32 or w < 32:
        raise ValueError(
            f"VGG needs inputs >= 32x32 (five 2x2 maxpools); got {h}x{w}")


class VGG(nn.Module):
    def __init__(self, arch: str = "vgg11", num_classes: int = 10,
                 batch_norm: bool = False,
                 image_size: Sequence[int] = (32, 32)):
        super().__init__()
        h, w = image_size
        _check_size(h, w)
        cfg: Sequence[Union[int, str]] = CFGS[ARCH_TO_CFG[arch]]
        self.batch_norm = batch_norm
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList() if batch_norm else None
        self.flax_names = {}
        in_ch = 3
        for v in cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            i = len(self.convs)
            self.convs.append(nn.Conv2d(in_ch, int(v), 3, 1, 1))
            self.flax_names[f"convs.{i}"] = f"Conv_{i}"
            if batch_norm:
                self.bns.append(BatchNorm(int(v)))
                self.flax_names[f"bns.{i}"] = f"BatchNorm_{i}"
            in_ch = int(v)
        self.cfg = cfg
        self.fc1 = nn.Linear(in_ch * h * w, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, num_classes)
        self.flax_names.update(fc1="Dense_0", fc2="Dense_1", fc3="Dense_2")

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[DropoutRng] = None) -> torch.Tensor:
        _check_size(x.shape[1], x.shape[2])
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = self.convs[i](x)
            if self.batch_norm:
                x = self.bns[i](x, train)
            x = F.relu(x)
            i += 1
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c) order, as flax
        x = dropout(F.relu(self.fc1(x)), 0.5, train, generator)
        x = dropout(F.relu(self.fc2(x)), 0.5, train, generator)
        return self.fc3(x)
