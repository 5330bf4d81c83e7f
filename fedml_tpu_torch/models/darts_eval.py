"""The DARTS evaluation network: a *derived* genotype trained from scratch.
The counterpart of ``fedml_tpu/models/darts_eval.py`` (reference
fedml_api/model/cv/darts/model.py: Cell:8-61 compiles the discrete
genotype into fixed ops with drop-path on each, AuxiliaryHeadCIFAR:64-83,
NetworkCIFAR:111-160, and utils.py drop_path).

The second half of the NAS workflow: FedNAS searches with
:class:`~fedml_tpu_torch.models.darts.DartsNetwork`, ``parse_genotype``
discretizes the alphas, and this network retrains the winning
architecture, with affine BatchNorm, drop-path, and optionally the
auxiliary head at 2/3 depth.

Drop-path zeroes a whole example's branch (a ``[B, 1, 1, 1]`` mask) and
scales the survivors by ``1/(1-p)``; it skips identity ops (model.py:
52-57). Its mask is a site of the port's counter hash
(:func:`~fedml_tpu_torch.models.common.drop_connect` over the train step's
``DropoutKey``), not flax's ``drop_path`` RNG stream. The auxiliary head
pools 5x5 at stride 3 without padding, and flattens its map in NHWC order,
as the flax head does. Inputs are NHWC, NCHW inside.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import (BatchNorm, drop_connect,
                                           nested_flax_names)
from fedml_tpu_torch.models.darts import (DilConv, FactorizedReduce,
                                          Genotype, ReLUConvBN, SepConv, pool)


class FixedOp(nn.Module):
    """One discrete primitive with affine BatchNorm (reference OPS[name](C,
    stride, affine=True), model.py:44-46)."""

    def __init__(self, prim: str, C: int, stride: int):
        super().__init__()
        self.prim, self.stride = prim, stride
        self.bn = self.op = None
        if prim in ("max_pool_3x3", "avg_pool_3x3"):
            self.bn = BatchNorm(C)
            self.flax_names = {"bn": "BatchNorm_0"}
            return
        if prim == "skip_connect":
            self.op = FactorizedReduce(C, C, affine=True) if stride != 1 \
                else None
            fname = "FactorizedReduce_0"
        elif prim in ("sep_conv_3x3", "sep_conv_5x5"):
            self.op = SepConv(C, C, int(prim[-1]), stride, affine=True)
            fname = "SepConv_0"
        elif prim in ("dil_conv_3x3", "dil_conv_5x5"):
            self.op = DilConv(C, C, int(prim[-1]), stride, affine=True)
            fname = "DilConv_0"
        else:
            raise ValueError(f"primitive {prim!r} cannot appear in a derived "
                             "genotype")
        self.flax_names = nested_flax_names(
            {}, [("op", fname, self.op)] if self.op is not None else [])

    @property
    def is_identity(self) -> bool:
        return self.prim == "skip_connect" and self.stride == 1

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.bn is not None:
            return self.bn(pool(x, self.prim[:3], self.stride), train)
        return x if self.op is None else self.op(x, train)


class GenotypeCell(nn.Module):
    """A fixed cell compiled from one half of a genotype (reference
    Cell._compile and forward, model.py:28-61)."""

    def __init__(self, genotype: Genotype, C_prev_prev: int, C_prev: int,
                 C: int, reduction: bool, reduction_prev: bool,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        if reduction_prev:
            self.preprocess0 = FactorizedReduce(C_prev_prev, C, affine=True)
            names = [("preprocess0", "FactorizedReduce_0"),
                     ("preprocess1", "ReLUConvBN_0")]
        else:
            self.preprocess0 = ReLUConvBN(C_prev_prev, C, affine=True)
            names = [("preprocess0", "ReLUConvBN_0"),
                     ("preprocess1", "ReLUConvBN_1")]
        self.preprocess1 = ReLUConvBN(C_prev, C, affine=True)
        gene = genotype.reduce if reduction else genotype.normal
        self.concat = tuple(genotype.reduce_concat if reduction
                            else genotype.normal_concat)
        self.inputs = [j for _, j in gene]
        self.ops = nn.ModuleList(
            FixedOp(prim, C, 2 if reduction and j < 2 else 1)
            for prim, j in gene)
        self.flax_names = nested_flax_names(
            {}, [(t, f, getattr(self, t)) for t, f in names]
            + [(f"ops.{k}", f"_FixedOp_{k}", op)
               for k, op in enumerate(self.ops)])

    def forward(self, s0, s1, train: bool, generator=None):
        states = [self.preprocess0(s0, train), self.preprocess1(s1, train)]
        for i in range(len(self.ops) // 2):
            h = None
            for k in (2 * i, 2 * i + 1):
                op = self.ops[k]
                out = op(states[self.inputs[k]], train)
                if train and self.drop_path_rate > 0 and not op.is_identity:
                    out = drop_connect(out, self.drop_path_rate, train,
                                       generator)
                h = out if h is None else h + out
            states.append(h)
        return torch.cat([states[i] for i in self.concat], 1)


class AuxiliaryHeadCIFAR(nn.Module):
    """The 8x8 feature maps -> auxiliary logits (reference model.py:64-83):
    ReLU, a 5x5 average pool at stride 3 without padding, a 1x1
    convolution to 128, BatchNorm, ReLU, a 2x2 convolution to 768 without
    padding, BatchNorm, ReLU, the NHWC flatten and a linear head.
    ``size`` is the side of the map it takes."""

    flax_names = {"conv1": "Conv_0", "bn1": "BatchNorm_0", "conv2": "Conv_1",
                  "bn2": "BatchNorm_1", "fc": "Dense_0"}

    def __init__(self, C: int, num_classes: int, size: int = 8):
        super().__init__()
        out = (size - 5) // 3 + 1 - 1  # the pool, then the 2x2 convolution
        if out < 1:
            raise ValueError(f"the auxiliary head needs a map of 8x8 or more, "
                             f"got {size}x{size}")
        self.conv1 = nn.Conv2d(C, 128, 1, bias=False)
        self.bn1 = BatchNorm(128)
        self.conv2 = nn.Conv2d(128, 768, 2, bias=False)
        self.bn2 = BatchNorm(768)
        self.fc = nn.Linear(768 * out * out, num_classes)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.avg_pool2d(F.relu(x), 5, 3)
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.relu(self.bn2(self.conv2(x), train))
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class GenotypeNetwork(nn.Module):
    """NetworkCIFAR (reference model.py:111-160): a stem, ``layers`` fixed
    cells with reductions at 1/3 and 2/3 depth, the optional auxiliary head
    after the cell at 2/3 depth, the global pool and a linear head. Returns
    the logits, or ``(logits, aux_logits)`` with ``auxiliary`` in train
    mode. ``image_size`` sizes the auxiliary head."""

    def __init__(self, genotype: Genotype, C: int = 36,
                 num_classes: int = 10, layers: int = 20,
                 auxiliary: bool = False, stem_multiplier: int = 3,
                 drop_path_rate: float = 0.0, image_size: int = 32,
                 in_channels: int = 3):
        super().__init__()
        self.aux_at = 2 * layers // 3 if auxiliary else -1
        C_curr = stem_multiplier * C
        self.stem = nn.Conv2d(in_channels, C_curr, 3, 1, 1, bias=False)
        self.stem_bn = BatchNorm(C_curr)
        C_pp, C_p, C_curr = C_curr, C_curr, C
        size, cells, reduction_prev = image_size, [], False
        children = []
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                C_curr *= 2
                size = -(-size // 2)
            cell = GenotypeCell(genotype, C_pp, C_p, C_curr, reduction,
                                reduction_prev, drop_path_rate)
            cells.append(cell)
            children.append((f"cells.{i}", f"GenotypeCell_{i}", cell))
            reduction_prev = reduction
            C_pp, C_p = C_p, len(cell.concat) * C_curr
            if i == self.aux_at:
                self.aux_head = AuxiliaryHeadCIFAR(C_p, num_classes, size)
                children.append(("aux_head", "AuxiliaryHeadCIFAR_0",
                                 self.aux_head))
        self.cells = nn.ModuleList(cells)
        self.classifier = nn.Linear(C_p, num_classes)
        self.flax_names = nested_flax_names(
            {"stem": "Conv_0", "stem_bn": "BatchNorm_0",
             "classifier": "Dense_0"}, children)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.stem_bn(self.stem(x.permute(0, 3, 1, 2)), train)
        s0 = s1 = x
        aux = None
        for i, cell in enumerate(self.cells):
            s0, s1 = s1, cell(s0, s1, train, generator)
            if i == self.aux_at and train:
                aux = self.aux_head(s1, train)
        logits = self.classifier(s1.mean((2, 3)))
        return (logits, aux) if aux is not None else logits
