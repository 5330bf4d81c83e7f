"""The DARTS search space, FedNAS's model family. The counterpart of
``fedml_tpu/models/darts.py`` (reference fedml_api/model/cv/darts/
{operations.py:4 OPS, model_search.py:10 MixedOp, :26 Cell, :172 Network,
genotypes.py:5 PRIMITIVES, model_search.py:262 the genotype's parse}).

As in the JAX package, the architecture parameters (alphas) are not
module parameters: the mixing weights (the softmaxed alphas, or GDAS's
straight-through one-hot) are inputs of ``forward``, so the alphas are
plain tensors the caller differentiates. A :class:`MixedOp` runs every
primitive and contracts the outputs with the weights in ``PRIMITIVES``
order.

flax's semantics, kept: the search cells' BatchNorm has no scale and no
bias (``BatchNorm(affine=False)``: no parameters at all), the stem's is
affine; every pool and convolution pads as flax's ``"SAME"`` does
(:func:`~fedml_tpu_torch.models.common.same_pads`, asymmetric at stride 2
on an even size); max pooling pads with -inf, average pooling divides by
the window's real pixels (``count_include_pad=False``); a depthwise
convolution has ``groups=C_in``; :class:`FactorizedReduce` slices
``x[:, :, 1:, 1:]``; the "none" op at stride 2 is zeros of ``C`` channels
at half the size. Inputs are NHWC, NCHW inside.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.models.common import (BatchNorm, SameConv2d,
                                           nested_flax_names, same_pads)

Genotype = namedtuple("Genotype", "normal normal_concat reduce reduce_concat")

PRIMITIVES = [
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
]


class ReLUConvBN(nn.Module):
    flax_names = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def __init__(self, C_in: int, C_out: int, kernel: int = 1,
                 stride: int = 1, affine: bool = False):
        super().__init__()
        self.conv = SameConv2d(C_in, C_out, kernel, stride)
        self.bn = BatchNorm(C_out, affine=affine)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.bn(self.conv(F.relu(x)), train)


class FactorizedReduce(nn.Module):
    flax_names = {"conv_1": "Conv_0", "conv_2": "Conv_1", "bn": "BatchNorm_0"}

    def __init__(self, C_in: int, C_out: int, affine: bool = False):
        super().__init__()
        self.conv_1 = SameConv2d(C_in, C_out // 2, 1, 2)
        self.conv_2 = SameConv2d(C_in, C_out - C_out // 2, 1, 2)
        self.bn = BatchNorm(C_out, affine=affine)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(x)
        return self.bn(torch.cat([self.conv_1(x),
                                  self.conv_2(x[:, :, 1:, 1:])], 1), train)


class SepConv(nn.Module):
    flax_names = {"dw1": "Conv_0", "pw1": "Conv_1", "bn1": "BatchNorm_0",
                  "dw2": "Conv_2", "pw2": "Conv_3", "bn2": "BatchNorm_1"}

    def __init__(self, C_in: int, C_out: int, kernel: int, stride: int,
                 affine: bool = False):
        super().__init__()
        self.dw1 = SameConv2d(C_in, C_in, kernel, stride, groups=C_in)
        self.pw1 = SameConv2d(C_in, C_in, 1)
        self.bn1 = BatchNorm(C_in, affine=affine)
        self.dw2 = SameConv2d(C_in, C_in, kernel, groups=C_in)
        self.pw2 = SameConv2d(C_in, C_out, 1)
        self.bn2 = BatchNorm(C_out, affine=affine)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.bn1(self.pw1(self.dw1(F.relu(x))), train)
        return self.bn2(self.pw2(self.dw2(F.relu(x))), train)


class DilConv(nn.Module):
    flax_names = {"dw": "Conv_0", "pw": "Conv_1", "bn": "BatchNorm_0"}

    def __init__(self, C_in: int, C_out: int, kernel: int, stride: int,
                 dilation: int = 2, affine: bool = False):
        super().__init__()
        self.dw = SameConv2d(C_in, C_in, kernel, stride, dilation,
                             groups=C_in)
        self.pw = SameConv2d(C_in, C_out, 1)
        self.bn = BatchNorm(C_out, affine=affine)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.bn(self.pw(self.dw(F.relu(x))), train)


def pool(x: torch.Tensor, kind: str, stride: int) -> torch.Tensor:
    """A 3x3 max or average pool with flax's ``"SAME"`` padding: max pads
    with -inf; average sums over the zero-padded window and divides by the
    count of real pixels in it (``count_include_pad=False``), as the JAX
    package's ``_pool`` does."""
    (t, b), (l, r) = (same_pads(x.shape[d], 3, stride) for d in (2, 3))
    if kind == "max":
        return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3,
                            stride)
    summed = F.avg_pool2d(F.pad(x, (l, r, t, b)), 3, stride) * 9.0
    ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
    counts = F.avg_pool2d(F.pad(ones, (l, r, t, b)), 3, stride) * 9.0
    return summed / counts


class MixedOp(nn.Module):
    """Every primitive on one edge, contracted with the mixing weights ``w``
    (reference MixedOp.forward, model_search.py:21-23)."""

    def __init__(self, C: int, stride: int):
        super().__init__()
        self.C, self.stride = C, stride
        self.max_bn = BatchNorm(C, affine=False)
        self.avg_bn = BatchNorm(C, affine=False)
        self.skip = FactorizedReduce(C, C) if stride != 1 else None
        self.sep3 = SepConv(C, C, 3, stride)
        self.sep5 = SepConv(C, C, 5, stride)
        self.dil3 = DilConv(C, C, 3, stride)
        self.dil5 = DilConv(C, C, 5, stride)
        # flax names each kind by its creation count inside the MixedOp
        children = [("sep3", "SepConv_0", self.sep3),
                    ("sep5", "SepConv_1", self.sep5),
                    ("dil3", "DilConv_0", self.dil3),
                    ("dil5", "DilConv_1", self.dil5)]
        if self.skip is not None:
            children.append(("skip", "FactorizedReduce_0", self.skip))
        self.flax_names = nested_flax_names(
            {"max_bn": "BatchNorm_0", "avg_bn": "BatchNorm_1"}, children)

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                train: bool) -> torch.Tensor:
        s = self.stride
        if s == 1:
            none = torch.zeros_like(x)
        else:
            none = x.new_zeros((x.shape[0], self.C, x.shape[2] // s,
                                x.shape[3] // s))
        outs = [none,
                self.max_bn(pool(x, "max", s), train),
                self.avg_bn(pool(x, "avg", s), train),
                x if self.skip is None else self.skip(x, train),
                self.sep3(x, train), self.sep5(x, train),
                self.dil3(x, train), self.dil5(x, train)]
        return torch.einsum("o,obchw->bchw", w, torch.stack(outs))


class Cell(nn.Module):
    """``steps`` nodes, each the sum of the MixedOps from every earlier
    state; the output concatenates the last ``multiplier`` states
    (reference Cell, model_search.py:26-60)."""

    def __init__(self, steps: int, multiplier: int, C_prev_prev: int,
                 C_prev: int, C: int, reduction: bool, reduction_prev: bool):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        if reduction_prev:
            self.preprocess0 = FactorizedReduce(C_prev_prev, C)
            names = [("preprocess0", "FactorizedReduce_0"),
                     ("preprocess1", "ReLUConvBN_0")]
        else:
            self.preprocess0 = ReLUConvBN(C_prev_prev, C)
            names = [("preprocess0", "ReLUConvBN_0"),
                     ("preprocess1", "ReLUConvBN_1")]
        self.preprocess1 = ReLUConvBN(C_prev, C)
        self.ops = nn.ModuleList(
            MixedOp(C, 2 if reduction and j < 2 else 1)
            for i in range(steps) for j in range(2 + i))
        self.flax_names = nested_flax_names(
            {}, [(t, f, getattr(self, t)) for t, f in names]
            + [(f"ops.{k}", f"MixedOp_{k}", op)
               for k, op in enumerate(self.ops)])

    def forward(self, s0, s1, weights: torch.Tensor, train: bool):
        states = [self.preprocess0(s0, train), self.preprocess1(s1, train)]
        offset = 0
        for _ in range(self.steps):
            s = None
            for j, h in enumerate(states):
                out = self.ops[offset + j](h, weights[offset + j], train)
                s = out if s is None else s + out
            offset += len(states)
            states.append(s)
        return torch.cat(states[-self.multiplier:], 1)


class DartsNetwork(nn.Module):
    """The search network (reference Network, model_search.py:172-231): a
    stem, ``layers`` cells with reductions at 1/3 and 2/3 depth, the global
    pool and a linear head. ``weights_normal`` and ``weights_reduce`` are
    the mixing weights ``[k, len(PRIMITIVES)]``, inputs and not
    parameters."""

    def __init__(self, C: int = 16, num_classes: int = 10, layers: int = 8,
                 steps: int = 4, multiplier: int = 4,
                 stem_multiplier: int = 3, in_channels: int = 3):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        C_curr = stem_multiplier * C
        self.stem = nn.Conv2d(in_channels, C_curr, 3, 1, 1, bias=False)
        self.stem_bn = BatchNorm(C_curr)
        C_pp, C_p, C_curr = C_curr, C_curr, C
        cells, reduction_prev = [], False
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                C_curr *= 2
            cells.append(Cell(steps, multiplier, C_pp, C_p, C_curr,
                              reduction, reduction_prev))
            reduction_prev = reduction
            C_pp, C_p = C_p, multiplier * C_curr
        self.cells = nn.ModuleList(cells)
        self.reductions = [c.ops[0].stride == 2 for c in cells]
        self.classifier = nn.Linear(C_p, num_classes)
        self.flax_names = nested_flax_names(
            {"stem": "Conv_0", "stem_bn": "BatchNorm_0",
             "classifier": "Dense_0"},
            [(f"cells.{i}", f"Cell_{i}", c) for i, c in enumerate(cells)])

    @staticmethod
    def num_edges(steps: int) -> int:
        return sum(2 + i for i in range(steps))

    def forward(self, x: torch.Tensor, weights_normal: torch.Tensor,
                weights_reduce: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem_bn(self.stem(x.permute(0, 3, 1, 2)), train)
        s0 = s1 = x
        for cell, reduction in zip(self.cells, self.reductions):
            w = weights_reduce if reduction else weights_normal
            s0, s1 = s1, cell(s0, s1, w, train)
        return self.classifier(s1.mean((2, 3)))


def init_alphas(steps: int, rng: np.random.RandomState):
    """``1e-3 * randn [k, len(PRIMITIVES)]`` for the normal and the reduce
    cells (reference _initialize_alphas, model_search.py:232-241)."""
    k = DartsNetwork.num_edges(steps)
    return (np.asarray(1e-3 * rng.randn(k, len(PRIMITIVES)), np.float32),
            np.asarray(1e-3 * rng.randn(k, len(PRIMITIVES)), np.float32))


def gumbel_softmax_weights(alphas: torch.Tensor, uniform: torch.Tensor,
                           tau, hard: bool = True) -> torch.Tensor:
    """GDAS's single-path sample (reference Network_GumbelSoftmax.forward,
    model_search_gdas.py:122-133, ``F.gumbel_softmax(alphas, tau, True)``)
    from ``uniform``, draws in ``[1e-20, 1)`` of ``alphas``' shape: the
    gumbel noise ``-log(-log(u))``, the soft sample ``softmax((alphas +
    g) / tau)``, and with ``hard`` its straight-through one-hot (the
    forward sees one primitive an edge, the gradient flows through the
    soft sample)."""
    gumbel = -torch.log(-torch.log(uniform))
    soft = torch.softmax((alphas + gumbel) / tau, dim=-1)
    if not hard:
        return soft
    onehot = F.one_hot(soft.argmax(-1), soft.shape[-1]).to(soft.dtype)
    return onehot + soft - soft.detach()


def gdas_tau(epoch: int, total_epochs: int, tau_max: float = 10.0,
             tau_min: float = 0.1) -> float:
    """Linear temperature annealing tau_max → tau_min over the search
    (the schedule GDAS drives through the reference's ``set_tau``,
    model_search_gdas.py:117-120; the paper's 10 → 0.1 default)."""
    if total_epochs <= 1:
        return tau_min
    frac = min(max(epoch / (total_epochs - 1), 0.0), 1.0)
    return tau_max + (tau_min - tau_max) * frac


def parse_genotype(alphas_normal: np.ndarray,
                   alphas_reduce: np.ndarray, steps: int = 4,
                   multiplier: int = 4) -> Genotype:
    """Discretize softmaxed alphas into the best-2-edges-per-node genotype
    (reference Network.genotype, model_search.py:262-296)."""

    def softmax(a):
        e = np.exp(a - a.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    none_idx = PRIMITIVES.index("none")

    def _parse(weights):
        gene = []
        start, n = 0, 2
        for i in range(steps):
            W = weights[start:start + n]
            edges = sorted(
                range(n),
                key=lambda j: -max(W[j][k] for k in range(len(W[j]))
                                   if k != none_idx))[:2]
            for j in edges:
                k_best = max((k for k in range(len(W[j])) if k != none_idx),
                             key=lambda k: W[j][k])
                gene.append((PRIMITIVES[k_best], j))
            start += n
            n += 1
        return tuple(gene)

    concat = tuple(range(2 + steps - multiplier, steps + 2))
    return Genotype(normal=_parse(softmax(alphas_normal)),
                    normal_concat=concat,
                    reduce=_parse(softmax(alphas_reduce)),
                    reduce_concat=concat)
