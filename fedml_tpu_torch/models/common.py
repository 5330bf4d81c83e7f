"""Pieces shared by the model zoo: flax-matching initialization, dropout
from an explicit key (a ``torch.Generator`` or a graph-safe
:class:`DropoutKey`) and per-example drop-connect from the same key, and
the layers whose semantics follow flax's rather than torch's:
:class:`BatchNorm` (its running statistics handed back to the trainer,
never written in place), :class:`SameConv2d` (flax's ``"SAME"`` padding)
and the :class:`LSTM` layer of flax's ``OptimizedLSTMCell``."""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.core.sampling import counter_bits, fold32

# std of a unit normal truncated to [-2, 2]; flax's truncated lecun_normal
# divides by it so the truncated draw keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize every layer the way flax's defaults do, drawing from
    ``generator``: Linear and Conv kernels ``lecun_normal`` (truncated
    normal, variance 1/fan_in) and bias zeros; an embedding a plain normal
    of variance 1/width; GroupNorm and BatchNorm scale 1 and bias 0, the
    running mean 0 and variance 1; an LSTM's input kernels
    ``lecun_normal``, its recurrent kernels orthogonal (each gate's
    ``[H, H]`` block on its own, as flax draws one per gate) and its bias
    zeros. LayerNorms keep torch's ones and zeros, which are flax's too.
    The distributions match the JAX package's; the numbers do not
    (different generators)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, math.sqrt(1.0 / m.embedding_dim),
                            generator=generator)
        elif isinstance(m, (nn.GroupNorm, BatchNorm)):
            if m.weight is not None:  # an affine-free BatchNorm has none
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, LSTM):
            _lecun_normal_(m.weight_ih, m.weight_ih.shape[1], generator)
            for gate in m.weight_hh.chunk(4, 0):
                nn.init.orthogonal_(gate, generator=generator)
            m.bias.zero_()
    return module


# -- BatchNorm with flax's semantics -----------------------------------------

_BATCH_STATS = threading.local()


@contextlib.contextmanager
def collect_batch_stats():
    """Collect the new running statistics of every :class:`BatchNorm` that
    runs in train mode inside the block: yields ``{layer: (mean, var)}``.
    The sink is the calling thread's own (silos train on threads)."""
    prev = getattr(_BATCH_STATS, "sink", None)
    sink: Dict["BatchNorm", Tuple[torch.Tensor, torch.Tensor]] = {}
    _BATCH_STATS.sink = sink
    try:
        yield sink
    finally:
        _BATCH_STATS.sink = prev


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis (dim 1) of an NCHW tensor, the JAX package's ``models/common.bn``.

    Train mode normalizes with the statistics of the whole batch, padding
    rows included (the JAX forward sees the padded batch too), computed in
    f32 (or the input's wider float) as flax's ``use_fast_variance`` does:
    the *biased* variance
    ``E[x^2] - E[x]^2``, clipped at 0. The running statistics move by
    ``ra = 0.9 ra + 0.1 batch`` with that same variance, which is why
    ``F.batch_norm`` (it writes the unbiased variance) does not update
    them. The new values are not written into the buffers: they go to the
    :func:`collect_batch_stats` sink, and the trainer selects them like the
    params; train mode outside a sink raises rather than drop them. Eval
    mode normalizes with the running statistics. No ``num_batches_tracked``
    counter: every buffer is an f32 leaf the aggregation averages.

    ``affine=False`` is flax's ``use_scale=False, use_bias=False`` (the
    DARTS search cells' norm): no parameters at all, so the state dict
    holds the running statistics alone, as flax's variables do."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            sink = getattr(_BATCH_STATS, "sink", None)
            if sink is None:
                raise RuntimeError(
                    "BatchNorm in train mode outside collect_batch_stats(): "
                    "its new running statistics would be lost")
            axes = [d for d in range(x.dim()) if d != 1]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(axes)
            var = torch.clamp(torch.mean(xf * xf, axes) - mean * mean,
                              min=0.0)
            m = self.momentum
            sink[self] = (m * self.running_mean + (1.0 - m) * mean,
                          m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = x - mean.view(shape)
        if self.weight is None:
            return (y * torch.rsqrt(var + self.eps).view(shape)).to(x.dtype)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = y * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class LSTM(nn.Module):
    """One layer of flax's ``nn.RNN(nn.OptimizedLSTMCell(H))`` over ``[B,
    T, I]``, a fresh zero carry each call: the input projection of all T
    steps in one product, then one ``[H, 4H]`` recurrent product a step;
    gates i, f, g, o (sigmoid, sigmoid, tanh, sigmoid), ``c' = f c + i g``,
    ``h' = o tanh(c')``. ``weight_ih [4H, I]``, ``weight_hh [4H, H]`` and
    ``bias [4H]`` (the recurrent products' bias; the input kernels have
    none) stack the gates in that order, torch's layout for flax's eight
    kernels (utils/convert.py). Returns every step's ``h``, ``[B, T, H]``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size,
                                                  input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                  hidden_size))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = F.linear(x, self.weight_ih)  # [B, T, 4H]
        h = x.new_zeros(x.shape[0], self.hidden_size)
        c = torch.zeros_like(h)
        out = []
        for t in range(x.shape[1]):
            i, f, g, o = (F.linear(h, self.weight_hh, self.bias)
                          + xp[:, t]).chunk(4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, 1)


class DropoutKey:
    """The dropout key of one training step: an int64 seed, and a site
    counter that the host advances at each dropout call of the forward
    pass, so every layer draws its own mask. The mask of element ``i`` of
    site ``s`` is a hash of (seed, s, i) alone: it does not depend on the
    padded length a batch came from, on the device, or on whether a CUDA
    graph replays it. The seed is a Python int (the host loop: the site
    keys are then hashed on the host) or a 0-dim tensor (safe to capture:
    a replayed graph reads a new seed from the same memory); both give the
    same bits."""

    def __init__(self, seed):
        self.seed = seed
        self.site = 0
        self._folded = None

    def bits(self, shape, device) -> torch.Tensor:
        """The next site's 32-bit hash values (int64), one for every
        element of ``shape`` in row-major order of the logical shape."""
        if self._folded is None:
            s = self.seed
            if torch.is_tensor(s):
                s = s.to(torch.int64)
            self._folded = (s ^ (s >> 32)) & 0xFFFFFFFF
        key = fold32(self._folded, self.site)
        self.site += 1
        return counter_bits(key, math.prod(shape), device).view(shape)


DropoutRng = Union[torch.Generator, DropoutKey]


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[DropoutRng],
            mask_shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Inverted dropout as flax applies it: keep with probability ``1-p``
    and scale kept values by ``1/(1-p)``. The mask comes from ``generator``:
    a ``torch.Generator`` (``torch.rand``), or a :class:`DropoutKey` (a
    counter hash, kept where its 32 bits are at least ``p * 2**32``);
    training without one raises rather than reading torch's global RNG.
    ``mask_shape`` (default ``x.shape``) broadcasts one draw over the
    other axes."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit generator")
    shape = tuple(x.shape) if mask_shape is None else tuple(mask_shape)
    if isinstance(generator, DropoutKey):
        keep = generator.bits(shape, x.device) >= round(p * 2.0 ** 32)
    else:
        keep = torch.rand(shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def drop_connect(x: torch.Tensor, p: float, train: bool,
                 generator: Optional[DropoutRng]) -> torch.Tensor:
    """Per-example stochastic depth (EfficientNet's drop-connect): one
    keep draw an example, a ``[B, 1, 1, 1]`` mask, kept examples scaled by
    ``1/(1-p)``; the JAX package draws ``bernoulli(1-p)`` of that shape
    (``fedml_tpu/models/efficientnet.py:93-99``), the port the same site of
    the counter hash as :func:`dropout`."""
    return dropout(x, p, train, generator,
                   (x.shape[0],) + (1,) * (x.dim() - 1))


# -- flax's "SAME" padding -----------------------------------------------------

def same_pads(size: int, kernel: int, stride: int,
              dilation: int = 1) -> Tuple[int, int]:
    """``(before, after)`` padding of one spatial axis under flax's (XLA's)
    ``"SAME"``: the output has ``ceil(size / stride)`` positions and the
    total padding, split with the extra pixel after, is what that takes.
    At stride 2 on an even size it is asymmetric, (0, 1) for a 3x3 kernel
    and (1, 2) for a 5x5 one, which ``padding=k // 2`` does not give."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's default ``"SAME"`` padding, computed from
    each input's spatial size (:func:`same_pads`): symmetric padding goes to
    the convolution itself, an asymmetric one is an explicit ``F.pad``
    first."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__(in_channels, out_channels, kernel, stride, 0,
                         dilation, groups, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (th, bh), (tw, bw) = (
            same_pads(x.shape[d], self.kernel_size[i], self.stride[i],
                      self.dilation[i]) for i, d in enumerate((2, 3)))
        if th == bh and tw == bw:
            pad = (th, tw)
        else:
            x, pad = F.pad(x, (tw, bw, th, bh)), (0, 0)
        return F.conv2d(x, self.weight, self.bias, self.stride, pad,
                        self.dilation, self.groups)


def nested_flax_names(top: Dict[str, str], children) -> Dict[str, str]:
    """A model's ``flax_names`` (utils/convert.py): its own ``{torch
    submodule: flax module}`` entries, and each ``(torch prefix, flax
    prefix, child)``'s own ``flax_names`` under those prefixes."""
    names = dict(top)
    for tprefix, fprefix, child in children:
        for t, f in child.flax_names.items():
            names[f"{tprefix}.{t}"] = f"{fprefix}/{f}"
    return names
