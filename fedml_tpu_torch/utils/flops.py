"""Model cost accounting (the port's counterpart of
``fedml_tpu/utils/flops.py``).

:func:`analytic_flops` bills a function's FLOPs the way the JAX package's
jaxpr count does (``_eqn_flops``), but from the ATen ops that PyTorch
dispatches: ``fn`` runs under a counting ``TorchDispatchMode`` inside a
``FakeTensorMode``, so every op runs on shapes alone. Nothing executes on
any device, no RNG is drawn and no tensor the caller holds is written.
The bill:

- matmuls (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``) at
  ``2 * M * N * K``; the bias of an ``addmm`` at one FLOP an element;
- a convolution at ``2 * out_elems * C_in/groups * prod(kernel)`` (grouped
  and depthwise included), its bias at one FLOP an output element;
- ``convolution_backward`` as the convolutions the JAX package's
  transpose runs, one for each gradient its output mask asks for: the
  weight gradient at ``2 * numel(grad_output) * C_in/groups *
  prod(kernel)``, the input gradient at ``2 * numel(grad_input) *
  C_out/groups * prod(kernel)`` (its output is the input's size), the
  bias gradient as a reduction;
- floating-point elementwise ops (JAX's ``_ELEMWISE`` set and their ATen
  names: ``add``, ``mul``, ``exp``, ``where``, ``relu``, ...) at one FLOP
  an output element; the composite ones (``_log_softmax`` and friends) at
  the elementwise and reduction FLOPs of JAX's decomposition. Integer ops
  (a dropout mask's counter hash) are not FLOPs and bill 0;
- reductions (``sum``, ``amax``, ``max_pool2d``, ...) at one FLOP an input
  element (``mean`` adds its division);
- data movement and unknown ops at 0: a documented under-count
  (:attr:`FlopCounter.unbilled` lists them).

A Python loop's steps are counted as they run, so an ``epochs x batches``
local-training loop is billed step by step. The port's CUDA kernels are
never launched under the counter: each kernel's front end sees a fake
tensor and bills a formula from its shapes that equals what its plain
version's ops bill (``ops/aggregate.py``), or runs its plain version
(``ops/quantize.py``, ``ops/flash_attention.py``), so the card and the CPU
give the same count for the same round.

:func:`cost_analysis` returns ``{"flops", "bytes accessed"}`` (and the
FLOPs by class) from the same pass; "bytes accessed" is the inputs plus
outputs of each billed op, before any fusion (XLA's figure is after
fusion: a divergence).
"""

from __future__ import annotations

import contextlib
import math
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

#: ATen elementwise ops billed at one FLOP an output element (JAX's
#: ``_ELEMWISE`` set under its ATen names, plus the fused activations
#: whose JAX form is one such primitive)
_ELEMWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "neg", "abs",
    "sgn", "sign", "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    "exp", "exp2", "log", "log2", "log10", "expm1", "log1p", "tanh",
    "sigmoid", "erf", "erfinv", "sqrt", "rsqrt", "pow", "cos", "sin",
    "floor", "ceil", "round", "where", "nextafter", "atan2", "square",
    "reciprocal", "relu", "threshold_backward", "masked_fill", "lerp",
    "addcmul", "addcdiv", "xlogy", "hardtanh", "leaky_relu", "elu",
    "gelu", "silu", "hardswish", "hardsigmoid",
})

#: composite ops: (elementwise FLOPs an element, reduction FLOPs an
#: element) of the JAX decomposition, e.g. log_softmax = reduce_max, sub,
#: exp, reduce_sum, log, sub
_COMPOSITE = {
    "_log_softmax": (3, 2),
    "_log_softmax_backward_data": (3, 1),
    "_softmax": (3, 2),
    "_softmax_backward_data": (3, 1),
    "sigmoid_backward": (3, 0),
    "tanh_backward": (3, 0),
    "gelu_backward": (8, 0),
    "silu_backward": (5, 0),
}

#: reductions billed at one FLOP an input element
_REDUCTIONS = frozenset({
    "sum", "nansum", "prod", "amax", "amin", "argmax", "argmin", "cumsum",
    "logcumsumexp", "logsumexp", "max_pool2d_with_indices",
    "max_pool3d_with_indices", "avg_pool2d", "norm", "linalg_vector_norm",
    "var", "std", "var_mean", "std_mean", "nll_loss_forward",
    "nll_loss2d_forward",
})

_MATMUL = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv",
                     "dot", "vdot"})

#: classes of the bill (:attr:`FlopCounter.by_class`)
MATMUL_CONV = "matmul_conv"
ELEMENTWISE = "elementwise"
REDUCTION = "reduction"
KERNEL = "kernel"

#: the counters of the analyses running now, innermost last
_ACTIVE: List["FlopCounter"] = []


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _floating(tree) -> bool:
    return any(t.is_floating_point() or t.is_complex()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _prod(shape) -> int:
    return int(math.prod(int(s) for s in shape))


def _conv_flops(out_numel: int, contract: int, kernel) -> float:
    return 2.0 * out_numel * contract * _prod(kernel)


def _bill_conv(args, out) -> List[Tuple[str, float]]:
    x, w, bias = args[0], args[1], args[2]
    transposed, groups = bool(args[6]), int(args[8])
    kernel = w.shape[2:]
    contract = w.shape[0] // groups if transposed else w.shape[1]
    bill = [(MATMUL_CONV, _conv_flops(out.numel(), contract, kernel))]
    if bias is not None:
        bill.append((ELEMENTWISE, float(out.numel())))
    return bill


def _bill_conv_backward(args, out) -> List[Tuple[str, float]]:
    grad_out, x, w = args[0], args[1], args[2]
    transposed, groups = bool(args[7]), int(args[9])
    mask = args[10]
    kernel = w.shape[2:]
    bill = []
    if mask[0]:
        # the input gradient: a convolution whose output is the input's
        # size, contracting over the other side's channels
        contract = w.shape[1] if transposed else w.shape[0] // groups
        bill.append((MATMUL_CONV, _conv_flops(x.numel(), contract, kernel)))
    if mask[1]:
        # the weight gradient contracts over batch and space: as many
        # products as the forward's (the transposed form's forward runs
        # on the input's positions)
        base = x.numel() if transposed else grad_out.numel()
        bill.append((MATMUL_CONV, _conv_flops(base, w.shape[1], kernel)))
    if mask[2]:
        bill.append((REDUCTION, float(grad_out.numel())))
    return bill


def _bill_matmul(name: str, args, out) -> List[Tuple[str, float]]:
    if name in ("dot", "vdot"):
        return [(MATMUL_CONV, 2.0 * args[0].numel())]
    if name in ("mv", "addmv"):
        a = args[1] if name == "addmv" else args[0]
        bill = [(MATMUL_CONV, 2.0 * a.numel())]
    else:
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        bill = [(MATMUL_CONV, 2.0 * out.numel() * a.shape[-1])]
    if name.startswith("add") or name == "baddbmm":
        bill.append((ELEMENTWISE, float(out.numel())))
    return bill


def _op_bill(func, args, out) -> Optional[List[Tuple[str, float]]]:
    """``[(class, flops), ...]`` for one dispatched op, or None when the op
    is not billed (data movement, integer arithmetic, unknown ops)."""
    name = func.overloadpacket.__name__
    overload = func._overloadname
    if name.startswith("_foreach_"):
        base = name[len("_foreach_"):].rstrip("_")
        if base not in _ELEMWISE:
            return None
        outs = out if out is not None else args[0]
        if not _floating(outs):
            return None
        return [(ELEMENTWISE, float(sum(_numel(t) for t in outs)))]
    name = name.rstrip("_")
    if name == "convolution":
        return _bill_conv(args, out)
    if name == "convolution_backward":
        return _bill_conv_backward(args, out)
    if name in _MATMUL:
        return _bill_matmul(name, args, out)
    if name in ("max", "min") and overload in ("other", "out"):
        name = "maximum" if name == "max" else "minimum"
    if name in ("max", "min"):
        return [(REDUCTION, float(_numel(args[0])))]
    if name in _COMPOSITE:
        ew, red = _COMPOSITE[name]
        n = float(_numel(out if isinstance(out, torch.Tensor) else args[0]))
        return [(ELEMENTWISE, ew * n), (REDUCTION, red * n)]
    if name == "mean":
        return [(REDUCTION, float(_numel(args[0]))),
                (ELEMENTWISE, float(_numel(out)))]
    if name in _REDUCTIONS:
        return [(REDUCTION, float(_numel(args[0])))]
    if name == "nll_loss_backward":
        return [(ELEMENTWISE, float(_numel(args[2])))]
    if name in _ELEMWISE:
        res = out[0] if isinstance(out, (tuple, list)) else out
        if not isinstance(res, torch.Tensor) or not _floating(res):
            return None
        return [(ELEMENTWISE, float(res.numel()))]
    return None


class FlopCounter(TorchDispatchMode):
    """The counting dispatch mode: bills every op it sees (see the module
    docstring). ``flops`` and ``bytes_accessed`` are the totals;
    ``by_class`` splits the FLOPs into matmul/conv, elementwise,
    reduction and kernel front ends, ``by_op`` by op name; ``unbilled``
    counts the ops billed 0."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.by_class: Dict[str, float] = defaultdict(float)
        self.by_op: Dict[str, float] = defaultdict(float)
        self.unbilled: Counter = Counter()
        self._paused = 0

    def add(self, name: str, cls: str, flops: float,
            nbytes: float = 0.0) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes
        self.by_class[cls] += flops
        self.by_op[name] += flops

    @contextlib.contextmanager
    def paused(self):
        """Ops dispatched inside are not billed (a kernel front end runs
        its plain version here only for its outputs' shapes)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = func.overloadpacket.__name__
        try:
            bill = _op_bill(func, args, out)
        except Exception:  # an op with an unexpected signature bills 0
            bill = None
        if not bill:
            self.unbilled[name] += 1
            return out
        nbytes = float(_bytes((args, kwargs)) + _bytes(out))
        for i, (cls, flops) in enumerate(bill):
            self.add(name, cls, flops, nbytes if i == 0 else 0.0)
        return out


def is_fake(t) -> bool:
    """True for a tensor of a ``FakeTensorMode`` (shapes only, no data):
    what a kernel front end sees under :func:`analytic_flops`."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def bill_kernel(name: str, flops: float, nbytes: float,
                plain: Callable, *args, **kwargs):
    """A kernel front end's stand-in under the counter: bill ``flops``
    (the front end's formula) and ``nbytes``, and return ``plain(*args)``
    computed on the fake inputs with billing paused (only its outputs'
    shapes are wanted). With no counter running, just the plain
    version."""
    if not _ACTIVE:
        return plain(*args, **kwargs)
    counter = _ACTIVE[-1]
    with counter.paused():
        out = plain(*args, **kwargs)
    counter.add(name, KERNEL, float(flops), float(nbytes))
    return out


def count(fn: Callable, *args, **kwargs) -> FlopCounter:
    """Run ``fn(*args, **kwargs)`` on fake copies of every tensor in its
    arguments under a :class:`FlopCounter`; returns the counter. Tensors
    ``fn`` reaches otherwise (a module's own parameters) are faked on
    first use."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    args, kwargs = pytree.tree_map(
        lambda t: fake.from_tensor(t) if isinstance(t, torch.Tensor) else t,
        (args, kwargs))
    counter = FlopCounter()
    _ACTIVE.append(counter)
    try:
        with fake, counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return counter


def analytic_flops(fn: Callable, *args, **kwargs) -> float:
    """Backend-independent analytic FLOP count of ``fn(*args)``: see the
    module docstring. The card and the CPU give the same count for the
    same shapes."""
    return count(fn, *args, **kwargs).flops


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """``{"flops", "bytes accessed", "flops_by_class"}`` of ``fn(*args)``
    from one counting pass (bytes before fusion; the FLOPs split into
    matmul/conv, elementwise, reduction and kernel front ends)."""
    c = count(fn, *args, **kwargs)
    return {"flops": c.flops, "bytes accessed": c.bytes_accessed,
            "flops_by_class": dict(c.by_class)}


def _tensors(variables: Any):
    if isinstance(variables, torch.nn.Module):
        variables = variables.state_dict()
    return [t for t in pytree.tree_leaves(variables)
            if isinstance(t, torch.Tensor)]


def count_params(variables: Any) -> int:
    """Total element count of a state dict (parameters and buffers, as the
    JAX package counts every collection) or of a module's."""
    return sum(t.numel() for t in _tensors(variables))


def param_bytes(variables: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(variables))


def model_complexity(module: torch.nn.Module,
                     input_shape: Tuple[int, ...],
                     dtype=torch.float32, train: bool = False,
                     extra_forward_kwargs: Optional[dict] = None
                     ) -> Dict[str, float]:
    """Params, param bytes and forward FLOPs of ``module`` on one input of
    ``input_shape`` (the ptflops report of the reference's dev tool),
    counted as :func:`cost_analysis` counts."""
    x = torch.zeros(input_shape, dtype=dtype)
    kwargs = dict(extra_forward_kwargs or {})

    def forward(x):
        return module(x, train=train, **kwargs)

    costs = cost_analysis(forward, x)
    return {"params": float(count_params(module)),
            "param_bytes": float(param_bytes(module)),
            "flops": float(costs["flops"]),
            "bytes_accessed": float(costs["bytes accessed"])}
