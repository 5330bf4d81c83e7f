"""Convert the JAX package's flax variables into this package's state dicts.

The inverse of ``fedml_tpu/utils/torch_import.py``: flax variables, given as
nested dicts of numpy arrays, become a ``{name: tensor}`` state dict for the
port's model. Each port model names the flax module behind each of its
submodules (``flax_names``; nested flax modules as ``"Outer_0/Inner_1"``
paths). Leaves by layer type:

- Linear and Conv2d: ``kernel`` -> ``weight`` (dense [I, O] -> [O, I], conv
  HWIO -> OIHW) and ``bias`` -> ``bias`` (absent for a layer without one);
- LayerNorm and GroupNorm: ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- BatchNorm (``models/common.BatchNorm``): ``scale`` and ``bias`` as
  above (an affine-free one has neither, and flax no params entry for
  it), and from the ``batch_stats`` collection ``mean`` ->
  ``running_mean``, ``var`` -> ``running_var``;
- Embedding: ``embedding`` -> ``weight``, the layout unchanged;
- LSTM (``models/common.LSTM``): flax's ``OptimizedLSTMCell`` holds eight
  dense modules, ``{ii,if,ig,io}/kernel [I, H]`` (no bias) and
  ``{hi,hf,hg,ho}/{kernel [H, H], bias [H]}``; their transposed kernels
  stack, gates in the order i, f, g, o, into ``weight_ih [4H, I]`` and
  ``weight_hh [4H, H]``, their biases into ``bias [4H]``.

Every shape is checked against the model, and an unknown or missing key
raises, so a layout drift can never load silently.

A params-shaped tree of the JAX package's other state (FedNova's momentum
buffer, an optimizer moment) converts as ``flax_to_state_dict({"params":
tree}, model, params_only=True)``, which leaves the buffers out;
:func:`optax_state_to_port` converts a whole optax optimizer state into
the port's server optimizer state (``algorithms/fedopt.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from fedml_tpu_torch.models.common import LSTM, BatchNorm

# flax leaf -> torch leaf, per torch layer type
_LEAVES = (
    ((nn.Linear, nn.Conv2d), {"kernel": "weight", "bias": "bias"}),
    ((nn.LayerNorm, nn.GroupNorm, BatchNorm),
     {"scale": "weight", "bias": "bias"}),
    (nn.Embedding, {"embedding": "weight"}),
)
# the batch_stats collection's leaves of a BatchNorm
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_LSTM_GATES = ("i", "f", "g", "o")


def _to_torch_layout(kernel: np.ndarray, where: str) -> np.ndarray:
    if kernel.ndim == 4:
        return kernel.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kernel.ndim == 2:
        return kernel.T  # [I, O] -> [O, I]
    raise ValueError(f"{where}: kernel of rank {kernel.ndim} has no known "
                     "layout")


def _flax_modules(tree: Mapping[str, Any], prefix: str = "") -> Dict:
    """``{module path: {leaf: array}}`` for every dict of the tree that
    holds leaves."""
    out, leaves = {}, {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flax_modules(v, f"{prefix}{k}/"))
        else:
            leaves[k] = v
    if leaves:
        out[prefix.rstrip("/")] = leaves
    return out


def _leaf_map(module: nn.Module, tname: str) -> Dict[str, str]:
    for types, leaves in _LEAVES:
        if isinstance(module, types):
            return leaves
    raise ValueError(f"{tname}: no flax layout for {type(module).__name__}")


def _lstm_leaves(cell: Dict, fname: str, tname: str,
                 target: Dict) -> Dict[str, np.ndarray]:
    """The eight dense modules of one flax LSTM cell -> the port LSTM's
    ``weight_ih``, ``weight_hh`` and ``bias``."""
    def leaf(gate, name):
        mod = cell.get(gate)
        if mod is None or name not in mod:
            raise KeyError(f"flax leaf {fname}/{gate}/{name} missing")
        return np.asarray(mod[name])

    for gate, mod in cell.items():
        want = {"kernel", "bias"} if gate.startswith("h") else {"kernel"}
        if set(mod) - want:
            raise ValueError(f"{fname}/{gate}: unknown leaves "
                             f"{sorted(set(mod) - want)}")
    out = {
        "weight_ih": np.concatenate([leaf(f"i{g}", "kernel").T
                                     for g in _LSTM_GATES]),
        "weight_hh": np.concatenate([leaf(f"h{g}", "kernel").T
                                     for g in _LSTM_GATES]),
        "bias": np.concatenate([leaf(f"h{g}", "bias") for g in _LSTM_GATES]),
    }
    for leaf_name, arr in out.items():
        key = f"{tname}.{leaf_name}"
        if arr.shape != tuple(target[key].shape):
            raise ValueError(f"{fname}: converted {leaf_name} shape "
                             f"{arr.shape} != {key} "
                             f"{tuple(target[key].shape)}")
    return out


def flax_to_state_dict(variables: Mapping[str, Any],
                       model: torch.nn.Module,
                       params_only: bool = False) -> Dict[str, torch.Tensor]:
    """``{"params": {flax module path: leaves}[, "batch_stats": ...]}`` ->
    the state dict of ``model`` (on the CPU, in the model's dtypes);
    ``params_only`` converts a params-shaped tree into the parameter
    entries alone (no BatchNorm statistics)."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unknown flax collections: {sorted(extra)}")
    params = _flax_modules(variables["params"])
    stats = _flax_modules(variables.get("batch_stats", {}))
    target = model.state_dict()
    if params_only:
        keep = {n for n, _ in model.named_parameters(remove_duplicate=False)}
        target = {k: v for k, v in target.items() if k in keep}
    names: Dict[str, str] = model.flax_names
    lstms = {t: f for t, f in names.items()
             if isinstance(model.get_submodule(t), LSTM)}
    expected = {f for t, f in names.items() if t not in lstms}
    expected |= {f"{f}/{d}{g}" for f in lstms.values() for d in "ih"
                 for g in _LSTM_GATES}
    unknown = set(params) - expected
    if unknown:
        raise ValueError(f"unknown flax modules: {sorted(unknown)}")
    bns = {f for t, f in names.items()
           if isinstance(model.get_submodule(t), BatchNorm)}
    if "batch_stats" in variables and not bns:
        raise ValueError("unknown flax collections: ['batch_stats'] (the "
                         "model has no BatchNorm)")
    if set(stats) - bns:
        raise ValueError(f"unknown flax batch_stats modules: "
                         f"{sorted(set(stats) - bns)}")
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr, where):
        want = tuple(target[key].shape)
        if arr.shape != want:
            raise ValueError(f"{where}: converted shape {arr.shape} != "
                             f"{key} {want}")
        out[key] = torch.tensor(arr, dtype=target[key].dtype)

    for tname, fname in names.items():
        if tname in lstms:
            cell = {k[len(fname) + 1:]: v for k, v in params.items()
                    if k.startswith(fname + "/")}
            for leaf, arr in _lstm_leaves(cell, fname, tname,
                                          target).items():
                put(f"{tname}.{leaf}", arr, f"{fname}/{leaf}")
            continue
        leaf_map = _leaf_map(model.get_submodule(tname), tname)
        if fname in params:
            leaves = params[fname]
        elif fname in bns and model.get_submodule(tname).weight is None:
            leaves = {}  # an affine-free BatchNorm: flax keeps no params
        else:
            raise KeyError(f"flax module {fname!r} (for {tname!r}) missing")
        bad = set(leaves) - set(leaf_map)
        if bad:
            raise ValueError(f"{fname}: unknown leaves {sorted(bad)}")
        for fleaf, leaf in leaf_map.items():
            key = f"{tname}.{leaf}"
            if key not in target:
                if fleaf in leaves:
                    raise ValueError(f"{fname}/{fleaf} has no target {key!r}")
                continue
            if fleaf not in leaves:
                raise KeyError(f"flax leaf {fname}/{fleaf} missing")
            arr = np.asarray(leaves[fleaf])
            if fleaf == "kernel":
                arr = _to_torch_layout(arr, f"{fname}/{fleaf}")
            put(key, arr, f"{fname}/{fleaf}")
        if fname in bns and not params_only:
            got = stats.get(fname)
            if got is None:
                raise KeyError(f"flax batch_stats {fname!r} (for {tname!r}) "
                               "missing")
            if set(got) != set(_STAT_LEAVES):
                raise ValueError(f"batch_stats/{fname}: leaves "
                                 f"{sorted(got)} != {sorted(_STAT_LEAVES)}")
            for fleaf, leaf in _STAT_LEAVES.items():
                put(f"{tname}.{leaf}", np.asarray(got[fleaf]),
                    f"batch_stats/{fname}/{fleaf}")
    missing = set(target) - set(out)
    if missing:
        raise KeyError(f"state dict keys without a flax source: "
                       f"{sorted(missing)}")
    return out


def optax_state_to_port(state, model: torch.nn.Module) -> Dict[str, Any]:
    """An optax state over flax params -> the port's optimizer state: the
    fields of every state tuple in the (nested) chain state merged into
    one dict under optax's field names. A params-shaped field becomes a
    list of tensors in ``model.named_parameters()`` order; a scalar field
    (``count``) a 0-dim tensor of its dtype. ``EmptyState`` adds
    nothing."""
    names = [n for n, _ in model.named_parameters()]
    out: Dict[str, Any] = {}

    def walk(node):
        if hasattr(node, "_fields"):
            for field in node._fields:
                value = getattr(node, field)
                if isinstance(value, Mapping):
                    sd = flax_to_state_dict({"params": value}, model,
                                            params_only=True)
                    out[field] = [sd[n] for n in names]
                else:
                    out[field] = torch.from_numpy(np.array(value))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        else:
            raise ValueError(f"unknown optax state node {type(node)}")

    walk(state)
    return out
