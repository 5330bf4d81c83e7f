"""Convert the JAX package's flax variables into this package's state dicts.

The inverse of ``fedml_tpu/utils/torch_import.py``: flax variables, given as
nested dicts of numpy arrays, become a ``{name: tensor}`` state dict for the
port's model. Each port model names the flax module behind each of its
submodules (``flax_names``; nested flax modules as ``"Outer_0/Inner_1"``
paths). Leaves by layer type:

- Linear and Conv2d: ``kernel`` -> ``weight`` (dense [I, O] -> [O, I], conv
  HWIO -> OIHW) and ``bias`` -> ``bias`` (absent for a layer without one);
- LayerNorm: ``scale`` -> ``weight``, ``bias`` -> ``bias``;
- Embedding: ``embedding`` -> ``weight``, the layout unchanged.

Every shape is checked against the model, and an unknown or missing key
raises, so a layout drift can never load silently.

A params-shaped tree of the JAX package's other state (FedNova's momentum
buffer, an optimizer moment) converts as ``flax_to_state_dict({"params":
tree}, model)``; :func:`optax_state_to_port` converts a whole optax
optimizer state into the port's server optimizer state
(``algorithms/fedopt.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# flax leaf -> torch leaf, per torch layer type
_LEAVES = (
    ((nn.Linear, nn.Conv2d), {"kernel": "weight", "bias": "bias"}),
    (nn.LayerNorm, {"scale": "weight", "bias": "bias"}),
    (nn.Embedding, {"embedding": "weight"}),
)


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


def flax_to_state_dict(variables: Mapping[str, Any],
                       model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{"params": {flax module path: leaves}}`` -> the state dict of
    ``model`` (on the CPU, in the model's dtypes)."""
    extra = set(variables) - {"params"}
    if extra:
        raise ValueError(f"unknown flax collections: {sorted(extra)}")
    params = _flax_modules(variables["params"])
    target = model.state_dict()
    names: Dict[str, str] = model.flax_names
    unknown = set(params) - set(names.values())
    if unknown:
        raise ValueError(f"unknown flax modules: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for tname, fname in names.items():
        if fname not in params:
            raise KeyError(f"flax module {fname!r} (for {tname!r}) missing")
        leaves = params[fname]
        leaf_map = _leaf_map(model.get_submodule(tname), tname)
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
            want = tuple(target[key].shape)
            if arr.shape != want:
                raise ValueError(f"{fname}/{fleaf}: converted shape "
                                 f"{arr.shape} != {key} {want}")
            out[key] = torch.tensor(arr, dtype=target[key].dtype)
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
                    sd = flax_to_state_dict({"params": value}, model)
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
