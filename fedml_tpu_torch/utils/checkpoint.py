"""Round-level checkpoint and resume (the port's counterpart of
``fedml_tpu/utils/checkpoint.py``), the subsystem the reference lacks.

The checkpoint unit is the round state: ``{"variables": state dict[,
"server_opt": server optimizer state]}``, everything needed to restart
bit for bit, since client sampling and every random stream derive from
(seed, round) and data is re-packed from the dataset each round.

Layout (the JAX package's): one blob ``round_%08d`` a checkpoint and a
``round_%08d.json`` sidecar with the round index and metadata, each written
to a ``.tmp`` name and moved into place with ``os.replace``, the sidecar
last, so a crash leaves either a complete checkpoint or one that
:meth:`CheckpointManager.restore_latest` skips. ``keep_last_n`` garbage
collection also sweeps the ``.tmp`` and sidecar-less orphans of a crash.

The blob differs from the JAX package's: it is an ``.npz`` of flat named
arrays (a nest's path joined with ``/``: ``variables/linear.weight``,
``server_opt/mu/0``), not flax msgpack, so a JAX checkpoint is not read
by the port nor the other way round.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def flatten_state(state: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nest of dicts (string keys), lists and tuples whose leaves are
    tensors, arrays or numbers -> ``{path: ndarray}`` in walk order."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            if not isinstance(k, str) or "/" in k:
                raise ValueError(f"checkpoint key {k!r}: keys are strings "
                                 "without '/'")
            out.update(flatten_state(v, f"{prefix}{k}/"))
        return out
    if isinstance(state, (list, tuple)):
        out = {}
        for i, v in enumerate(state):
            out.update(flatten_state(v, f"{prefix}{i}/"))
        return out
    if isinstance(state, torch.Tensor):
        arr = state.detach().cpu().numpy()
    else:
        arr = np.asarray(state)
    return {prefix[:-1]: arr}


def unflatten_state(target: Any, flat: Dict[str, np.ndarray],
                    prefix: str = "") -> Any:
    """The nest of ``target`` with each leaf read from ``flat``: a tensor
    leaf comes back as a tensor on the template's device and dtype, any
    other leaf as the stored array. Shapes are checked against the
    template."""
    if isinstance(target, dict):
        return {k: unflatten_state(v, flat, f"{prefix}{k}/")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(unflatten_state(v, flat, f"{prefix}{i}/")
                            for i, v in enumerate(target))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint has no entry {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(np.shape(target)):
        raise ValueError(f"checkpoint entry {key!r} has shape {arr.shape}, "
                         f"the template {tuple(np.shape(target))}")
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=target.device, dtype=target.dtype)
    return arr


class CheckpointManager:
    def __init__(self, directory: str, keep_last_n: int = 3):
        self.directory = directory
        self.keep_last_n = keep_last_n
        os.makedirs(directory, exist_ok=True)

    def _path(self, round_idx: int) -> str:
        return os.path.join(self.directory, f"round_{round_idx:08d}")

    def save(self, round_idx: int, state: Any,
             metadata: Optional[Dict] = None) -> str:
        """``state`` is a nest (e.g. ``{"variables": ..., "server_opt":
        ...}``); returns the checkpoint path."""
        path = self._path(round_idx)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flatten_state(state))
        os.replace(tmp, path)
        # the sidecar last: _rounds() needs both files
        meta = {"round_idx": round_idx, **(metadata or {})}
        mtmp = path + ".json.tmp"
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, path + ".json")
        self._gc()
        return path

    def _rounds(self):
        names = set(os.listdir(self.directory))
        out = []
        for fn in names:
            if (fn.startswith("round_")
                    and not fn.endswith((".json", ".tmp"))
                    and fn + ".json" in names):
                out.append(int(fn.split("_")[1]))
        return sorted(out)

    def _gc(self) -> None:
        keep = set(self._rounds()[-self.keep_last_n:])
        # every round_* artifact that is not a kept checkpoint goes,
        # including .tmp files and sidecar-less blobs of a crash mid-save
        # (sorted: a crash mid-GC leaves a deterministic survivor set)
        for fn in sorted(os.listdir(self.directory)):
            if not fn.startswith("round_"):
                continue
            try:
                r = int(fn.split(".")[0].split("_")[1])
            except (IndexError, ValueError):
                continue
            if fn.endswith(".tmp") or r not in keep:
                try:
                    os.remove(os.path.join(self.directory, fn))
                except FileNotFoundError:
                    pass  # a concurrent collector took it first

    def latest_round(self) -> Optional[int]:
        rounds = self._rounds()
        return rounds[-1] if rounds else None

    def restore(self, round_idx: int, target: Any) -> Tuple[Any, Dict]:
        """``target`` is a nest with the right structure and shapes (e.g. a
        freshly initialized state); returns ``(state, metadata)``."""
        path = self._path(round_idx)
        with open(path, "rb") as f, np.load(f) as z:
            flat = {k: z[k] for k in z.files}
        with open(path + ".json") as f:
            meta = json.load(f)
        return unflatten_state(target, flat), meta

    def restore_latest(self, target: Any) -> Optional[Tuple[Any, Dict]]:
        r = self.latest_round()
        if r is None:
            return None
        return self.restore(r, target)
