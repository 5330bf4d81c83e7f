"""Backdoor / edge-case poisoning for robust-FL evaluation (the port's copy
of ``fedml_tpu/data/poisoned.py``, on the port's FederatedDataset).

Reference: fedml_api/data_preprocessing/edge_case_examples/data_loader.py:283
``load_poisoned_dataset`` — ships pickled poisoned image sets (southwest
airline planes -> "truck", ARDIS digits -> target label, etc.) that an
attacker client trains on (FedAvgRobustTrainer.py:23-28). Those artifacts are
download-time assets; the mechanism is (trigger or edge-case inputs) +
(flipped target labels). This module implements the mechanism directly:
- ``add_pixel_trigger`` — a bright patch trigger in a corner (BadNets-style)
- ``poison_dataset`` — apply trigger to a fraction and flip to the target
- ``make_backdoor_test_set`` — all-triggered inputs for attack-success-rate
  measurement (the reference's ``test_target_accuracy``,
  FedAvgRobustAggregator.py:270).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import torch

from fedml_tpu_torch.data.base import FederatedDataset


def add_pixel_trigger(x: np.ndarray, size: int = 3,
                      value: Optional[float] = None) -> np.ndarray:
    """Set a size x size bottom-right patch to the image max (trigger)."""
    out = np.array(x, copy=True)
    v = float(np.max(x)) if value is None else value
    out[..., -size:, -size:, :] = v
    return out


def poison_dataset(x: np.ndarray, y: np.ndarray, target_label: int,
                   poison_fraction: float = 0.5, trigger_size: int = 3,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Trigger + label-flip a random fraction of (x, y)."""
    rng = np.random.RandomState(seed)
    n = len(x)
    k = int(n * poison_fraction)
    idx = rng.choice(n, k, replace=False)
    xp = np.array(x, copy=True)
    yp = np.array(y, copy=True)
    xp[idx] = add_pixel_trigger(x[idx], size=trigger_size)
    yp[idx] = target_label
    return xp, yp


def make_backdoor_test_set(x: np.ndarray, target_label: int,
                           trigger_size: int = 3):
    """All inputs triggered, all labels = target: accuracy on this set is
    the attack success rate."""
    return (add_pixel_trigger(x, size=trigger_size),
            np.full(len(x), target_label, np.int32))


def load_edge_case_artifact(path: str, target_label: int = 9
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Ingest one of the reference's shipped poisoned corpora from disk.

    Accepts both on-disk formats the reference uses
    (edge_case_examples/data_loader.py:283-363):
    - southwest ``.pkl``: a raw pickled numpy image stack ``[N, H, W, C]``
      (uint8); every image gets the attacker's ``target_label`` (the
      reference hardcodes 9 = "truck", data_loader.py:370)
    - ARDIS / poisoned-MNIST ``.pt``/``.pth``: a torch-saved dataset (or
      ``(data, targets)`` pair); the artifact's own targets are kept when
      present (the reference feeds these loaders unchanged), otherwise
      filled with ``target_label``.

    Returns ``(x, y)`` with x float32 (uint8 inputs scaled to [0, 1],
    grayscale stacks expanded to NHW1). Only load artifacts you trust:
    both pickle and legacy torch.load execute arbitrary bytecode — the
    same trust model as running the reference's own loader on them.
    """
    data = targets = None
    if path.endswith((".pt", ".pth")):
        try:
            # safe deserialization first; reference artifacts that pickle
            # whole Dataset objects need the legacy (code-executing) path
            obj = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:  # any safe-load failure falls
            # through to the legacy code-executing loader, which raises
            # its own error if the artifact is truly unreadable
            obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, (tuple, list)) and len(obj) == 2:
            data, targets = obj
        else:
            data = getattr(obj, "data", None)
            targets = getattr(obj, "targets", None)
        if data is None:
            raise ValueError(
                f"{path}: torch artifact has no .data/.targets and is not "
                "a (data, targets) pair")
    else:
        import pickle
        with open(path, "rb") as f:
            data = pickle.load(f)
    x = np.asarray(data)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    else:
        x = np.asarray(x, np.float32)
    if x.ndim == 3:  # grayscale [N, H, W] -> NHWC
        x = x[..., None]
    if targets is not None:
        y = np.asarray(targets).reshape(-1).astype(np.int32)
    else:
        y = np.full(len(x), target_label, np.int32)
    if len(x) != len(y):
        raise ValueError(f"{path}: {len(x)} images but {len(y)} targets")
    return x, y


def mix_edge_case_into_client(dataset: FederatedDataset, client_idx: int,
                              x_edge: np.ndarray, y_edge: np.ndarray,
                              num_edge: int = 100, num_clean: int = 400,
                              seed: int = 0) -> FederatedDataset:
    """Build the attacker client the reference way: its local set becomes
    ``num_clean`` sampled clean examples + ``num_edge`` sampled edge-case
    examples with attacker labels (data_loader.py:379-409: N=100 poisoned,
    M=400 clean, mixed and shuffled). Returns a new FederatedDataset; the
    edge-case images must match the federation's sample shape."""
    xc, yc = dataset.train_data_local_dict[client_idx]
    if x_edge.shape[1:] != xc.shape[1:]:
        raise ValueError(
            f"edge-case images {x_edge.shape[1:]} don't match the "
            f"federation's sample shape {xc.shape[1:]}")
    if int(np.max(y_edge)) >= dataset.class_num:
        # an out-of-range attacker label (e.g. the reference's hardcoded
        # 9="truck" against a non-CIFAR federation) would silently turn
        # the loss NaN; fail loudly instead
        raise ValueError(
            f"attacker label {int(np.max(y_edge))} is out of range for a "
            f"{dataset.class_num}-class federation; pass a valid "
            "target_label")
    rng = np.random.RandomState(seed)
    clean_idx = rng.choice(len(xc), min(num_clean, len(xc)), replace=False)
    edge_idx = rng.choice(len(x_edge), min(num_edge, len(x_edge)),
                          replace=False)
    x = np.concatenate([xc[clean_idx], x_edge[edge_idx]]).astype(np.float32)
    y = np.concatenate([yc[clean_idx].astype(np.int32),
                        y_edge[edge_idx].astype(np.int32)])
    perm = rng.permutation(len(x))
    train_local = dict(dataset.train_data_local_dict)
    train_local[client_idx] = (x[perm], y[perm])
    return FederatedDataset.from_client_arrays(
        train_local, dataset.test_data_local_dict, dataset.class_num)
