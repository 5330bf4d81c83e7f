"""The generated FEMNIST-shape federation (the ``femnist_gen`` dataset).

Same shape facts as the reference loader: 62 classes, 28x28x1 images, a
LEAF-writer-like size spread (reference FederatedEMNIST/data_loader.py:15-17,
3400 natural clients, paired with CNN_DropOut). Content is synthetic:
class-conditional low-frequency patterns plus pixel noise, dominant-class
skew per client, and flip-to-other label noise that puts the Bayes ceiling
at the reference's published 84.9%.

Every client's arrays are bit-identical to
``fedml_tpu.data.flagship_gen.build_femnist_federation`` for the same seed:
the numpy RNG consumption order is the same. Generation is not cached on
disk.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset


def label_noise_for_ceiling(target_acc: float, class_num: int) -> float:
    """Label-flip probability whose Bayes ceiling is ``target_acc``:
    ``apply_label_noise`` keeps the true class with probability ``1-p``,
    which stays the argmax while ``p < (C-1)/C``."""
    if not 0.0 < target_acc <= 1.0:
        raise ValueError(f"target_acc {target_acc} outside (0, 1]")
    p = 1.0 - target_acc
    if p >= (class_num - 1) / class_num:
        raise ValueError(
            f"target_acc {target_acc} needs flip prob {p:.3f} >= "
            f"{(class_num - 1) / class_num:.3f}, where the true class "
            "stops being the argmax and the ceiling calibration breaks")
    return float(p)


def apply_label_noise(y: np.ndarray, p: float, class_num: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Flip each label to a uniformly random OTHER class with prob p."""
    if p <= 0.0:
        return y
    flip = rng.rand(len(y)) < p
    offs = rng.randint(1, class_num, len(y))
    return np.where(flip, (y + offs) % class_num, y).astype(y.dtype)


def _class_prototypes(rng: np.random.RandomState, class_num: int, hw: int,
                      chans: int) -> np.ndarray:
    """Per-class smooth intensity patterns in [0,1]^(hw*hw*chans): cosine
    mixtures keyed by class, per channel."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64) / hw
    protos = np.empty((class_num, hw, hw, chans), np.float64)
    for c in range(class_num):
        for ch in range(chans):
            f1, f2 = rng.randint(1, 5, 2)
            p1, p2 = rng.rand(2) * 2 * np.pi
            img = (np.cos(2 * np.pi * f1 * xx + p1)
                   * np.cos(2 * np.pi * f2 * yy + p2))
            img += 0.5 * np.cos(2 * np.pi * (xx + yy) * (c % 7 + 1) + ch)
            img = (img - img.min()) / (img.max() - img.min() + 1e-12)
            protos[c, :, :, ch] = img
    return protos


def stream_client_shards(client_num: int, class_num: int, hw: int,
                         chans: int, sizes: np.ndarray, seed: int,
                         noise: float, label_noise_p: float,
                         test_fraction: float, dominant: int = 2):
    """Yield ``(cid, (x_train, y_train), (x_test, y_test))`` one client at a
    time, in the reference builder's RNG consumption order."""
    rng = np.random.RandomState(seed)
    protos = _class_prototypes(rng, class_num, hw, chans)
    for i, n in enumerate(sizes):
        n = int(n)
        dom = rng.choice(class_num, dominant, replace=False)
        probs = np.full(class_num, 0.3 / (class_num - dominant))
        probs[dom] = 0.7 / dominant
        y_clean = rng.choice(class_num, n, p=probs).astype(np.int32)
        x = (protos[y_clean]
             + noise * rng.randn(n, hw, hw, chans)).astype(np.float32)
        x = np.clip(x, 0.0, 1.0)
        y = apply_label_noise(y_clean, label_noise_p, class_num, rng)
        n_test = max(1, int(n * test_fraction))
        yield i, (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test])


def build_femnist_federation(client_num: int = 3400, seed: int = 0,
                             target_acc: float = 0.849,
                             noise: float = 0.35,
                             test_fraction: float = 0.15) -> FederatedDataset:
    """FEMNIST-shape federation: 62 classes, 28x28x1, median ~150 samples
    per client, max 400, Bayes ceiling at the reference's 84.9% anchor."""
    class_num = 62
    rng = np.random.RandomState(seed + 1)
    sizes = np.clip((20 + rng.lognormal(4.9, 0.6, client_num)).astype(int),
                    20, 400)
    p = label_noise_for_ceiling(target_acc, class_num)
    train_local, test_local = {}, {}
    for i, train, test in stream_client_shards(
            client_num, class_num, 28, 1, sizes, seed, noise, p,
            test_fraction):
        train_local[i] = train
        test_local[i] = test
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               class_num)
