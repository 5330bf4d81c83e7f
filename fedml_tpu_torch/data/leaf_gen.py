"""Generated LEAF-shape federations, as in-memory arrays:

- ``mnist_gen`` (:func:`build_leaf_mnist_federation`): 1000 power-law
  clients of 784-pixel "digits" (the reference's niid MNIST split, median
  tens of samples, max hundreds), 2-dominant-class skew, an optional
  label-noise ceiling, paired with LR;
- ``shakespeare_gen`` (:func:`build_shakespeare_federation`): 715 clients
  of 80-char windows in the char next-token layout of the LEAF Shakespeare
  loader (ids + 1 so 0 stays the pad), a per-token ceiling near the
  reference's 56.9%, paired with the char LSTM.

Every client's arrays are bit-identical to the same builders of
``fedml_tpu.data.leaf_gen`` for the same arguments (the same numpy RNG
consumption order). Nothing is written to or read from disk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.flagship_gen import (apply_label_noise,
                                               label_noise_for_ceiling)
from fedml_tpu_torch.data.leaf import VOCAB_SIZE, word_to_indices


def _digit_prototypes(rng: np.random.RandomState, class_num: int = 10,
                      hw: int = 28) -> np.ndarray:
    """Smooth per-class intensity patterns (low-frequency cosine
    mixtures), flattened."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64) / hw
    protos = []
    for c in range(class_num):
        f1, f2 = rng.randint(1, 4, 2)
        p1, p2 = rng.rand(2) * 2 * np.pi
        img = (np.cos(2 * np.pi * f1 * xx + p1)
               * np.cos(2 * np.pi * f2 * yy + p2))
        img += 0.5 * np.cos(2 * np.pi * (xx + yy) * (c % 5 + 1))
        img = (img - img.min()) / (img.max() - img.min())
        protos.append(img.reshape(-1))
    return np.asarray(protos)


def build_leaf_mnist_federation(client_num: int = 1000, seed: int = 0,
                                min_samples: int = 10,
                                size_mean: float = 3.2,
                                size_sigma: float = 1.1,
                                max_samples: int = 500,
                                noise: float = 0.25, class_num: int = 10,
                                test_fraction: float = 0.15,
                                target_acc: Optional[float] = None
                                ) -> FederatedDataset:
    """Power-law MNIST-shape federation: per-client ``(x[784], y)`` train
    and test splits, sizes ``min_samples + lognormal`` capped at
    ``max_samples``. ``target_acc`` sets a Bayes ceiling through symmetric
    label noise drawn from a stream of its own (features do not move);
    None keeps the noise-free corpus."""
    rng = np.random.RandomState(seed)
    protos = _digit_prototypes(rng, class_num)
    p_noise = (label_noise_for_ceiling(target_acc, class_num)
               if target_acc is not None else 0.0)
    rng_noise = np.random.RandomState(seed + 99991)
    sizes = np.minimum(
        (min_samples + rng.lognormal(size_mean, size_sigma,
                                     client_num)).astype(int),
        max_samples)
    train_local, test_local = {}, {}
    for i, n in enumerate(sizes):
        # skewed class mix: 2 dominant classes hold ~70% of the samples
        dom = rng.choice(class_num, 2, replace=False)
        probs = np.full(class_num, 0.3 / (class_num - 2))
        probs[dom] = 0.35
        y = rng.choice(class_num, int(n), p=probs).astype(np.int32)
        x = protos[y] + noise * rng.randn(int(n), protos.shape[1])
        x = np.clip(x, 0.0, 1.0).astype(np.float32)
        y = apply_label_noise(y, p_noise, class_num, rng_noise)
        n_test = max(1, int(n * test_fraction))
        test_local[i] = (x[:n_test], y[:n_test])
        train_local[i] = (x[n_test:], y[n_test:])
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               class_num)


_WORDS = ("the lord doth speak and all the court attend his word "
          "what light from yonder window breaks it is the east "
          "to be or not to be that is the question of the hour "
          "good night sweet prince and flights of angels sing "
          "now is the winter of our discontent made glorious summer "
          "friends romans countrymen lend me your ears i come ").split()


def build_shakespeare_federation(client_num: int = 715, seed: int = 0,
                                 target_acc: float = 0.569,
                                 seq_len: int = 80,
                                 follow_p: float = 0.5,
                                 min_windows: int = 10,
                                 max_windows: int = 400,
                                 test_fraction: float = 0.15
                                 ) -> FederatedDataset:
    """Shakespeare-shape federation at the reference's 715-client scale:
    x = 80-char id windows, y = x shifted left by one (ids + 1, 0 is the
    pad). Text is a successor chain over a pseudo-Shakespeare word list
    (the next word follows the chain with probability ``follow_p``), then
    symmetric char noise at the rate ``p`` that solves ``target = [(1-p) +
    p/C] (k + follow_p) / (k + 1)`` (k the mean word length, C the
    charset), so the per-token Bayes ceiling sits near ``target_acc``."""
    rng = np.random.RandomState(seed)
    vocab = sorted(set(_WORDS))
    succ = rng.permutation(len(vocab))
    charset = sorted(set("".join(vocab)) | {" "})
    C = len(charset)
    k = float(np.mean([len(w) for w in vocab]))
    structural = (k + follow_p) / (k + 1.0)
    p_char = float(np.clip((1.0 - target_acc / structural) * C / (C - 1.0),
                           0.0, 0.95))
    char_ids = np.asarray([word_to_indices(c)[0] + 1 for c in charset],
                          np.int32)

    sizes = np.clip((min_windows
                     + rng.lognormal(3.6, 0.9, client_num)).astype(int),
                    min_windows, max_windows)
    train_local, test_local = {}, {}
    for i, n_windows in enumerate(sizes):
        n_windows = int(n_windows)
        n_chars = seq_len + n_windows + 1
        w = rng.randint(len(vocab))
        words, total = [], 0
        while total < n_chars:
            words.append(vocab[w])
            total += len(vocab[w]) + 1
            w = (succ[w] if rng.random_sample() < follow_p
                 else rng.randint(len(vocab)))
        ids = np.asarray(word_to_indices(" ".join(words)), np.int32) + 1
        noise = rng.random_sample(len(ids)) < p_char
        ids = np.where(noise, char_ids[rng.randint(C, size=len(ids))], ids)
        win = np.lib.stride_tricks.sliding_window_view(ids, seq_len + 1)
        win = win[:n_windows]
        x, y = win[:, :-1], win[:, 1:]
        n_test = max(1, int(n_windows * test_fraction))
        test_local[i] = (x[:n_test].copy(), y[:n_test].copy())
        train_local[i] = (x[n_test:].copy(), y[n_test:].copy())
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               VOCAB_SIZE)
