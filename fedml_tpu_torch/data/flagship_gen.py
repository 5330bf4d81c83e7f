"""The generated flagship federations, with the reference loaders' shape
facts and synthetic content:

- ``femnist_gen``: 3400 clients, 62 classes, 28x28x1 images, a
  LEAF-writer-like size spread (reference FederatedEMNIST/data_loader.py:
  15-17, paired with CNN_DropOut), Bayes ceiling at the published 84.9%;
- ``fed_cifar100_gen``: 500 clients x 100 samples, 100 classes, 24x24x3
  crops (reference fed_cifar100/data_loader.py:17-19, paired with
  ResNet-18-GN), ceiling at 44.7%;
- ``stackoverflow_nwp_gen``: 342,477 clients of token sequences in the
  real loader's wire layout (pad 0, words 1..V, oov V+1, bos V+2, eos V+3),
  paired with the StackOverflow LSTM.

Image content is class-conditional low-frequency patterns plus pixel
noise, dominant-class skew per client, and flip-to-other label noise that
puts the Bayes ceiling at the reference's published number. Every client's
arrays are bit-identical to the same builders of
``fedml_tpu.data.flagship_gen`` for the same arguments: the numpy RNG
consumption order is the same. Generation is not cached on disk.
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


def _build(client_num: int, class_num: int, hw: int, chans: int,
           sizes: np.ndarray, seed: int, noise: float, label_noise_p: float,
           test_fraction: float, dominant: int = 2) -> FederatedDataset:
    train_local, test_local = {}, {}
    for i, train, test in stream_client_shards(
            client_num, class_num, hw, chans, sizes, seed, noise,
            label_noise_p, test_fraction, dominant):
        train_local[i] = train
        test_local[i] = test
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               class_num)


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
    return _build(client_num, class_num, 28, 1, sizes, seed, noise, p,
                  test_fraction)


def build_fedcifar100_federation(client_num: int = 500, seed: int = 0,
                                 target_acc: float = 0.447,
                                 noise: float = 0.45,
                                 samples_per_client: int = 100,
                                 test_fraction: float = 0.2
                                 ) -> FederatedDataset:
    """fed-CIFAR100-shape federation: 500 clients x 100 samples (uniform,
    as the TFF split), 100 classes, 24x24x3, ten dominant classes a
    client, Bayes ceiling at the reference's 44.7% anchor."""
    class_num = 100
    sizes = np.full(client_num, samples_per_client)
    p = label_noise_for_ceiling(target_acc, class_num)
    return _build(client_num, class_num, 24, 3, sizes, seed, noise, p,
                  test_fraction, dominant=10)


def build_stackoverflow_nwp_federation(client_num: int = 342477,
                                       seed: int = 0,
                                       vocab_size: int = 10000,
                                       seq_len: int = 20,
                                       follow_p: float = 0.75,
                                       topic_num: int = 100,
                                       test_fraction: float = 0.1
                                       ) -> FederatedDataset:
    """StackOverflow-NWP-shape federation at the reference's client count
    (342,477 users, stackoverflow_nwp/data_loader.py): per client a
    heavy-tailed number of sequences (median ~12, max 500) of bos + 20
    words + eos; x = w[:, :-1], y = w[:, 1:] (T = 21). Each next word
    follows a fixed random successor table with probability ``follow_p``,
    else a fresh draw from the client's topic-biased Zipf marginal, so an
    LSTM that learns the table nears ``follow_p`` token accuracy. Built
    vectorized over all sequences at once; ``class_num`` is V + 4, the
    nwp logits' width."""
    rng = np.random.RandomState(seed)
    V = vocab_size
    bos, eos = V + 2, V + 3
    sizes = np.clip(rng.lognormal(2.5, 1.0, client_num), 1, 500).astype(int)
    total = int(sizes.sum())
    client_of_seq = np.repeat(np.arange(client_num), sizes)

    # Zipf word marginal over 1..V, sampled by inverse CDF
    zipf_p = 1.0 / np.arange(1, V + 1)
    zipf_cdf = np.cumsum(zipf_p / zipf_p.sum())
    # per-client topic: a contiguous vocab block its fresh draws favor
    block = V // topic_num
    topic0 = (rng.randint(0, topic_num, client_num) * block).astype(np.int32)
    succ = rng.permutation(V).astype(np.int32) + 1  # successor table, 1..V

    def fresh(n, topic_starts):
        toks = (np.searchsorted(zipf_cdf, rng.random_sample(n)) + 1
                ).astype(np.int32)
        biased = rng.random_sample(n) < 0.5
        return np.where(biased, topic_starts + (toks - 1) % block + 1,
                        toks).astype(np.int32)

    seq_topics = topic0[client_of_seq]
    w = np.empty((total, seq_len + 2), np.int32)
    w[:, 0] = bos
    w[:, 1] = fresh(total, seq_topics)
    for t in range(2, seq_len + 1):
        follows = rng.random_sample(total) < follow_p
        w[:, t] = np.where(follows, succ[w[:, t - 1] - 1],
                           fresh(total, seq_topics))
    w[:, seq_len + 1] = eos

    x, y = w[:, :-1], w[:, 1:]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    train_local, test_local = {}, {}
    for c in range(client_num):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        n_test = max(1, int((hi - lo) * test_fraction)) if hi - lo > 1 else 0
        # a one-sequence client keeps it for training, its test split empty
        test_local[c] = (x[lo:lo + n_test], y[lo:lo + n_test])
        train_local[c] = (x[lo + n_test:hi], y[lo + n_test:hi])
    return FederatedDataset.from_client_arrays(train_local, test_local, V + 4)
