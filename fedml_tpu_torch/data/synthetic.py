"""Synthetic federated datasets.

``make_blob_federated`` is a small deterministic gaussian-blob dataset, the
``blob`` default of the CLI and the workhorse of the LR tests;
``make_powerlaw_blob_federated`` the same features over LEAF-style
power-law client sizes (``powerlaw_blob``); ``make_synthetic_federated``
the LEAF synthetic(alpha, beta) federation (``synthetic``);
``make_image_blob_federated`` NHWC color-gradient images (``img_blob``,
the CIFAR ResNets' stand-in); ``make_shapes_segmentation`` pictures of
squares and circles with pixel labels (``seg_shapes``, FedSeg's data);
``make_token_federated`` the token
federation of the transformer LM's next-word-prediction path
(``token_blob``). Their draws are identical to those of the same functions
in ``fedml_tpu.data.synthetic`` for the same arguments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.core.sampling import locked_global_numpy_rng
from fedml_tpu_torch.data.base import FederatedDataset


def make_synthetic_federated(
    alpha: float = 1.0,
    beta: float = 1.0,
    client_num: int = 30,
    dim: int = 60,
    class_num: int = 10,
    seed: int = 0,
    mean_samples: int = 50,
    test_fraction: float = 0.2,
) -> FederatedDataset:
    """LEAF's synthetic(alpha, beta): per client a random linear softmax
    model and a shifted gaussian input law, lognormal client sizes."""
    rng = np.random.RandomState(seed)
    sizes = (rng.lognormal(4, 2, client_num).astype(int) + mean_samples)
    cov_diag = np.power(np.arange(1, dim + 1), -1.2)

    train_local, test_local = {}, {}
    for c in range(client_num):
        u = rng.normal(0, alpha)
        b_mean = rng.normal(0, beta)
        v = rng.normal(b_mean, 1, dim)
        W = rng.normal(u, 1, (dim, class_num))
        bias = rng.normal(u, 1, class_num)
        n = int(sizes[c])
        x = rng.multivariate_normal(v, np.diag(cov_diag), n).astype(
            np.float32)
        y = np.argmax(x @ W + bias, axis=1).astype(np.int32)
        n_test = max(1, int(n * test_fraction))
        train_local[c] = (x[n_test:], y[n_test:])
        test_local[c] = (x[:n_test], y[:n_test])
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               class_num)


def make_blob_federated(
    client_num: int = 10,
    samples_per_client: Optional[int] = None,
    dim: int = 20,
    class_num: int = 5,
    partition_method: str = "hetero",
    partition_alpha: float = 0.5,
    seed: int = 0,
    n_samples: int = 2000,
    noise: float = 1.0,
) -> FederatedDataset:
    """Separable gaussian blobs, partitioned homo/hetero (learnable by LR
    in a few full-batch steps)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(class_num, dim) * 3.0
    y = rng.randint(0, class_num, n_samples).astype(np.int32)
    x = (centers[y] + noise * rng.randn(n_samples, dim)).astype(np.float32)

    with locked_global_numpy_rng(seed):  # atomic seed+draws, ref parity
        mapping = partition_data(y, partition_method, client_num,
                                 alpha=partition_alpha, class_num=class_num)
    train_local, test_local = {}, {}
    for c, idxs in mapping.items():
        idxs = np.asarray(idxs)
        if samples_per_client:
            idxs = idxs[:samples_per_client]
        n_test = max(1, len(idxs) // 5)
        test_local[c] = (x[idxs[:n_test]], y[idxs[:n_test]])
        train_local[c] = (x[idxs[n_test:]], y[idxs[n_test:]])
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               class_num)


def make_powerlaw_blob_federated(
    client_num: int = 1000,
    dim: int = 32,
    class_num: int = 10,
    seed: int = 0,
    min_samples: int = 10,
    size_mean: float = 3.0,
    size_sigma: float = 1.2,
    max_samples: Optional[int] = None,
    noise: float = 1.0,
    test_fraction: float = 0.1,
) -> FederatedDataset:
    """Gaussian blobs over LEAF-style power-law client sizes (``min_samples
    + lognormal``, optionally capped), drawn in one vectorized pass."""
    rng = np.random.RandomState(seed)
    sizes = (min_samples
             + rng.lognormal(size_mean, size_sigma, client_num)).astype(int)
    if max_samples:
        sizes = np.minimum(sizes, max_samples)
    centers = rng.randn(class_num, dim) * 3.0
    total = int(sizes.sum())
    y = rng.randint(0, class_num, total).astype(np.int32)
    x = (centers[y] + noise * rng.randn(total, dim)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    train_local, test_local = {}, {}
    for c in range(client_num):
        xc = x[offsets[c]:offsets[c + 1]]
        yc = y[offsets[c]:offsets[c + 1]]
        n_test = max(1, int(len(xc) * test_fraction))
        test_local[c] = (xc[:n_test], yc[:n_test])
        train_local[c] = (xc[n_test:], yc[n_test:])
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               class_num)


def make_image_blob_federated(
    client_num: int = 4,
    samples_per_client: int = 32,
    image_size: int = 32,
    class_num: int = 4,
    partition_method: str = "homo",
    partition_alpha: float = 0.5,
    seed: int = 0,
) -> FederatedDataset:
    """NHWC image classification: each class a distinct low-frequency
    color pattern, plus noise; partitioned homo/hetero."""
    rng = np.random.RandomState(seed)
    s = image_size
    n = client_num * samples_per_client
    y = rng.randint(0, class_num, n).astype(np.int32)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    sigs = np.stack([np.stack([np.sin((c + 1) * np.pi * xx),
                               np.cos((c + 1) * np.pi * yy),
                               np.full_like(xx, (c + 1) / class_num)], -1)
                     for c in range(class_num)])  # [C, H, W, 3]
    x = (sigs[y] + 0.3 * rng.randn(n, s, s, 3)).astype(np.float32)

    with locked_global_numpy_rng(seed):  # atomic seed+draws, ref parity
        mapping = partition_data(y, partition_method, client_num,
                                 alpha=partition_alpha, class_num=class_num)
    train_local, test_local = {}, {}
    for c, idxs in mapping.items():
        idxs = np.asarray(idxs)
        n_test = max(1, len(idxs) // 5)
        test_local[c] = (x[idxs[:n_test]], y[idxs[:n_test]])
        train_local[c] = (x[idxs[n_test:]], y[idxs[n_test:]])
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               class_num)


def make_shapes_segmentation(
    client_num: int = 4,
    samples_per_client: int = 16,
    image_size: int = 32,
    seed: int = 0,
) -> FederatedDataset:
    """Synthetic semantic segmentation (``seg_shapes``, FedSeg's data): a
    bright square and a circle on a dark noisy background a picture, pixel
    labels {0: background, 1: square, 2: circle} (the circle wins where
    they overlap); learnable by the small SegNet within a few rounds."""
    if image_size < 16:
        raise ValueError(f"image_size must be >= 16 (got {image_size}): "
                         "shape placement needs room for 8px squares")
    rng = np.random.RandomState(seed)
    s = image_size
    yy, xx = np.mgrid[0:s, 0:s]

    def sample(n):
        imgs = rng.rand(n, s, s, 3).astype(np.float32) * 0.2
        labels = np.zeros((n, s, s), np.int32)
        for i in range(n):
            cx, cy = rng.randint(4, s - 10, 2)
            w = rng.randint(4, 8)
            sq = (xx >= cx) & (xx < cx + w) & (yy >= cy) & (yy < cy + w)
            imgs[i, sq] = [0.9, 0.2, 0.2] + 0.1 * rng.randn(3)
            labels[i][sq] = 1
            cx, cy = rng.randint(6, s - 6, 2)
            r = rng.randint(3, 6)
            ci = (xx - cx) ** 2 + (yy - cy) ** 2 <= r ** 2
            imgs[i, ci] = [0.2, 0.3, 0.9] + 0.1 * rng.randn(3)
            labels[i][ci] = 2
        return imgs, labels

    train_local, test_local = {}, {}
    for c in range(client_num):
        train_local[c] = sample(samples_per_client)
        test_local[c] = sample(max(2, samples_per_client // 4))
    return FederatedDataset.from_client_arrays(train_local, test_local, 3)


def make_token_federated(
    client_num: int = 8,
    vocab_size: int = 64,
    seq_len: int = 32,
    sequences_per_client: int = 32,
    seed: int = 0,
) -> FederatedDataset:
    """Synthetic next-word-prediction federation: token sequences drawn
    from a shared peaked Markov chain, with a per-client vocabulary
    rotation for heterogeneity. ``class_num`` doubles as the vocab size
    (the registry passes it to ``create_model`` as ``output_dim``)."""
    rng = np.random.RandomState(seed)
    # peaked ring transition: token t mostly steps to t+1 or t+3 (mod V)
    base = np.full((vocab_size, vocab_size), 0.02 / vocab_size)
    for t in range(vocab_size):
        base[t, (t + 1) % vocab_size] += 0.60
        base[t, (t + 3) % vocab_size] += 0.38
    base /= base.sum(1, keepdims=True)

    def sample_client(c, n):
        shift = c % 4  # heterogeneity: rotated vocabulary per client group
        seqs = np.empty((n, seq_len + 1), np.int32)
        for i in range(n):
            tok = rng.randint(vocab_size)
            for j in range(seq_len + 1):
                seqs[i, j] = (tok + shift) % vocab_size
                tok = rng.choice(vocab_size, p=base[tok])
        return seqs[:, :-1], seqs[:, 1:]

    train_local, test_local = {}, {}
    for c in range(client_num):
        train_local[c] = sample_client(c, sequences_per_client)
        test_local[c] = sample_client(c, max(2, sequences_per_client // 4))
    return FederatedDataset.from_client_arrays(train_local, test_local,
                                               vocab_size)
