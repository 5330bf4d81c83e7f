"""Synthetic federated datasets.

``make_blob_federated`` is a small deterministic gaussian-blob dataset, the
``blob`` default of the CLI and the workhorse of the LR tests;
``make_token_federated`` is the token federation of the transformer LM's
next-word-prediction path (``token_blob``). Their draws are identical to
those of the same functions in ``fedml_tpu.data.synthetic`` for the same
arguments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.core.sampling import locked_global_numpy_rng
from fedml_tpu_torch.data.base import FederatedDataset


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
