"""Non-IID data partitioning (LDA / Dirichlet) with reference-equivalent math.

Re-implements the reference partitioner
(fedml_core/non_iid_partition/noniid_partition.py:6-95): per-class Dirichlet
proportions, a balance mask that stops feeding clients already at their fair
share, and a retry loop guaranteeing every client holds >= 10 examples. The
numpy RNG call sequence is identical to ``fedml_tpu.core.partition``, so the
same seed gives the same partition.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from fedml_tpu_torch.core.sampling import locked_global_numpy_rng

MIN_SAMPLES_PER_CLIENT = 10


def partition_class_samples_with_dirichlet_distribution(
    N: int,
    alpha: float,
    client_num: int,
    idx_batch: List[List[int]],
    idx_k: np.ndarray,
):
    """Distribute the index pool ``idx_k`` (one class) across clients: one
    Dirichlet(alpha) draw, zero share for clients already at N/client_num,
    split the shuffled pool at the cumulative cut points. Returns the grown
    per-client index lists and the current minimum client size."""
    with locked_global_numpy_rng():
        np.random.shuffle(idx_k)
        proportions = np.random.dirichlet(np.repeat(alpha, client_num))
    proportions = np.array(
        [p * (len(batch) < N / client_num)
         for p, batch in zip(proportions, idx_batch)])
    proportions = proportions / proportions.sum()
    cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [batch + chunk.tolist()
                 for batch, chunk in zip(idx_batch, np.split(idx_k, cuts))]
    return idx_batch, min(len(batch) for batch in idx_batch)


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray, client_num: int, classes: int, alpha: float,
) -> Dict[int, List[int]]:
    """LDA partition (Hsu et al., arXiv:1909.06335) for classification
    labels: client -> sample indices, retried until every client has >= 10
    samples."""
    N = label_list.shape[0]
    if N < MIN_SAMPLES_PER_CLIENT * client_num:
        raise ValueError(
            f"cannot give {client_num} clients >= "
            f"{MIN_SAMPLES_PER_CLIENT} samples each from {N} total; "
            "reduce client_num, add data, or use partition_method='homo'")
    min_size = 0
    retries = 0
    idx_batch: List[List[int]] = []
    while min_size < MIN_SAMPLES_PER_CLIENT:
        retries += 1
        if retries > 1000:
            raise ValueError(
                f"LDA partition failed to give every one of {client_num} "
                f"clients >= {MIN_SAMPLES_PER_CLIENT} of {N} samples after "
                f"{retries - 1} retries (alpha={alpha} too small?); use "
                "partition_method='homo' or raise alpha")
        idx_batch = [[] for _ in range(client_num)]
        for k in range(int(classes)):
            idx_k = np.where(label_list == k)[0]
            idx_batch, min_size = \
                partition_class_samples_with_dirichlet_distribution(
                    N, alpha, client_num, idx_batch, idx_k)

    net_dataidx_map = {}
    with locked_global_numpy_rng():
        for i in range(client_num):
            np.random.shuffle(idx_batch[i])
            net_dataidx_map[i] = idx_batch[i]
    return net_dataidx_map


def homo_partition(n_samples: int, client_num: int) -> Dict[int, np.ndarray]:
    """IID partition: shuffle then split evenly."""
    with locked_global_numpy_rng():
        idxs = np.random.permutation(n_samples)
    return {i: batch
            for i, batch in enumerate(np.array_split(idxs, client_num))}


def partition_data(labels: np.ndarray, partition_method: str,
                   client_num: int, alpha: float = 0.5,
                   class_num: int | None = None) -> Dict[int, np.ndarray]:
    """cifar-style front end: 'homo' => IID split, 'hetero' => LDA(alpha)."""
    labels = np.asarray(labels)
    if partition_method == "homo":
        return homo_partition(len(labels), client_num)
    if partition_method == "hetero":
        k = class_num if class_num is not None else int(labels.max()) + 1
        raw = non_iid_partition_with_dirichlet_distribution(
            labels, client_num, k, alpha)
        return {i: np.asarray(v) for i, v in raw.items()}
    raise ValueError(f"unknown partition method: {partition_method!r}")
