"""Synthetic federated datasets.

``make_blob_federated`` is a small deterministic gaussian-blob dataset, the
``blob`` default of the CLI and the workhorse of the LR tests. Its draws are
identical to ``fedml_tpu.data.synthetic.make_blob_federated`` for the same
seed.
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
