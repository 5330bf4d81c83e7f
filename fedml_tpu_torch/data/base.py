"""The federated dataset contract and its pad-and-mask packing.

The reference's framework-wide ABI is a 9-tuple every loader returns:
``client_num, train_data_num, test_data_num, train_data_global,
test_data_global, train_data_local_num_dict, train_data_local_dict,
test_data_local_dict, class_num`` (e.g.
fedml_api/data_preprocessing/FederatedEMNIST/data_loader.py:149-150). The
dataset holds numpy arrays; ``pack_clients`` gathers a set of sampled
clients into rectangular padded-and-masked arrays whose leading axis is the
client axis, real rows first. Packing is host work; the round uploads its
result to the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]  # (x, y)


@dataclasses.dataclass
class FederatedDataset:
    client_num: int
    train_data_num: int
    test_data_num: int
    train_data_global: Arrays
    test_data_global: Arrays
    train_data_local_num_dict: Dict[int, int]
    train_data_local_dict: Dict[int, Arrays]
    test_data_local_dict: Dict[int, Optional[Arrays]]
    class_num: int

    @classmethod
    def from_client_arrays(cls, train_local: Dict[int, Arrays],
                           test_local: Dict[int, Optional[Arrays]],
                           class_num: int) -> "FederatedDataset":
        clients = sorted(train_local)
        xg = np.concatenate([train_local[c][0] for c in clients])
        yg = np.concatenate([train_local[c][1] for c in clients])
        tests = [test_local.get(c) for c in clients]
        tests = [t for t in tests if t is not None and len(t[0])]
        xt = np.concatenate([t[0] for t in tests]) if tests else xg[:0]
        yt = np.concatenate([t[1] for t in tests]) if tests else yg[:0]
        return cls(
            client_num=len(clients),
            train_data_num=len(xg),
            test_data_num=len(xt),
            train_data_global=(xg, yg),
            test_data_global=(xt, yt),
            train_data_local_num_dict={c: len(train_local[c][0])
                                       for c in clients},
            train_data_local_dict=train_local,
            test_data_local_dict=test_local,
            class_num=class_num,
        )

    # -- packing -----------------------------------------------------------
    @property
    def max_client_samples(self) -> int:
        return max(self.train_data_local_num_dict.values())

    def padded_len(self, batch_size: Optional[int]) -> int:
        """Static per-client length: max client size rounded up to a batch
        multiple (full batch => exactly the max size)."""
        n = self.max_client_samples
        if not batch_size:
            return n
        return ((n + batch_size - 1) // batch_size) * batch_size

    def cohort_padded_len(self, client_idxs,
                          batch_size: Optional[int]) -> int:
        """Cohort-shaped padded length: the sampled cohort's max client size
        rounded to a batch multiple, then snapped UP to a power-of-2 batch
        count, capped at the dataset-wide ``padded_len``."""
        n = max(self.train_data_local_num_dict[int(c)] for c in client_idxs)
        b = batch_size or 1
        nb = (n + b - 1) // b
        bucket = 1 << max(0, (nb - 1).bit_length())
        return min(bucket * b, self.padded_len(batch_size))

    def pack_clients(self, client_idxs, batch_size: Optional[int] = None,
                     n_pad: Optional[int] = None):
        """Gather sampled clients into [P, n_pad, ...] x / [P, n_pad, ...] y
        / [P, n_pad] mask arrays, real rows first. ``n_pad`` defaults to the
        dataset-wide static shape."""
        n_pad = n_pad or self.padded_len(batch_size)
        x0, y0 = self.train_data_local_dict[int(client_idxs[0])]
        P = len(client_idxs)
        x = np.empty((P, n_pad) + x0.shape[1:], dtype=x0.dtype)
        y = np.empty((P, n_pad) + y0.shape[1:], dtype=y0.dtype)
        mask = np.empty((P, n_pad), dtype=np.float32)
        xs = [self.train_data_local_dict[int(c)][0] for c in client_idxs]
        ys = [self.train_data_local_dict[int(c)][1] for c in client_idxs]
        for c, cx, cy in zip(client_idxs, xs, ys):
            if len(cx) > n_pad:
                raise ValueError(
                    f"client {c} has {len(cx)} samples > n_pad={n_pad}")
            if len(cx) != len(cy):
                raise ValueError(
                    f"client {c}: {len(cx)} samples but {len(cy)} labels")
        for i in range(P):
            n = len(xs[i])
            x[i, :n], x[i, n:] = xs[i], 0
            y[i, :n], y[i, n:] = ys[i], 0
            mask[i, :n], mask[i, n:] = 1.0, 0.0
        return x, y, mask

    def client_weights(self, client_idxs) -> np.ndarray:
        """Sample counts n_i for the weighted FedAvg average."""
        return np.array(
            [self.train_data_local_num_dict[int(c)] for c in client_idxs],
            dtype=np.float32)
