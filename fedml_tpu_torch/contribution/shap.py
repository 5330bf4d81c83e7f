"""Kernel SHAP — plain and federated-feature variants (the port's copy of
``fedml_tpu/contribution/shap.py``, numpy only).

Reference: fedml_api/contribution/vertical/federate_shap.py — the Shapley
kernel weight (:15), kernel_shap solving the weighted least squares over all
2^M coalitions (:39-63), and the federated variants that treat a block of
hidden/party-held features as ONE aggregated feature (:80-117 with the block
at the tail, :119-160 with an interior block of width ``step``).

Deltas from the reference: coalition masks are built vectorized (one [2^M, M] binary
matrix via bit tricks, not a powerset loop), all 2^M perturbed inputs go
through the model in a single batched call (one device program instead of
2^M host round-trips), and the WLS solve uses lstsq on the weighted system
rather than forming and inverting the normal matrix.
"""

from __future__ import annotations

from math import comb
from typing import Callable

import numpy as np


def shapley_kernel_weight(M: int, s: int) -> float:
    """pi(s) = (M-1) / (C(M,s) * s * (M-s)); the empty and full coalitions
    get the reference's large pseudo-infinite weight 10000
    (federate_shap.py:15-19)."""
    if s == 0 or s == M:
        return 10000.0
    return (M - 1) / (comb(M, s) * s * (M - s))


def _coalition_masks(M: int) -> np.ndarray:
    """[2^M, M] 0/1 matrix; row i is the binary expansion of i, i.e. the
    coalition with feature j present iff bit j of i is set."""
    idx = np.arange(2 ** M, dtype=np.int64)
    return ((idx[:, None] >> np.arange(M)) & 1).astype(np.float64)


def _solve_wls(X: np.ndarray, weights: np.ndarray,
               y: np.ndarray) -> np.ndarray:
    """argmin_phi sum_i w_i (X_i phi - y_i)^2 via lstsq on the sqrt-weighted
    system (stable where the reference's normal-equation inverse is not)."""
    sw = np.sqrt(weights)[:, None]
    phi, *_ = np.linalg.lstsq(X * sw, y * sw[:, 0], rcond=None)
    return phi


def kernel_shap(f: Callable, x: np.ndarray, reference: np.ndarray,
                M: int) -> np.ndarray:
    """Exact kernel SHAP over all 2^M coalitions.

    Returns [M+1]: per-feature Shapley values phi_1..phi_M plus the base
    value phi_0 (last entry, matching the reference's column layout where
    X[:, -1] = 1)."""
    x = np.asarray(x, np.float64).reshape(-1)
    reference = np.asarray(reference, np.float64).reshape(-1)
    S = _coalition_masks(M)                       # [2^M, M]
    V = reference[None, :] * (1 - S) + x[None, :M] * S
    if x.size > M:  # features beyond M stay at reference
        V = np.concatenate(
            [V, np.tile(reference[M:], (V.shape[0], 1))], axis=1)
    sizes = S.sum(axis=1).astype(int)
    weights = np.array([shapley_kernel_weight(M, s) for s in sizes])
    X = np.concatenate([S, np.ones((S.shape[0], 1))], axis=1)
    y = np.asarray(f(V.astype(np.float32))).reshape(-1).astype(np.float64)
    return _solve_wls(X, weights, y)


def _federated_shap(f: Callable, x: np.ndarray, reference: np.ndarray,
                    M: int, fed_pos: int, step: int) -> np.ndarray:
    """Shared core: the features [fed_pos, fed_pos+step) act as ONE
    aggregated coalition member; visible features are the others plus that
    block, so the design matrix has M_cur = M - step + 1 columns."""
    x = np.asarray(x, np.float64).reshape(-1)
    reference = np.asarray(reference, np.float64).reshape(-1)
    M_cur = M - step + 1
    S = _coalition_masks(M_cur)                   # [2^M_cur, M_cur]
    # map coalition columns -> real feature indices
    visible = [i for i in range(M) if not (fed_pos <= i < fed_pos + step)]
    col_of = {}
    cols_sorted = sorted(visible + [fed_pos])
    for col, feat in enumerate(cols_sorted):
        col_of[feat] = col
    V = np.tile(reference[:M], (S.shape[0], 1))
    for feat in visible:
        on = S[:, col_of[feat]] == 1
        V[on, feat] = x[feat]
    block_on = S[:, col_of[fed_pos]] == 1
    for feat in range(fed_pos, fed_pos + step):
        V[block_on, feat] = x[feat]
    sizes = S.sum(axis=1).astype(int)
    weights = np.array([shapley_kernel_weight(M_cur, s) for s in sizes])
    X = np.concatenate([S, np.ones((S.shape[0], 1))], axis=1)
    y = np.asarray(f(V.astype(np.float32))).reshape(-1).astype(np.float64)
    return _solve_wls(X, weights, y)


def kernel_shap_federated(f: Callable, x: np.ndarray, reference: np.ndarray,
                          M: int, fed_pos: int) -> np.ndarray:
    """Tail block [fed_pos, M) hidden behind one aggregated feature
    (reference kernel_shap_federated, federate_shap.py:80-117)."""
    return _federated_shap(f, x, reference, M, fed_pos, M - fed_pos)


def kernel_shap_federated_with_step(f: Callable, x: np.ndarray,
                                    reference: np.ndarray, M: int,
                                    fed_pos: int, step: int) -> np.ndarray:
    """Interior block of width ``step`` aggregated (reference
    kernel_shap_federated_with_step, federate_shap.py:119-160)."""
    return _federated_shap(f, x, reference, M, fed_pos, step)
