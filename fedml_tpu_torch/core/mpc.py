"""Finite-field MPC primitives for secure aggregation (TurboAggregate):
the port's copy of ``fedml_tpu/core/mpc.py``, numpy only.

Re-expression of the reference's coded-computing toolbox
(fedml_api/distributed/turboaggregate/mpc_function.py): Lagrange coefficient
generation (:39), BGW Shamir-style share encode/decode (:62, :96), LCC encode
/decode (:111, :196), additive secret sharing (:225), and fixed-point
quantization connecting float model deltas to the field.

Design: all share algebra is **vectorized numpy int64** — an encode is a
(K+T)-term mod-p accumulation of ``coeff * shard`` outer products instead of
the reference's per-(i,j) Python loops. Products of two residues < p < 2^31
fit in int64; we reduce mod p after every term so sums never overflow.
Modular inverses use Fermat (pow(a, p-2, p)) in exact Python ints. The field
work is host-side glue around the round (its cost is O(model size), not
O(FLOPs)); the model math it protects stays on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# largest prime below 2^31 keeps residue products inside int64
DEFAULT_PRIME = 2_147_483_647


def modular_inv(a: int, p: int) -> int:
    return pow(int(a) % p, p - 2, p)


def gen_lagrange_coeffs(alpha_s, beta_s, p: int) -> np.ndarray:
    """U[i, j] = prod_{o != beta_j}(alpha_i - o) / prod_{o != beta_j}(beta_j - o)
    mod p — evaluation of the Lagrange basis l_j at the alpha points
    (reference gen_Lagrange_coeffs, mpc_function.py:39-58)."""
    alpha_s = np.asarray(alpha_s, dtype=np.int64) % p
    beta_s = np.asarray(beta_s, dtype=np.int64) % p
    nb = len(beta_s)
    U = np.zeros((len(alpha_s), nb), dtype=np.int64)
    for j in range(nb):
        others = np.delete(beta_s, j)
        den = 1
        for o in others:
            den = den * int((beta_s[j] - o) % p) % p
        inv_den = modular_inv(den, p)
        num = np.ones(len(alpha_s), dtype=np.int64)
        for o in others:
            num = num * ((alpha_s - o) % p) % p
        U[:, j] = num * inv_den % p
    return U


def _mod_matmul(U: np.ndarray, X: np.ndarray, p: int) -> np.ndarray:
    """(U @ X) mod p without overflow: accumulate one rank-1 term at a time,
    reducing after each (terms are < p^2 < 2^62; the running sum stays < p)."""
    out = np.zeros((U.shape[0],) + X.shape[1:], dtype=np.int64)
    for j in range(U.shape[1]):
        out = (out + U[:, j].reshape((-1,) + (1,) * (X.ndim - 1)) * X[j] % p) % p
    return out


# -- BGW (Shamir) -----------------------------------------------------------

def bgw_encoding(X: np.ndarray, N: int, T: int, p: int,
                 rng: np.random.RandomState) -> np.ndarray:
    """Degree-T shares of secret X for N workers: f(alpha) = X + sum_t R_t
    alpha^t at alpha in 1..N (reference BGW_encoding, mpc_function.py:62-75)."""
    X = np.asarray(X, dtype=np.int64) % p
    alpha_s = np.arange(1, N + 1, dtype=np.int64) % p
    coeffs = np.concatenate(
        [X[None], rng.randint(0, p, size=(T,) + X.shape).astype(np.int64)])
    # Vandermonde [N, T+1] of alpha^t, then a mod-matmul over t
    V = np.ones((N, T + 1), dtype=np.int64)
    for t in range(1, T + 1):
        V[:, t] = V[:, t - 1] * alpha_s % p
    return _mod_matmul(V, coeffs, p)


def bgw_decoding(shares: np.ndarray, worker_idx: Sequence[int],
                 p: int) -> np.ndarray:
    """Reconstruct f(0) from >= T+1 shares via Lagrange at 0 (reference
    BGW_decoding, mpc_function.py:96-110)."""
    alpha_eval = (np.asarray(worker_idx, dtype=np.int64) + 1) % p
    lam = gen_lagrange_coeffs(np.zeros(1, np.int64), alpha_eval, p)
    return _mod_matmul(lam, np.asarray(shares, np.int64) % p, p)[0]


# -- LCC --------------------------------------------------------------------

def _lcc_points(N: int, K: int, T: int, p: int):
    n_beta = K + T
    stt_b, stt_a = -(n_beta // 2), -(N // 2)
    beta_s = np.arange(stt_b, stt_b + n_beta, dtype=np.int64) % p
    alpha_s = np.arange(stt_a, stt_a + N, dtype=np.int64) % p
    return alpha_s, beta_s


def lcc_encoding(X: np.ndarray, N: int, K: int, T: int, p: int,
                 rng: np.random.RandomState) -> np.ndarray:
    """Split X into K shards, pad with T random shards, interpolate the
    degree-(K+T-1) polynomial through them at beta points, evaluate at N
    alpha points (reference LCC_encoding, mpc_function.py:111-135)."""
    X = np.asarray(X, dtype=np.int64) % p
    m = X.shape[0]
    assert m % K == 0, "rows must divide into K shards"
    shards = X.reshape(K, m // K, *X.shape[1:])
    if T:
        noise = rng.randint(0, p, size=(T,) + shards.shape[1:]).astype(
            np.int64)
        shards = np.concatenate([shards, noise])
    alpha_s, beta_s = _lcc_points(N, K, T, p)
    U = gen_lagrange_coeffs(alpha_s, beta_s, p)
    return _mod_matmul(U, shards, p)


def lcc_decoding(f_eval: np.ndarray, N: int, K: int, T: int,
                 worker_idx: Sequence[int], p: int) -> np.ndarray:
    """Invert: interpolate the degree-(K+T-1) polynomial through >= K+T
    surviving alpha evaluations, read the K data beta points back (reference
    LCC_decoding, mpc_function.py:196-213)."""
    alpha_s, beta_all = _lcc_points(N, K, T, p)
    beta_s = beta_all[:K]  # data shards live at the first K beta points
    alpha_eval = alpha_s[np.asarray(worker_idx)]
    U_dec = gen_lagrange_coeffs(beta_s, alpha_eval, p)
    out = _mod_matmul(U_dec, np.asarray(f_eval, np.int64) % p, p)
    return out.reshape((-1,) + f_eval.shape[2:])


def gen_additive_ss(x: np.ndarray, n_out: int, p: int,
                    rng: np.random.RandomState) -> np.ndarray:
    """n_out shares summing to x mod p (reference Gen_Additive_SS,
    mpc_function.py:225-235)."""
    x = np.asarray(x, dtype=np.int64) % p
    shares = rng.randint(0, p, size=(n_out - 1,) + x.shape).astype(np.int64)
    last = (x - shares.sum(axis=0)) % p
    return np.concatenate([shares, last[None]])


# -- fixed-point quantization ----------------------------------------------

def quantize(x: np.ndarray, p: int = DEFAULT_PRIME,
             frac_bits: int = 16) -> np.ndarray:
    """Float -> field: round(x * 2^frac) with negatives wrapped mod p."""
    q = np.round(np.asarray(x, np.float64) * (1 << frac_bits)).astype(np.int64)
    return q % p


def dequantize(q: np.ndarray, p: int = DEFAULT_PRIME,
               frac_bits: int = 16) -> np.ndarray:
    """Field -> float, mapping residues above p/2 back to negatives."""
    q = np.asarray(q, np.int64) % p
    signed = np.where(q > p // 2, q - p, q)
    return signed.astype(np.float64) / (1 << frac_bits)
