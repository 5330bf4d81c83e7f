"""The per-client hash of virtualized populations, the port's part of
``fedml_tpu/state/population.py``: ``_mix64`` (the splitmix64 finalizer)
and ``client_uniform`` (a uniform in (0, 1) that is a pure function of
``(seed, salt, client id)``), with the same uint64 bits and float64
uniforms as the JAX package's. The WAN world's traces and profiles
(``fedml_tpu_torch/wan``) key every per-client draw on it.

The rest of ``population.py`` (the virtual federated dataset, the Pareto
sizes, the store-backed shards and the population harness) is ROADMAP
Slice D item 23b.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1


def _mix64(v: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 -> well-mixed uint64.
    Wraparound is the algorithm, so the overflow warning is silenced."""
    with np.errstate(over="ignore"):
        v = (v + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_M64)
        v = ((v ^ (v >> np.uint64(30)))
             * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_M64)
        v = ((v ^ (v >> np.uint64(27)))
             * np.uint64(0x94D049BB133111EB)) & np.uint64(_M64)
        return v ^ (v >> np.uint64(31))


def client_uniform(cids, seed: int, salt: int = 0) -> np.ndarray:
    """Per-client uniform in (0, 1): a hash of (seed, salt, cid). The top
    53 bits of the hash scale to [0, 1), nudged off zero so a Pareto
    ``u ** (-1 / a)`` stays finite."""
    cids = np.asarray(cids, dtype=np.uint64)
    base = _mix64(np.uint64((seed * 0x5851F42D4C957F2D + salt) & _M64))
    u = _mix64(cids ^ base)
    return np.maximum((u >> np.uint64(11)) * (2.0 ** -53), 2.0 ** -53)
