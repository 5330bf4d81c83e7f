"""Client sampling with exact RNG parity to the reference, plus the port's
per-round seed chain.

The reference seeds numpy with the round index before each draw so that any
two implementations select the same clients every round (reference:
fedml_api/distributed/fedavg/FedAVGAggregator.py:89-97 and
fedml_api/standalone/fedavg/fedavg_api.py:96-114). The draw stream here is
byte-identical to ``fedml_tpu.core.sampling``: seed the GLOBAL numpy RNG,
then draw, under one process-wide lock.

Sampling happens on the host (it is O(clients) integer work per round); the
resulting index vector selects which client shards get packed and uploaded.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

#: the reference contract pins the draw to the GLOBAL numpy RNG
#: (np.random.seed(round_idx) then choice). That state is shared
#: process-wide, so the cohort prefetch worker drawing round r+1 while the
#: main thread draws round r would interleave seed/draw pairs. Each call
#: re-seeds, so mutual exclusion alone restores the exact per-round stream.
#: RLock: the partitioners hold it across a seed+draws sequence and call
#: helpers that take it per draw.
_GLOBAL_RNG_LOCK = threading.RLock()


@contextlib.contextmanager
def locked_global_numpy_rng(seed: Optional[int] = None):
    """The sanctioned way to touch the process-global numpy RNG.

    Holds the lock across the caller's whole seed+draws sequence (the
    LDA/homo partitioners' seed-then-draw bit parity), so no concurrent
    ``sample_clients`` can interleave with either stream. ``seed`` is
    applied inside the lock. Yields the ``np.random`` module."""
    with _GLOBAL_RNG_LOCK:
        if seed is not None:
            np.random.seed(seed)
        yield np.random


#: sentinel fold index OUTSIDE the client-id range: client c's training
#: seed is derived from (round seed, c), so the server-side aggregation
#: seed uses an id no client can occupy (client ids are int32-positive)
AGG_KEY_SENTINEL = 2**31 - 1

#: population size above which ``sample_clients`` switches to the O(k)
#: partial Fisher-Yates draw instead of numpy's O(N) permutation-based
#: ``choice``; the same value as the reference package, so both packages
#: draw the same cohorts. ``$FEDML_TPU_TORCH_VIRTUAL_SAMPLE_THRESHOLD``
#: overrides it for this package.
VIRTUAL_SAMPLE_THRESHOLD = 1 << 19


def _virtual_sample_threshold() -> int:
    env = os.environ.get("FEDML_TPU_TORCH_VIRTUAL_SAMPLE_THRESHOLD")
    return int(env) if env else VIRTUAL_SAMPLE_THRESHOLD


def derive_seed(*parts: int) -> int:
    """A 63-bit seed that is a pure function of ``parts`` (numpy's
    SeedSequence hash), the link of the port's seed chain."""
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return ((int(state[1]) << 32) | int(state[0])) & (2**63 - 1)


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def round_keys(base_seed: int, round_idx: int, client_ids):
    """The per-round seed chain every FedAvg-family driver shares:
    ``round_seed = derive(base, round)``, per-client training seeds
    ``derive(round_seed, client_id)``, and the aggregation seed at the
    ``AGG_KEY_SENTINEL`` id. Seeds are Python ints; callers turn them into
    explicit generators with :func:`make_generator` where they draw.

    This replaces the reference's threefry ``fold_in`` chain, which torch
    cannot reproduce: the streams differ from the JAX package's, so no
    parity test depends on them (parity runs with shuffle and dropout off).

    Returns ``(round_seed, [client_seed, ...], agg_seed)``.
    """
    round_seed = derive_seed(base_seed, round_idx)
    seeds = [derive_seed(round_seed, int(c)) for c in client_ids]
    agg_seed = derive_seed(round_seed, AGG_KEY_SENTINEL)
    return round_seed, seeds, agg_seed


def sample_clients(
    round_idx: int,
    client_num_in_total: int,
    client_num_per_round: int,
    delete_client: Optional[int] = None,
) -> np.ndarray:
    """Sample the participating client indices for one round.

    Full participation (``per_round == total``) returns ``[0..total)`` in
    order with no RNG draw. Otherwise numpy is seeded with ``round_idx`` and
    ``min(per_round, total)`` clients are drawn without replacement.
    ``delete_client`` (leave-one-out) removes one client from the candidate
    pool before drawing. Populations above :data:`VIRTUAL_SAMPLE_THRESHOLD`
    take the O(k) path (:func:`sample_clients_virtual`).
    """
    if client_num_in_total == client_num_per_round and delete_client is None:
        return np.arange(client_num_in_total)
    if client_num_in_total > _virtual_sample_threshold():
        return _sample_clients_floyd(round_idx, client_num_in_total,
                                     client_num_per_round, delete_client)
    num_clients = min(client_num_per_round, client_num_in_total)
    candidates: Sequence[int] = range(client_num_in_total)
    if delete_client is not None:
        candidates = [c for c in range(client_num_in_total)
                      if c != delete_client]
        num_clients = min(num_clients, len(candidates))
    with _GLOBAL_RNG_LOCK:  # seed+draw must be atomic across threads
        np.random.seed(round_idx)
        return np.random.choice(candidates, num_clients, replace=False)


def sample_clients_virtual(
    round_idx: int,
    client_num_in_total: int,
    client_num_per_round: int,
    delete_client: Optional[int] = None,
    threshold: Optional[int] = None,
) -> np.ndarray:
    """Population-virtualized cohort sampling, the explicit entry point.

    At or under ``threshold`` this delegates to :func:`sample_clients`, so
    the cohort is identical to the resident path. Above it, a seeded
    partial Fisher-Yates draws ``k`` distinct ids from ``[0, N)`` in O(k)
    time and memory, under the same global-RNG lock.
    """
    if threshold is None:
        threshold = _virtual_sample_threshold()
    if client_num_in_total <= threshold:
        return sample_clients(round_idx, client_num_in_total,
                              client_num_per_round, delete_client)
    return _sample_clients_floyd(round_idx, client_num_in_total,
                                 client_num_per_round, delete_client)


def _sample_clients_floyd(round_idx: int, total: int, per_round: int,
                          delete_client: Optional[int]) -> np.ndarray:
    """k distinct draws from [0, N) via partial Fisher-Yates over a
    virtual ``arange(N)``: only the swapped positions live in a dict, so
    cost is O(k) regardless of N. ``delete_client`` shrinks the virtual
    pool by one and remaps ids past the hole."""
    pool = total if delete_client is None else total - 1
    k = min(per_round, pool)
    out = np.empty(k, dtype=np.int64)
    with _GLOBAL_RNG_LOCK:  # same seed+draw atomicity as the exact path
        np.random.seed(round_idx)
        swaps: dict = {}
        for i in range(k):
            j = int(np.random.randint(i, pool))
            out[i] = swaps.get(j, j)
            swaps[j] = swaps.get(i, i)
    if delete_client is not None:
        out[out >= delete_client] += 1
    return out


def eval_subsample(x, y, limit: Optional[int], seed: int):
    """Seeded eval-set subsample keyed only on (len, limit, seed), so every
    driver scores the identical subset. Returns (x, y) unchanged when
    ``limit`` is falsy or already covers the set."""
    if limit and len(x) > limit:
        sel = np.random.RandomState(seed).choice(len(x), limit,
                                                 replace=False)
        return x[sel], y[sel]
    return x, y
