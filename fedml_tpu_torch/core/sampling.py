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

from fedml_tpu_torch.utils.flops import is_fake

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

#: sentinel fold index of the device-sampling stream (``FusedRounds`` with
#: ``device_sampling=True``): the cohort draw of a round hashes the round's
#: key with this id, which no client id occupies and which differs from
#: ``AGG_KEY_SENTINEL`` (the JAX package's value)
DEVICE_SAMPLE_SENTINEL = 2**31 - 2

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


def sample_clients_available(
    round_idx: int,
    client_num_in_total: int,
    client_num_per_round: int,
    is_available,
    threshold: Optional[int] = None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Availability-restricted cohort draw: ``sample_clients`` composed
    with a WAN availability trace (``fedml_tpu_torch/wan``). Cohorts come
    only from clients ``is_available`` marks online, and the draw is a
    pure function of ``(round_idx, is_available)``, where
    ``is_available(cids: int64[n]) -> bool[n]`` is a pure vectorized
    predicate. The draws are the JAX package's, bit for bit.

    Two regimes, split at :data:`VIRTUAL_SAMPLE_THRESHOLD`:

    - at or below it the available set is enumerated (O(N)) and the
      cohort drawn from it with the seeded global stream. With fewer
      available clients than the cohort, every one of them participates
      and the rest are seeded draws with replacement from them;
    - above it, seeded rejection sampling over uniform ids: expected
      O(k / availability) time and memory, no per-client array.

    A (nearly) dark population degrades the schedule instead of stalling
    it: what the draw cannot fill from available clients comes from the
    unrestricted stream, counted in ``stats["forced"]`` (the
    ``wan_forced_cohorts`` counter). ``stats["rejected"]`` counts the
    unavailable candidates skipped.
    """
    if threshold is None:
        threshold = _virtual_sample_threshold()
    total = int(client_num_in_total)
    k = min(int(client_num_per_round), total)
    if stats is None:
        stats = {}
    if total <= threshold:
        avail = np.zeros(0, dtype=np.int64)
        for lo in range(0, total, 1 << 17):
            ids = np.arange(lo, min(lo + (1 << 17), total), dtype=np.int64)
            on = ids[np.asarray(is_available(ids), dtype=bool)]
            avail = np.concatenate([avail, on])
        stats["rejected"] = stats.get("rejected", 0) + int(total
                                                          - len(avail))
        with locked_global_numpy_rng(round_idx) as rng:
            if len(avail) >= k:
                return rng.choice(avail, k, replace=False)
            if len(avail) == 0:
                # a dark population: the unrestricted draw
                stats["forced"] = stats.get("forced", 0) + k
                return rng.choice(total, k, replace=False)
            stats["forced"] = stats.get("forced", 0) + (k - len(avail))
            fill = rng.choice(avail, k - len(avail), replace=True)
            return np.concatenate([avail, fill])
    out: list = []
    seen: set = set()
    rejected = 0
    batch = max(4 * k, 64)
    budget = max(64 * k, 4096)  # candidate draws before giving up
    with locked_global_numpy_rng(round_idx) as rng:
        while len(out) < k and budget > 0:
            cand = rng.randint(0, total, size=min(batch, budget))
            budget -= len(cand)
            ok = np.asarray(is_available(cand), dtype=bool)
            for c, on in zip(cand.tolist(), ok.tolist()):
                if not on:
                    rejected += 1
                    continue
                if c in seen:
                    continue
                seen.add(c)
                out.append(c)
                if len(out) == k:
                    break
        forced = k - len(out)
        while len(out) < k:
            # the budget is spent (a nearly dark population): fill from
            # the unrestricted stream
            c = int(rng.randint(0, total))
            if c in seen:
                continue
            seen.add(c)
            out.append(c)
    stats["rejected"] = stats.get("rejected", 0) + rejected
    if forced:
        stats["forced"] = stats.get("forced", 0) + forced
    return np.asarray(out, dtype=np.int64)


# -- counter hashes: the same bits on the CPU, on the card and in a CUDA graph

_M32 = 0xFFFFFFFF
#: the 32-bit golden-ratio increment of a counter (a Weyl sequence)
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """``x * c mod 2**32`` for 32-bit values held in int64: a constant of
    2**31 or more is taken as ``c - 2**32`` (the same residue), so the
    product stays inside int64 and nothing overflows."""
    return (x * (c - (1 << 32) if c >= 1 << 31 else c)) & _M32


def mix32(x):
    """A bijection of 32-bit values (``lowbias32`` from C. Wellons' hash
    prospector) in plain integer ops. ``x``: an int64 tensor or a Python
    int in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold32(key, data):
    """A 32-bit key for ``data`` under ``key`` (tensors broadcast, or
    Python ints): the counter-hash analogue of ``fold_in``."""
    return mix32(key ^ mix32((_mul32(data, _GOLDEN) + 1) & _M32))


#: ``_mul32(arange(n), _GOLDEN)`` by ``(n, device)``: a dropout site draws
#: the same counters at every step. An entry is never evicted (a captured
#: CUDA graph may read it); past ``_WEYL_MAX`` sizes, while a CUDA graph
#: captures, or under the FLOP counter (a fake tensor holds no values),
#: the counters are computed at the call instead.
_WEYL: dict = {}
_WEYL_MAX = 32


def _weyl(n: int, device) -> torch.Tensor:
    device = torch.device(device)
    got = _WEYL.get((n, device))
    if got is None:
        got = _mul32(torch.arange(n, dtype=torch.int64, device=device),
                     _GOLDEN)
        if len(_WEYL) < _WEYL_MAX and not is_fake(got) and not (
                device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _WEYL[(n, device)] = got
    return got


def counter_bits(key, n: int, device) -> torch.Tensor:
    """32-bit hash values (int64 ``[..., n]``) of the counters ``0..n-1``
    under ``key`` (a Python int, or a 0-dim or batched int64 tensor,
    broadcast over a new last axis): ``mix32`` of ``(i * golden + key) mod
    2**32``, in place on one fresh tensor."""
    if n >= 1 << 32:
        raise ValueError(f"{n} counters: a stream holds 2**32")
    if torch.is_tensor(key):
        key = key.to(device=device, dtype=torch.int64)[..., None]
    x = _weyl(n, device) + key
    x &= _M32
    for shift, mul in ((16, 0x7FEB352D), (15, 0x846CA68B)):
        x ^= x >> shift
        x *= mul - (1 << 32) if mul >= 1 << 31 else mul
        x &= _M32
    x ^= x >> 16
    return x


def device_round_key(base_seed: int, round_idx: torch.Tensor):
    """The device-sampling stream's 32-bit key of a round: a hash of the
    base seed and the round index (a 0-dim int64 tensor), so a replayed
    graph derives each round's key on the device."""
    base = derive_seed(base_seed, DEVICE_SAMPLE_SENTINEL) & _M32
    return fold32(base, round_idx & _M32)


def device_sample_clients(round_key: torch.Tensor, client_num: int,
                          per_round: int) -> torch.Tensor:
    """``per_round`` of ``client_num`` client ids without replacement, drawn
    on the device: the first ``per_round`` of the ids ordered by a hash of
    ``(round_key, id)`` (a stable sort, so equal hashes order by id). The
    device-sampling mode's own stream, not the host loop's
    ``sample_clients`` (as the JAX package's ``jax.random.choice``)."""
    bits = counter_bits(round_key, client_num, round_key.device)
    return torch.sort(bits, stable=True).indices[:per_round]


def eval_subsample(x, y, limit: Optional[int], seed: int):
    """Seeded eval-set subsample keyed only on (len, limit, seed), so every
    driver scores the identical subset. Returns (x, y) unchanged when
    ``limit`` is falsy or already covers the set."""
    if limit and len(x) > limit:
        sel = np.random.RandomState(seed).choice(len(x), limit,
                                                 replace=False)
        return x[sel], y[sel]
    return x, y
