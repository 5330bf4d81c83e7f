"""Sharded, disk-backed per-client state with a bounded host-RAM cache
(the port's copy of the persistent-field path of
``fedml_tpu/state/store.py``; its shard files are the same ``.npz``
format, so either package reads a store directory the other wrote).

Two tiers:

- **disk**: per-field shard files ``<dir>/<field>/shard_<i>.npz``, each
  holding ``shard_clients`` consecutive client ids' arrays under the keys
  ``c<id>``. Writes are atomic (tmp + ``os.replace``), so a round that
  dies mid-writeback leaves every shard either the old or the new
  complete version, never a torn file.
- **host RAM**: an LRU of loaded shards bounded by ``cache_clients``
  (rounded up to whole shards). Eviction writes dirty shards back first.

Fields are namespaces ("residual", ...). Thread-safe (one RLock).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Tuple

import numpy as np

#: default LRU budget, in clients
DEFAULT_CACHE_CLIENTS = 4096
#: default clients per shard file
DEFAULT_SHARD_CLIENTS = 256


class _Shard:
    """One resident shard: ``entries[cid] -> ndarray`` and its dirty bit."""

    __slots__ = ("entries", "dirty")

    def __init__(self, entries: Dict[int, np.ndarray]):
        self.entries = entries
        self.dirty = False


class ClientStateStore:
    """Per-client arrays in ``.npz`` shards under ``state_dir``, with an LRU
    of resident shards."""

    def __init__(self, state_dir: str,
                 shard_clients: int = DEFAULT_SHARD_CLIENTS,
                 cache_clients: int = DEFAULT_CACHE_CLIENTS):
        if shard_clients <= 0:
            raise ValueError(f"shard_clients must be >= 1 "
                             f"(got {shard_clients})")
        self.state_dir = state_dir
        # shard geometry is part of the on-disk format: a reader opening
        # with another shard_clients would look in the wrong shards, so
        # the directory describes itself and an existing store.json wins
        os.makedirs(state_dir, exist_ok=True)
        desc = os.path.join(state_dir, "store.json")
        if os.path.exists(desc):
            with open(desc) as f:
                shard_clients = int(json.load(f)["shard_clients"])
        else:
            tmp = f"{desc}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"shard_clients": int(shard_clients)}, f)
            os.replace(tmp, desc)
        self.shard_clients = int(shard_clients)
        self.cache_shards = max(
            1, -(-int(max(1, cache_clients)) // self.shard_clients))
        self._shards: "OrderedDict[Tuple[str, int], _Shard]" = OrderedDict()
        self._lock = threading.RLock()

    # -- shard I/O ---------------------------------------------------------
    def _shard_path(self, field: str, shard_idx: int) -> str:
        return os.path.join(self.state_dir, field,
                            f"shard_{shard_idx:08d}.npz")

    def _load_shard(self, field: str, shard_idx: int) -> _Shard:
        """Disk -> RAM: read one shard file (or start it empty)."""
        path = self._shard_path(field, shard_idx)
        if os.path.exists(path):
            with np.load(path) as z:
                return _Shard({int(k[1:]): np.asarray(z[k])
                               for k in z.files})
        return _Shard({})

    def _write_shard(self, field: str, shard_idx: int,
                     shard: _Shard) -> None:
        """RAM -> disk, atomically: a crash between the tmp write and the
        replace leaves the previous complete version in place."""
        path = self._shard_path(field, shard_idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not shard.entries:
            # a fully-deleted shard removes its file
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        else:
            tmp = f"{path}.{os.getpid()}.tmp.npz"  # savez keeps the .npz
            np.savez(tmp, **{f"c{cid}": arr
                             for cid, arr in shard.entries.items()})
            os.replace(tmp, path)
        shard.dirty = False

    def _resident(self, field: str, cid: int) -> _Shard:
        """The shard holding ``cid``, loaded and LRU-promoted; evicts past
        the budget, writing dirty shards back (caller holds the lock)."""
        key = (field, cid // self.shard_clients)
        shard = self._shards.get(key)
        if shard is not None:
            self._shards.move_to_end(key)
            return shard
        shard = self._shards[key] = self._load_shard(*key)
        while len(self._shards) > self.cache_shards:
            victim, old = self._shards.popitem(last=False)
            if old.dirty:
                self._write_shard(*victim, old)
        return shard

    # -- per-client API ----------------------------------------------------
    def get(self, field: str, cid: int) -> np.ndarray:
        """Client ``cid``'s array under ``field``; KeyError if absent."""
        with self._lock:
            try:
                return self._resident(field, int(cid)).entries[int(cid)]
            except KeyError:
                raise KeyError(f"state {field!r} has no client {cid}") \
                    from None

    def put(self, field: str, cid: int, arr: np.ndarray) -> None:
        with self._lock:
            shard = self._resident(field, int(cid))
            shard.entries[int(cid)] = np.asarray(arr)
            shard.dirty = True

    def delete(self, field: str, cid: int) -> bool:
        """Remove one entry; returns whether it existed. An emptied shard
        removes its file on write-back."""
        with self._lock:
            shard = self._resident(field, int(cid))
            if shard.entries.pop(int(cid), None) is None:
                return False
            shard.dirty = True
            return True

    def known_ids(self, field: str) -> Iterable[int]:
        """Every client id present for ``field``, resident or on disk."""
        with self._lock:
            seen = set()
            for (f, _), shard in self._shards.items():
                if f == field:
                    seen.update(shard.entries)
            fdir = os.path.join(self.state_dir, field)
            if os.path.isdir(fdir):
                for fn in sorted(os.listdir(fdir)):
                    # exact-name match: a crash's stray
                    # shard_*.npz.<pid>.tmp.npz is never read
                    m = re.fullmatch(r"shard_(\d+)\.npz", fn)
                    if not m or (field, int(m.group(1))) in self._shards:
                        continue  # a resident copy is authoritative
                    with np.load(os.path.join(fdir, fn)) as z:
                        seen.update(int(k[1:]) for k in z.files)
            return sorted(seen)

    def flush(self) -> int:
        """Write every dirty shard back (round close); returns how many.
        Each write is atomic on its own, so a crash mid-flush leaves some
        shards new and the rest old, all readable."""
        written = 0
        with self._lock:
            for (field, idx), shard in list(self._shards.items()):
                if shard.dirty:
                    self._write_shard(field, idx, shard)
                    written += 1
        return written


class StoreFlusher:
    """A writer thread over :meth:`ClientStateStore.flush`, off the round's
    critical path.

    ``request()`` marks a flush as wanted and returns. Requests coalesce
    to depth one: those made while a flush runs become one follow-up flush,
    which writes whatever is dirty then, so no data is lost. Every shard
    write stays atomic on its own. ``barrier()`` waits until everything
    requested so far is on disk; ``close()`` barriers, stops the thread
    and flushes once more inline for anything dirtied after the last
    request."""

    def __init__(self, store: ClientStateStore, name: str = "state-flusher"):
        self._store = store
        self._cond = threading.Condition()
        self._requested = False
        self._stopped = False
        self._seq_submitted = 0
        self._seq_done = 0
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def request(self) -> None:
        """Ask for a flush; returns at once. After ``close()`` the store is
        flushed inline."""
        with self._cond:
            if not self._stopped:
                self._requested = True
                self._seq_submitted += 1
                self._cond.notify_all()
                return
        self._store.flush()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._requested and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._requested:
                    return
                self._requested = False
                target = self._seq_submitted
            try:
                self._store.flush()
            except Exception:
                logging.exception("state flusher: flush failed")
            finally:
                with self._cond:
                    self._seq_done = max(self._seq_done, target)
                    self._cond.notify_all()

    def barrier(self, timeout: float = 60.0) -> bool:
        """Block until every flush requested before this call has run."""
        with self._cond:
            target = self._seq_submitted
            return self._cond.wait_for(
                lambda: self._seq_done >= target or self._stopped,
                timeout=timeout)

    def close(self, timeout: float = 60.0) -> None:
        self.barrier(timeout=timeout)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        self._store.flush()
