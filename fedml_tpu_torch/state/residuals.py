"""Per-silo error-feedback residual history on the client-state store
(the port's copy of ``fedml_tpu/state/residuals.py``).

Each silo keeps its EF residual under ``checkpoint_dir/silo_<rank>/`` in a
:class:`~fedml_tpu_torch.state.store.ClientStateStore` (field
``"residual"``, keyed by the round index), so a resumed silo restores the
residual that entered its resumed round. The store's shard files are the
JAX package's ``.npz`` format: a directory either package wrote is read by
the other, array for array.

The JAX package also reads an older layout, one flax-msgpack blob and a
json sidecar per round (``round_<r>`` files written by its
``CheckpointManager``); decoding it needs flax. The port raises an error
naming that layout when a silo directory holds one and the store has no
entry for the round, instead of starting error feedback from zero over
state it cannot read.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Optional

import numpy as np

from fedml_tpu_torch.state.store import ClientStateStore, StoreFlusher

#: rounds of residual history kept (older rounds are collected at save)
KEEP_LAST_N = 3

#: residual history is tiny (one entry per retained round): one shard file
#: a few rounds keeps write-back O(entry), not O(history)
_SHARD_ROUNDS = 4


class LegacyResidualLayout(RuntimeError):
    """A silo directory holds the flax-msgpack residual layout, which the
    port does not read."""


class SiloResidualStore:
    def __init__(self, state_dir: str, keep_last_n: int = KEEP_LAST_N,
                 async_writeback: bool = False):
        self.state_dir = state_dir
        self.keep_last_n = int(keep_last_n)
        self._store = ClientStateStore(state_dir,
                                       shard_clients=_SHARD_ROUNDS,
                                       cache_clients=_SHARD_ROUNDS
                                       * (self.keep_last_n + 1))
        #: async write-back: a writer thread flushes off the save()
        #: caller's critical path, depth-1 coalesced; shard writes stay
        #: individually atomic, and ``close()`` is the durable barrier
        self._flusher = (StoreFlusher(self._store,
                                      name="silo-state-flusher")
                         if async_writeback else None)

    def save(self, round_idx: int, residual: np.ndarray) -> None:
        """Persist the residual entering ``round_idx`` (the server's model
        checkpoint is keyed by rounds completed, so restore at the resumed
        round lines both up), collecting history beyond ``keep_last_n``."""
        self._store.put("residual", round_idx,
                        np.asarray(residual, dtype=np.float32))
        for old in self._store.known_ids("residual"):
            if old <= round_idx - self.keep_last_n:
                self._store.delete("residual", old)
        if self._flusher is not None:
            self._flusher.request()
        else:
            self._store.flush()
        self._gc_legacy(round_idx)

    def flush(self, timeout: float = 60.0) -> None:
        """Durability barrier: every ``save`` so far is on disk after
        this returns."""
        if self._flusher is not None:
            self._flusher.barrier(timeout=timeout)
        self._store.flush()

    def close(self, timeout: float = 60.0) -> None:
        """Flush and stop (silo FINISH). Safe to call twice; after close
        further ``save`` calls flush inline."""
        if self._flusher is not None:
            self._flusher.close(timeout=timeout)
        else:
            self._store.flush()

    def load(self, round_idx: int, dim: int) -> Optional[np.ndarray]:
        """The residual saved for ``round_idx``, or None when there is
        none (the caller starts error feedback from zero, which re-loses
        pending mass but never corrupts). Raises
        :class:`LegacyResidualLayout` when only the flax-msgpack layout
        holds the round."""
        try:
            arr = self._store.get("residual", round_idx)
        except KeyError:
            path = self._legacy_path(round_idx)
            if os.path.exists(path) and os.path.exists(path + ".json"):
                raise LegacyResidualLayout(
                    f"{path} is a residual in the flax-msgpack layout (one "
                    "round_<r> blob and json sidecar a round), which the "
                    "port does not read; resume it with the JAX package or "
                    "start this silo's error feedback afresh") from None
            return None
        if arr.shape != (dim,):
            logging.warning(
                "residual checkpoint for round %d has shape %s, expected "
                "(%d,): the model changed since the checkpoint; starting "
                "error feedback from zero", round_idx, arr.shape, dim)
            return None
        return np.asarray(arr, dtype=np.float32)

    def _legacy_path(self, round_idx: int) -> str:
        return os.path.join(self.state_dir, f"round_{round_idx:08d}")

    def _gc_legacy(self, round_idx: int) -> None:
        """A silo that started on the legacy layout keeps writing rounds
        forward in the store; its stale legacy files go with the same
        retention window."""
        try:
            names = sorted(os.listdir(self.state_dir))
        except FileNotFoundError:
            return
        for fn in names:
            if not fn.startswith("round_"):
                continue
            try:
                r = int(fn.split(".")[0].split("_")[1])
            except (IndexError, ValueError):
                continue
            if r <= round_idx - self.keep_last_n:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(os.path.join(self.state_dir, fn))

    def latest_round(self) -> Optional[int]:
        """The newest round the store holds a residual for."""
        rounds = self._store.known_ids("residual")
        return max(rounds) if rounds else None
