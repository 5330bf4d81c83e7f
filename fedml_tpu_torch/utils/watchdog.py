"""Failure detection for cross-silo federations (the port's counterpart of
``fedml_tpu/utils/watchdog.py``), so far its one piece that observability
needs: :class:`SlidingQuantileTracker`, a bounded window of observations
with interpolated quantiles. The slow-round detector
(``obs/anomaly.py``) reads its p90. The per-silo liveness table and the
whole-round stall watchdog come with the deadline/quorum rounds (ROADMAP
Slice D item 22c).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional


def interpolated_quantile(values: List[float], q: float) -> float:
    """Linear-interpolation quantile (numpy's default method), dependency
    free (the JAX package keeps it in ``control/pace.py``)."""
    if not values:
        raise ValueError("quantile of an empty window")
    s = sorted(values)
    if len(s) == 1:
        return float(s[0])
    idx = q * (len(s) - 1)
    lo = int(idx)
    frac = idx - lo
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


class SlidingQuantileTracker:
    """A fixed-width window of float observations with interpolated
    quantiles. Thread-safe: observations may land on a receive thread
    while another thread reads quantiles."""

    def __init__(self, window: int = 128):
        if window <= 0:
            raise ValueError(f"window must be >= 1, got {window}")
        self._buf: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._buf.append(float(value))

    def count(self) -> int:
        with self._lock:
            return len(self._buf)

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated q-quantile of the window, None when empty."""
        with self._lock:
            if not self._buf:
                return None
            return interpolated_quantile(list(self._buf), q)
