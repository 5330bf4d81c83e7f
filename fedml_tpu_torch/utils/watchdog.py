"""Failure detection for cross-silo federations (the port's counterpart of
``fedml_tpu/utils/watchdog.py``): per-silo liveness and the whole-round
stall watchdog.

- :class:`SiloLivenessTable`: per-silo detection. Every inbound message
  from a silo (replies, heartbeats, JOINs) beats its entry; the deadline
  server (``algorithms/fedavg_cross_silo.py``) takes its round barrier
  against the live set, evicts the silos that miss a deadline and
  re-admits them on JOIN. It also keeps each silo's report latency
  (broadcast to reply) in a :class:`SlidingQuantileTracker`.
- :class:`RoundWatchdog`: a round that makes no progress for
  ``timeout_s`` is surfaced (a warning, an ``anomaly`` flight record, or
  the caller's ``on_stall``) instead of hanging silently; with
  ``liveness=`` the stall log carries the per-silo breakdown.
- :class:`SlidingQuantileTracker`: a bounded window of observations with
  interpolated quantiles; the slow-round detector (``obs/anomaly.py``)
  reads its p90.

Usage::

    with RoundWatchdog(timeout_s=300, on_stall=handler) as dog:
        server = FedAvgServerManager(..., on_round_done=dog.wrap(on_done))
        server.run()
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Set


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


class SiloLivenessTable:
    """Thread-safe per-silo liveness: last-seen times and the live set.

    Workers are aggregator indices (rank - 1). All start live; a worker
    leaves the live set only through :meth:`evict` (a missed deadline or
    a failed send) and returns through :meth:`admit` (JOIN, or a live
    round's reply). ``evictions`` / ``rejoins`` count those moves."""

    def __init__(self, worker_ids: Iterable[int]):
        now = time.monotonic()
        self._lock = threading.Lock()
        self._last_seen: Dict[int, float] = {w: now for w in worker_ids}
        self._live: Set[int] = set(self._last_seen)
        self.evictions = 0
        self.rejoins = 0
        #: broadcast -> reply latencies, fleet-wide
        self.report_latencies = SlidingQuantileTracker()
        #: a short window a silo, for snapshots
        self._silo_latency: Dict[int, deque] = {}

    def beat(self, worker: int) -> None:
        """Record proof of life. An unknown worker is recorded but not
        admitted: admission is the server's call."""
        with self._lock:
            self._last_seen[worker] = time.monotonic()

    def live_workers(self) -> Set[int]:
        with self._lock:
            return set(self._live)

    def is_live(self, worker: int) -> bool:
        with self._lock:
            return worker in self._live

    def evict(self, worker: int) -> bool:
        """Remove from the live set; True if the worker was live (the
        eviction counted)."""
        with self._lock:
            if worker not in self._live:
                return False
            self._live.discard(worker)
            self.evictions += 1
            return True

    def admit(self, worker: int) -> bool:
        """(Re-)add to the live set; True if this was a rejoin (the worker
        was evicted or unknown)."""
        with self._lock:
            self._last_seen.setdefault(worker, time.monotonic())
            if worker in self._live:
                return False
            self._live.add(worker)
            self.rejoins += 1
            return True

    def observe_report_latency(self, worker: int, latency_s: float) -> None:
        """Record how long ``worker`` took from the round's broadcast to its
        reply: fleet-wide and a silo."""
        self.report_latencies.observe(latency_s)
        with self._lock:
            self._silo_latency.setdefault(
                worker, deque(maxlen=16)).append(float(latency_s))

    def snapshot(self) -> Dict[int, Dict[str, float]]:
        """Per-worker ``{live, silent_s[, report_p50_s]}`` for logs."""
        now = time.monotonic()
        with self._lock:
            out = {}
            for w, t in sorted(self._last_seen.items()):
                row = {"live": w in self._live,
                       "silent_s": round(now - t, 3)}
                lat = self._silo_latency.get(w)
                if lat:
                    row["report_p50_s"] = round(
                        interpolated_quantile(list(lat), 0.5), 4)
                out[w] = row
            return out


class RoundWatchdog:
    """Whole-round stall detection on a thread of its own: no completed
    round for ``timeout_s`` calls ``on_stall(last_round, stalled_s)``
    (default: a warning) every poll while the stall lasts. With ``obs``
    (an observability bundle) a stall also writes a ``stall`` anomaly to
    the flight log and arms the one-shot profiler."""

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[int, float], None]] = None,
                 poll_s: Optional[float] = None,
                 liveness: Optional[SiloLivenessTable] = None,
                 obs=None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or self._log_stall
        self.liveness = liveness
        self.obs = obs
        self._poll_s = poll_s if poll_s is not None else max(
            0.05, timeout_s / 4)
        self._last_beat = time.monotonic()
        self._last_round = -1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    @staticmethod
    def _log_stall(last_round: int, stalled_s: float) -> None:
        logging.warning(
            "federation stalled: no round completed for %.1fs "
            "(last finished round: %d)", stalled_s, last_round)

    def heartbeat(self, round_idx: int) -> None:
        """Record that ``round_idx`` completed."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._last_round = round_idx

    def wrap(self, on_round_done=None):
        """An ``on_round_done(round_idx, model)`` callback that heartbeats,
        then calls the wrapped one."""

        def cb(round_idx, model):
            self.heartbeat(round_idx)
            if on_round_done is not None:
                on_round_done(round_idx, model)

        return cb

    def start(self) -> "RoundWatchdog":
        with self._lock:
            self._last_beat = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="round-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "RoundWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                stalled = time.monotonic() - self._last_beat
                last_round = self._last_round
            if stalled <= self.timeout_s:
                continue
            self.stall_count += 1
            if self.obs is not None:
                try:
                    self.obs.note_anomaly("stall", last_round,
                                          {"stalled_s": round(stalled, 3)})
                except Exception:  # the watchdog must survive
                    logging.exception("watchdog anomaly record failed")
            if self.liveness is not None:
                logging.warning("per-silo liveness at stall: %s",
                                self.liveness.snapshot())
            try:
                self.on_stall(last_round, stalled)
            except Exception:  # the watchdog must survive
                logging.exception("watchdog on_stall callback failed")
