"""Per-round wall-clock accounting (the counterpart of
``fedml_tpu/utils/tracing.py::RoundTimer``).

``RoundTimer`` keeps named phase timings with running aggregates on the
host clock. PyTorch enqueues device work and returns, so a phase that must
charge device time synchronises inside it (``FedAvgAPI.train``'s
``device_wait``). Thread-safe: the cohort prefetcher charges ``pack`` and
``upload`` from its worker thread while the main thread times ``dispatch``,
so overlapped phases record where time went, not critical-path wall time.

Drivers call ``begin_round(r)`` / ``end_round(r)`` around each round;
``end_round`` turns the phase and counter deltas since ``begin_round`` into
one per-round record kept in a bounded ring buffer and, once
``bind_flight`` bound one, flushed to a flight recorder
(``fedml_tpu_torch/obs/flight.py``). Begin/end never touch RNG, schedules
or device state: timelines are a pure observer. The record ``end_round``
returns is also the roofline accountant's input (``obs/perf.py``).

``profile(log_dir)`` wraps a :class:`TorchTrace`: a ``torch.profiler``
window that records CUDA activity on a card (CPU activity alone on the
CPU) and writes a Chrome trace into ``log_dir``; None is a no-op.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional


class RoundTimer:
    def __init__(self, ring_capacity: int = 512) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        #: high-water marks (``gauge`` keeps the max, not a sum)
        self.gauges: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._rounds: deque = deque(maxlen=max(1, int(ring_capacity)))
        #: (round_idx, t0, phase-totals, phase-counts, counters) snapshots
        #: of the open round
        self._open_round = None
        self._flight = None

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Charge ``seconds`` to a phase directly (pre-measured time, e.g.
        the prefetcher's ``prefetch_wait``)."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Bump an event counter (e.g. ``prefetch_hit``/``prefetch_miss``)."""
        with self._lock:
            self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        """Record a high-water mark: the gauge keeps ``max(old, value)``."""
        with self._lock:
            self.gauges[name] = max(self.gauges.get(name, value), value)

    @staticmethod
    def host_rss_mb() -> float:
        """This process's peak resident set size in MB (linux ru_maxrss is
        KB)."""
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

    def update_rss(self) -> float:
        """Sample peak host RSS into the ``host_rss_peak_mb`` gauge."""
        mb = self.host_rss_mb()
        self.gauge("host_rss_peak_mb", mb)
        return mb

    @property
    def comm_bytes_up(self) -> int:
        """Client->server wire bytes (encoded frame lengths, credited by
        the cross-silo server from its transport endpoint)."""
        with self._lock:
            return self.counters["comm_bytes_up"]

    @property
    def comm_bytes_down(self) -> int:
        """Server->client wire bytes (encoded frame lengths)."""
        with self._lock:
            return self.counters["comm_bytes_down"]

    def bind_flight(self, recorder) -> None:
        """Flush every future ``end_round`` record through ``recorder`` (a
        :class:`~fedml_tpu_torch.obs.flight.FlightRecorder`); None
        unbinds."""
        with self._lock:
            self._flight = recorder

    def begin_round(self, round_idx: int) -> None:
        """Open round ``round_idx``: snapshot every phase/counter so
        ``end_round`` can attribute the deltas to this round. An
        already-open round is superseded."""
        with self._lock:
            self._open_round = (int(round_idx), time.perf_counter(),
                                dict(self.totals), dict(self.counts),
                                dict(self.counters))

    def end_round(self, round_idx: int,
                  extra: Optional[Dict] = None) -> Optional[Dict]:
        """Close round ``round_idx``: the phase/counter deltas since
        ``begin_round`` (and current gauge high-waters) become one
        per-round record, appended to the ring buffer and returned. Returns
        None (and resets) on a round mismatch or when no round is open.
        ``extra`` keys are merged into the record."""
        with self._lock:
            if self._open_round is None or self._open_round[0] != int(
                    round_idx):
                self._open_round = None
                return None
            _, t0, tot0, cnt0, ctr0 = self._open_round
            self._open_round = None
            duration = time.perf_counter() - t0
            phases = {}
            for k in sorted(self.totals):
                ds = self.totals[k] - tot0.get(k, 0.0)
                dn = self.counts[k] - cnt0.get(k, 0)
                if dn or ds:
                    phases[k] = {"s": round(ds, 6), "n": dn}
            counters = {}
            for k in sorted(self.counters):
                d = self.counters[k] - ctr0.get(k, 0)
                if d:
                    counters[k] = d
            rec = {"kind": "round", "round": int(round_idx),
                   "duration_s": round(duration, 6), "phases": phases,
                   "counters": counters,
                   "gauges": {k: self.gauges[k]
                              for k in sorted(self.gauges)}}
            if extra:
                rec.update(extra)
            self._rounds.append(rec)
            flight = self._flight
        if flight is not None:
            flight.append(rec)  # file I/O outside the timer lock
        return rec

    def round_records(self) -> List[Dict]:
        """The ring buffer's per-round records, oldest first."""
        with self._lock:
            return list(self._rounds)

    def means(self) -> Dict[str, float]:
        with self._lock:
            return {k: self.totals[k] / max(1, self.counts[k])
                    for k in self.totals}

    def report(self) -> str:
        out = " | ".join(f"{k}: {v * 1e3:.1f}ms"
                         for k, v in sorted(self.means().items()))
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
        if counters:
            out += " | " + " | ".join(
                f"{k}: {v}" for k, v in sorted(counters.items()))
        if gauges:
            out += " | " + " | ".join(
                f"{k}: {v:.1f}" for k, v in sorted(gauges.items()))
        return out


class TorchTrace:
    """One ``torch.profiler`` window: ``start()`` opens it, ``stop()``
    closes it and writes a Chrome trace to ``<log_dir>/trace.json``
    (returned). On a CUDA card it records CUDA activity too, so the trace
    names every kernel the window launched; on the CPU it records CPU
    activity alone. ``profiler`` stays readable after ``stop()``
    (``key_averages()``)."""

    def __init__(self, log_dir: str):
        self.log_dir = str(log_dir)
        self.profiler = None
        self.path: Optional[str] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile as _profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = _profile(activities=activities)
        prof.__enter__()
        self.profiler = prof

    def stop(self) -> str:
        import torch
        if torch.cuda.is_available():
            # the window's queued kernels land inside it
            torch.cuda.synchronize()
        self.profiler.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, "trace.json")
        self.profiler.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None) -> Iterator[Optional[TorchTrace]]:
    """``with profile('/tmp/trace') as trace:`` records a
    :class:`TorchTrace` window into that directory; with None it is a
    no-op that yields None (so call sites need no conditionals)."""
    if log_dir is None:
        yield None
        return
    trace = TorchTrace(log_dir)
    trace.start()
    try:
        yield trace
    finally:
        trace.stop()
