"""Anomaly detection + one-shot anomaly-triggered profiling (the port's
counterpart of ``fedml_tpu/obs/anomaly.py``).

An always-on profiler is too expensive to leave running across a
multi-thousand-round schedule, but by the time a human notices a slow
round the evidence is gone. The flight recorder's anomaly SIGNALS (a
round slower than ``factor`` x the observed p90, later a watchdog stall
or a below-quorum deadline extension) write an ``anomaly`` record to the
flight log AND arm a ONE-SHOT ``torch.profiler`` window for the NEXT
round, so slow rounds self-document with a Chrome trace
(``<trace_dir>/round_<r>/trace.json``; on a card it records CUDA activity
and names the kernels the round launched).

Determinism note: the slow-round comparison consumes *measured
durations handed to it*: the detector never reads a clock and never
feeds schedule control flow; arming a profiler changes what is RECORDED,
not what the federation does.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

from fedml_tpu_torch.utils.tracing import TorchTrace
from fedml_tpu_torch.utils.watchdog import SlidingQuantileTracker


class RoundAnomalyDetector:
    """Flags rounds slower than ``factor`` x the rolling p90.

    Feeds on durations the caller measured (``RoundTimer.end_round``'s
    return value); needs ``min_rounds`` observations before it ever
    flags, so cold-start compile rounds don't trip it."""

    def __init__(self, factor: float = 3.0, quantile: float = 0.9,
                 min_rounds: int = 8, window: int = 128):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.factor = float(factor)
        self.q = float(quantile)
        self.min_rounds = max(1, int(min_rounds))
        self._durations = SlidingQuantileTracker(window=window)

    def observe(self, duration_s: float) -> Optional[float]:
        """Record one round's duration; returns the violated threshold
        (``factor * p90``) when this round was anomalously slow, else
        None. The round's own duration enters the window AFTER the
        check, so one outlier cannot hide the next."""
        threshold = None
        if self._durations.count() >= self.min_rounds:
            p = self._durations.quantile(self.q)
            if p is not None and p > 0 and duration_s > self.factor * p:
                threshold = self.factor * p
        self._durations.observe(float(duration_s))
        return threshold


class AnomalyProfiler:
    """One-shot ``torch.profiler`` windows armed by anomaly signals.

    ``arm(reason)`` latches; the NEXT ``maybe_start(round)`` opens a trace
    into ``<trace_dir>/round_<r>`` and ``maybe_stop(round)`` closes it and
    writes ``trace.json`` there: one profiled round per arm, re-armable
    after it fires. A ``cooldown_rounds`` floor keeps a persistently
    degraded fleet from tracing every round. ``start_fn``/``stop_fn``
    exist for tests (and for embedding a different profiler); the
    defaults run :class:`~fedml_tpu_torch.utils.tracing.TorchTrace` (CUDA
    activity when a card is present, CPU activity always).
    """

    def __init__(self, trace_dir: Optional[str], *,
                 cooldown_rounds: int = 16,
                 start_fn: Optional[Callable[[str], None]] = None,
                 stop_fn: Optional[Callable[[], None]] = None):
        self.trace_dir = trace_dir
        self.cooldown_rounds = max(0, int(cooldown_rounds))
        self._start_fn = start_fn
        self._stop_fn = stop_fn
        self._trace: Optional[TorchTrace] = None
        self._armed_reason: Optional[str] = None
        self._active_round: Optional[int] = None
        self._last_traced_round: Optional[int] = None
        self.profiled_rounds = 0
        #: the Chrome trace files the windows wrote, oldest first
        self.trace_files: list = []
    @property
    def enabled(self) -> bool:
        return self.trace_dir is not None

    def arm(self, reason: str) -> bool:
        """Latch a one-shot window for the next round; True when this
        call armed it (False: disabled, already armed, or mid-trace)."""
        if not self.enabled or self._armed_reason is not None \
                or self._active_round is not None:
            return False
        self._armed_reason = str(reason)
        return True

    def maybe_start(self, round_idx: int) -> bool:
        """Open the armed trace window at a round boundary (call before
        the round's work). True when a trace started."""
        if self._armed_reason is None or self._active_round is not None:
            return False
        if self._last_traced_round is not None and (
                round_idx - self._last_traced_round <= self.cooldown_rounds):
            # cooling down: drop the arm (the anomaly record already
            # landed in the flight log; only the trace is skipped)
            self._armed_reason = None
            return False
        out_dir = os.path.join(self.trace_dir, f"round_{round_idx:06d}")
        try:
            if self._start_fn is not None:
                self._start_fn(out_dir)
            else:
                self._trace = TorchTrace(out_dir)
                self._trace.start()
        except Exception:  # noqa: BLE001 — profiling must never kill a round
            logging.warning("anomaly profiler failed to start a trace at "
                            "round %d", round_idx, exc_info=True)
            self._armed_reason = None
            return False
        logging.info("anomaly profiler: tracing round %d into %s "
                     "(armed by %r)", round_idx, out_dir,
                     self._armed_reason)
        self._active_round = round_idx
        self._armed_reason = None
        return True

    def maybe_stop(self, round_idx: int) -> bool:
        """Close the trace opened for ``round_idx`` (call at the round's
        close). True when a trace was stopped."""
        if self._active_round is None or self._active_round != round_idx:
            return False
        try:
            if self._stop_fn is not None:
                self._stop_fn()
            elif self._trace is not None:
                self.trace_files.append(self._trace.stop())
        except Exception:  # noqa: BLE001 — see maybe_start
            logging.warning("anomaly profiler failed to stop the round-%d "
                            "trace", round_idx, exc_info=True)
        self._trace = None
        self._active_round = None
        self._last_traced_round = round_idx
        self.profiled_rounds += 1
        return True

    def close(self) -> None:
        """Stop a window left open by an aborted schedule."""
        if self._active_round is not None:
            self.maybe_stop(self._active_round)
