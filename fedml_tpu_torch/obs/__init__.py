"""fedml_tpu_torch.obs: the federation flight recorder (the port's
counterpart of ``fedml_tpu/obs``).

1. **Per-round telemetry timeline**: ``RoundTimer.begin_round`` /
   ``end_round`` snapshot-delta semantics (``utils/tracing.py``) give
   every phase/counter/gauge a per-round series, flushed through a
   :class:`FlightRecorder` into an append-only, crash-tolerant
   ``flight_rank<r>.jsonl`` (the JAX package's format, byte for byte).
2. **Cross-process span correlation**: every record carries
   ``(job_id, round, rank, epoch)``; silos piggyback a compact counter
   digest on replies so the server's log holds per-silo rows;
   :func:`merge_flight_logs` reconstructs one global timeline from N logs,
   cross-checkable against a control-plane ledger.
3. **Anomaly-triggered profiling**: a slow round writes an ``anomaly``
   record and arms a one-shot ``torch.profiler`` window for the next
   round (:class:`AnomalyProfiler`).
4. **Roofline/MFU accounting**: every closed round also derives a
   ``perf`` record (:mod:`fedml_tpu_torch.obs.perf`): MFU against the
   card's BF16 peak, comm/compute overlap, wire bytes/s, and the card's
   allocator watermarks.

Observability is a PURE OBSERVER: with it on, trajectories are bit-exact
vs off; it draws no RNG, touches no model state, and every write path
degrades to a logged warning, never an exception.
"""

from __future__ import annotations

import itertools
import logging
from typing import Any, Dict, Optional

from fedml_tpu_torch.obs.anomaly import AnomalyProfiler, RoundAnomalyDetector
from fedml_tpu_torch.obs.flight import (FLIGHT_FORMAT, FlightRecorder,
                                  flight_log_paths, read_flight_log)
from fedml_tpu_torch.obs.merge import check_against_ledger, merge_flight_logs
from fedml_tpu_torch.obs.perf import (PerfAccountant, derive_perf_record,
                                device_peak_flops)
from fedml_tpu_torch.obs.registry import METRICS, metric_names

__all__ = [
    "AnomalyProfiler", "FlightRecorder", "Observability",
    "PerfAccountant", "RoundAnomalyDetector", "FLIGHT_FORMAT", "METRICS",
    "build_observability", "check_against_ledger", "default_job_id",
    "derive_perf_record", "device_peak_flops", "endpoint_epoch",
    "flight_log_paths", "merge_flight_logs", "metric_names",
    "read_flight_log",
]


#: per-process nonce feeding default_job_id (two launches in ONE
#: process — e.g. back-to-back runs in a test session — must also
#: derive distinct ids)
_JOB_ID_COUNTER = itertools.count()


def default_job_id(prefix: str = "job", stable_key=None) -> str:
    """A collision-safe default job id for launches that set none.

    Flight records from different runs sharing one obs dir align on
    ``(job_id, round)`` — a LITERAL default ("fed") makes two
    unconfigured runs interleave into one phantom job. The derived id
    is ``<prefix>-<8 hex>``: of ``stable_key`` when given (the run's
    durable namespace, e.g. its checkpoint dir — a RESTARTED resume leg
    must rejoin its previous incarnation's flight timeline, not fork a
    phantom second job), else of this run's identity (pid + a
    wall/counter nonce): stable for the launch that computed it (the
    launcher stamps every rank with the SAME id), unique across runs.
    Explicitly configured ids always win — this is only the unset
    fallback.
    """
    import hashlib
    import os
    import time
    if stable_key:
        token = hashlib.sha1(
            os.path.abspath(str(stable_key)).encode()).hexdigest()[:8]
    else:
        nonce = next(_JOB_ID_COUNTER)
        token = hashlib.sha1(
            f"{os.getpid()}:{time.time_ns()}:{nonce}".encode()
        ).hexdigest()[:8]
    return f"{prefix}-{token}"


def endpoint_epoch(com) -> Optional[int]:
    """The reliable transport's per-incarnation stream epoch for a comm
    endpoint — the identity flight records reuse. Unwraps the fault
    injector (``comm.faults.FaultyCommManager`` holds the real backend at
    ``.inner``)."""
    inner = getattr(com, "inner", com)
    epoch = getattr(inner, "_seq_epoch", None)
    return int(epoch) if epoch is not None else None


class Observability:
    """One process's observability bundle: the flight recorder plus (on
    the server) the slow-round detector and the one-shot profiler. The
    ``timer`` binding mirrors anomaly/profile events into the
    ``obs_*`` counters so they land on the same evidence rows as
    everything else."""

    def __init__(self, recorder: FlightRecorder,
                 detector: Optional[RoundAnomalyDetector] = None,
                 profiler: Optional[AnomalyProfiler] = None,
                 perf: Optional[PerfAccountant] = None):
        self.recorder = recorder
        self.detector = detector
        self.profiler = profiler
        self.perf = perf
        self._timer = None

    def probe_round_flops(self, thunk, source: str = "analytic_flops"
                          ) -> None:
        """Hand the perf accountant the count of the round about to close
        (the driver builds the thunk over its real round program + inputs,
        every round: a round's work depends on its cohort; a no-op when
        perf accounting is off or a probe has failed)."""
        if self.perf is not None:
            self.perf.probe_round_flops(thunk, source)

    def bind_timer(self, timer) -> None:
        self._timer = timer
        if timer is not None:
            timer.bind_flight(self.recorder)

    def note_anomaly(self, reason: str, round_idx: int,
                     detail: Optional[Dict[str, Any]] = None) -> None:
        """Record an anomaly in the flight log and arm the one-shot
        profiler window for the next round."""
        rec = {"kind": "anomaly", "round": int(round_idx),
               "reason": str(reason)}
        if detail:
            rec["detail"] = detail
        self.recorder.append(rec)
        if self._timer is not None:
            self._timer.count("obs_anomalies")
        if self.profiler is not None and self.profiler.arm(reason):
            logging.info("observability: %s at round %d armed a one-shot "
                         "profile window", reason, round_idx)

    def round_begin(self, round_idx: int) -> None:
        """Open the armed profiler window (if any) at a round start."""
        if self.profiler is not None:
            self.profiler.maybe_start(round_idx)

    def round_end(self, round_idx: int,
                  duration_s: Optional[float],
                  record: Optional[Dict[str, Any]] = None) -> None:
        """Close an open profile window, derive and flush the round's
        ``perf`` record from the closed round record (when perf
        accounting is on and the driver passed one), and feed the
        slow-round detector with the measured duration."""
        if self.profiler is not None:
            if self.profiler.maybe_stop(round_idx) \
                    and self._timer is not None:
                self._timer.count("obs_profiled_rounds")
        if self.perf is not None and record is not None:
            perf_rec = self.perf.derive(record)
            if perf_rec is not None:
                self.recorder.append(perf_rec)
                if self._timer is not None \
                        and "device_mem_peak_mb" in perf_rec:
                    # the device watermark is a real gauge: keep its
                    # high-water on the same evidence rows as host RSS
                    self._timer.gauge("device_mem_peak_mb",
                                      perf_rec["device_mem_peak_mb"])
        if self.detector is not None and duration_s is not None:
            threshold = self.detector.observe(duration_s)
            if threshold is not None:
                self.note_anomaly("slow_round", round_idx,
                                  {"duration_s": round(duration_s, 6),
                                   "threshold_s": round(threshold, 6)})

    def close(self) -> None:
        if self.profiler is not None:
            self.profiler.close()
        self.recorder.close()


def build_observability(obs_dir: Optional[str], *,
                        job_id: str = "job", rank: int = 0,
                        role: str = "server",
                        epoch: Optional[int] = None,
                        perf_device=None) -> Optional[Observability]:
    """The single constructor every launcher shares. ``obs_dir`` None
    (the default everywhere) returns None: observability fully off.
    Servers (``role="server"``) get the detector + profiler (profiles
    under ``<obs_dir>/profiles``) plus the roofline/MFU accountant
    (``obs/perf.py``; ``perf_device`` pins which card's name rates the
    peak); silos only record."""
    if not obs_dir:
        return None
    recorder = FlightRecorder(obs_dir, job_id=job_id, rank=rank,
                              epoch=epoch)
    if role != "server":
        return Observability(recorder)
    import os
    return Observability(
        recorder, detector=RoundAnomalyDetector(),
        profiler=AnomalyProfiler(os.path.join(obs_dir, "profiles")),
        perf=PerfAccountant(device=perf_device))
