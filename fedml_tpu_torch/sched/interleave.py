"""Fair shares of the card across tenant jobs: deficit round-robin (the
port's copy of ``fedml_tpu/sched/interleave.py``).

Every in-process silo actor dispatches to one device through one mutex
(``fedavg_cross_silo._DEVICE_LOCK``). With N tenant jobs that mutex is
first come, first served: a heavy job's silos can hold the card while a
light job starves. :class:`RoundInterleaver` replaces arrival order with a
share-weighted deficit round-robin:

- each job is registered with a ``share``, its entitlement weight;
- when several jobs wait for the device, the grant goes to the waiting job
  with the lowest share-normalized time used (``used_s / share``, the
  deficit, in seconds of held device rather than bytes);
- a job with nothing to dispatch (waiting for silo replies, between
  rounds) is not among the waiters and is skipped: it yields its slot
  instead of idling the card, and its deficit puts it first when it
  returns.

The interleaver orders when device sections run, never what they compute:
each job's run stays bit for bit its solo run (the chaos harness's
oracle).

:class:`JobDeviceGate` is the per-job context manager the cross-silo actors
hold in place of the raw device lock (``device_gate=`` on
``run_fedavg_cross_silo``): the outermost entry takes a DRR slot, then the
real device lock (so ungated code still serializes against gated code);
its exit charges the held wall time to the job and feeds the job's timer
(``sched_device_time``, ``sched_gate_wait``, ``sched_device_acquires``).

On the card a gated section's CUDA launches are asynchronous, so the time
charged is the time the host held the gate: it equals device time only
where the section ends in a host copy (a ``.cpu()``, an ``.item()``), as
the silo's reply encode and the server's decode do. No synchronize is
added for the accounting.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

#: a share at or below zero would make a job's normalized usage infinite
_MIN_SHARE = 1e-6

#: each job's first holds carry its one-off set-up on the card (the CUDA
#: context's first use by its threads, cuDNN's plan selection for its
#: shapes, the allocator's first blocks: model init, the first local
#: training and the first eval), charged to whichever tenant reached the
#: card first: a start-up artifact, not a property of the scheduling. The
#: steady-state fairness estimator leaves this prologue out.
PROLOGUE_HOLDS = 12


class RoundInterleaver:
    """Share-weighted deficit round-robin over one device."""

    def __init__(self, shares: Optional[Dict[str, float]] = None,
                 prologue_holds: int = PROLOGUE_HOLDS):
        self._cond = threading.Condition()
        self._shares: Dict[str, float] = {}
        self._used_s: Dict[str, float] = {}
        self._waiting: Dict[str, int] = {}
        self._hold_count: Dict[str, int] = {}
        self._prologue_s: Dict[str, float] = {}
        self._prologue_holds = max(0, int(prologue_holds))
        self._busy = False
        self._holder: Optional[str] = None
        for job, share in (shares or {}).items():
            self.register(job, share)

    def register(self, job_id: str, share: float = 1.0) -> None:
        job = str(job_id)
        with self._cond:
            self._shares[job] = max(float(share), _MIN_SHARE)
            self._used_s.setdefault(job, 0.0)
            self._waiting.setdefault(job, 0)
            self._hold_count.setdefault(job, 0)
            self._prologue_s.setdefault(job, 0.0)

    # -- the DRR core --------------------------------------------------------
    def _next_grant(self) -> Optional[str]:
        """The waiting job with the lowest share-normalized usage (ties go
        to the smaller job id, for determinism); None when nobody waits."""
        contenders = [j for j in sorted(self._waiting)
                      if self._waiting[j] > 0]
        if not contenders:
            return None
        return min(contenders,
                   key=lambda j: (self._used_s[j] / self._shares[j], j))

    def acquire(self, job_id: str) -> None:
        job = str(job_id)
        with self._cond:
            if job not in self._shares:
                self.register(job)
            self._waiting[job] += 1
            try:
                while self._busy or self._next_grant() != job:
                    self._cond.wait()
            except BaseException:
                # e.g. a KeyboardInterrupt mid-wait: a phantom waiter that
                # _next_grant keeps selecting would wedge every tenant, so
                # withdraw and wake whoever is first now
                self._waiting[job] -= 1
                self._cond.notify_all()
                raise
            self._waiting[job] -= 1
            self._busy = True
            self._holder = job

    def release(self, job_id: str, elapsed_s: float) -> None:
        job = str(job_id)
        elapsed = max(0.0, float(elapsed_s))
        with self._cond:
            self._used_s[job] = self._used_s.get(job, 0.0) + elapsed
            n = self._hold_count.get(job, 0)
            self._hold_count[job] = n + 1
            if n < self._prologue_holds:
                self._prologue_s[job] = \
                    self._prologue_s.get(job, 0.0) + elapsed
            self._busy = False
            self._holder = None
            self._cond.notify_all()

    # -- accounting ----------------------------------------------------------
    def usage(self) -> Dict[str, float]:
        """Cumulative device-held seconds a job."""
        with self._cond:
            return dict(self._used_s)

    def steady_usage(self) -> Dict[str, float]:
        """Device-held seconds a job without its first ``prologue_holds``
        holds (:data:`PROLOGUE_HOLDS`): the fairness estimator's input."""
        with self._cond:
            return {j: self._used_s[j] - self._prologue_s.get(j, 0.0)
                    for j in self._used_s}

    def fairness_ratio(self, steady: bool = True) -> Optional[float]:
        """Worst over best share-normalized device time across the jobs
        (1.0 is even; None until two jobs qualify). ``steady`` (the
        default) measures past each job's prologue; ``steady=False`` is
        the raw cumulative ratio."""
        with self._cond:
            if steady:
                usage = {j: self._used_s[j] - self._prologue_s.get(j, 0.0)
                         for j in self._used_s
                         if self._hold_count.get(j, 0)
                         > self._prologue_holds}
                # a registered tenant that never held the device is the
                # starvation this metric exists to catch: it counts at
                # zero (tenants mid-prologue stay out: they did get device
                # time, there is no steady window yet)
                usage.update({j: 0.0 for j in self._used_s
                              if self._hold_count.get(j, 0) == 0})
            else:
                usage = dict(self._used_s)
            # zero-usage jobs stay in the min and max: total starvation
            # reads 0.0, not perfect fairness among the fed
            norm = [max(0.0, usage[j]) / self._shares[j]
                    for j in sorted(usage)]
        if len(norm) < 2 or max(norm) <= 0.0:
            return None
        return min(norm) / max(norm)

    def gate(self, job_id: str, device_lock=None,
             timer=None) -> "JobDeviceGate":
        """The job's device gate (registers the job on first use)."""
        if str(job_id) not in self._shares:
            self.register(job_id)
        return JobDeviceGate(self, job_id, device_lock=device_lock,
                             timer=timer)


class JobDeviceGate:
    """The cross-silo device mutex, scoped to one job: a DRR slot first,
    then the real device lock. Re-entrant (the lock is an RLock); only the
    outermost hold takes a DRR slot and is charged to the job."""

    def __init__(self, interleaver: RoundInterleaver, job_id: str,
                 device_lock=None, timer=None):
        self._interleaver = interleaver
        self.job_id = str(job_id)
        if device_lock is None:
            from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
                _DEVICE_LOCK)
            device_lock = _DEVICE_LOCK
        self._device_lock = device_lock
        self._timer = timer
        self._tls = threading.local()

    def __enter__(self) -> "JobDeviceGate":
        depth = getattr(self._tls, "depth", 0)
        if depth == 0:
            t0 = time.monotonic()
            self._interleaver.acquire(self.job_id)
            try:
                self._device_lock.acquire()
            except BaseException:
                # never keep the DRR grant without the mutex: a stuck busy
                # flag with no holder would block every tenant
                self._interleaver.release(self.job_id, 0.0)
                raise
            self._tls.t_acquired = time.monotonic()
            self._tls.waited = self._tls.t_acquired - t0
        else:
            self._device_lock.acquire()  # a re-entrant inner hold
        self._tls.depth = depth + 1
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        depth = self._tls.depth - 1
        self._tls.depth = depth
        self._device_lock.release()
        if depth == 0:
            elapsed = time.monotonic() - self._tls.t_acquired
            self._interleaver.release(self.job_id, elapsed)
            if self._timer is not None:
                # the job's device accounting in the metric registry (an
                # observer, never load-bearing)
                self._timer.add("sched_device_time", elapsed)
                self._timer.add("sched_gate_wait", self._tls.waited)
                self._timer.count("sched_device_acquires")
