"""JOIN admission control: a token bucket between the rejoin protocol and
the server's full-precision resync path (the port's copy of
``fedml_tpu/control/admission.py``).

A JOIN that finds the bucket empty is throttled; ``retry_after_s`` says
how long until a token exists, the deferral a BACKPRESSURE reply carries.
The clock is injectable for deterministic runs, and the controller is
thread-safe.

In the port it backs the WAN world's shadow mass-JOIN bucket on the sim
clock (``wan/world.py``, ``mass_join_rate``). The server's own
``join_admission`` and ``--join_rate_limit`` are ROADMAP Slice D item 23.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class JoinAdmissionController:
    def __init__(self, rate_per_s: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0 (got {rate_per_s}); "
                             "leave admission control off instead")
        self.rate_per_s = float(rate_per_s)
        #: bucket capacity: JOINs that may land back to back before the
        #: throttling starts (default one second's worth, at least 1)
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate_per_s)
        self._clock = clock
        self._tokens = self.burst
        self._last = self._clock()
        self._lock = threading.Lock()
        self.admitted = 0
        self.throttled = 0

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last)
                           * self.rate_per_s)
        self._last = now

    def try_acquire(self) -> bool:
        """Take one token if there is one; False throttles this JOIN."""
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.admitted += 1
                return True
            self.throttled += 1
            return False

    def retry_after_s(self) -> float:
        """Seconds until a token exists (>= 0): the BACKPRESSURE reply's
        deferral."""
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= 1.0:
                return 0.0
            return (1.0 - self._tokens) / self.rate_per_s
