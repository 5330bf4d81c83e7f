"""Adaptive pace steering: round deadlines and quorum targets from the
observed straggler behavior (Bonawitz et al., MLSys 2019, §4.2), the
port's copy of ``fedml_tpu/control/pace.py``.

The deadline server's static ``round_deadline_s`` and ``min_quorum_frac``
ignore the straggler distribution the server actually sees: too tight
and healthy silos are evicted every round, too loose and one straggler
stretches every round. :class:`PaceSteerer` closes the loop. It reads the
liveness table's sliding report-latency window
(``utils/watchdog.SlidingQuantileTracker``: each silo's time from the
round's broadcast to its reply) and the rounds' participation, and gives

- **the next round's deadline**: ``quantile(q) * margin`` (p90 x 1.5 by
  default), clamped to ``[min_deadline_s, max_deadline_s]`` (base/4 ..
  base*4 by default), so a burst of outliers can neither collapse the
  deadline nor stretch it without bound;
- **the next round's quorum fraction**: the 25th percentile of recent
  per-round report fractions minus a slack (0.1), clamped to
  ``[quorum_floor, QUORUM_CEIL]``. The ceiling alone cannot prevent the
  single-straggler deadlock (``ceil(0.9 * n) == n`` for every fleet of 10
  or fewer), so the deadline server also caps the effective requirement
  at ``live - 1`` silos while steering is on
  (``FedAvgServerManager.handle_round_timeout``).

Below ``min_samples`` observations both knobs return the caller's static
values. The steerer's window is part of the server's control snapshot
(:meth:`state` / :meth:`load_state`), so a restored server steers from
the evidence the unkilled one had.

Churn cannot poison the window for long: a rejoin-resync reply measures
the silo's outage, not its pace, and is left out where it is observed
(``cp_resync_latency_skips``); the clamp bounds what remains; and the
window slides, so healthy reports restore the steady-state quantiles.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

from fedml_tpu_torch.utils.watchdog import interpolated_quantile

#: the steered quorum never asks for more than this fraction: a full
#: barrier (1.0) would deadlock on the first permanently dead silo
QUORUM_CEIL = 0.95


class PaceSteerer:
    def __init__(self, base_deadline_s: float,
                 quantile: float = 0.9, margin: float = 1.5,
                 min_deadline_s: Optional[float] = None,
                 max_deadline_s: Optional[float] = None,
                 min_samples: int = 4,
                 quorum_floor: float = 0.5,
                 quorum_slack: float = 0.1,
                 window: int = 32):
        if base_deadline_s is None or base_deadline_s <= 0:
            raise ValueError("pace steering needs a positive base "
                             "deadline (--round_deadline_s) to fall back "
                             f"on; got {base_deadline_s!r}")
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {quantile}")
        if not 0.0 < quorum_floor <= QUORUM_CEIL:
            raise ValueError(f"quorum_floor must be in (0, {QUORUM_CEIL}], "
                             f"got {quorum_floor}")
        self.base_deadline_s = float(base_deadline_s)
        self.quantile = float(quantile)
        self.margin = float(margin)
        self.min_deadline_s = (float(min_deadline_s)
                               if min_deadline_s is not None
                               else self.base_deadline_s / 4.0)
        self.max_deadline_s = (float(max_deadline_s)
                               if max_deadline_s is not None
                               else self.base_deadline_s * 4.0)
        if self.min_deadline_s > self.max_deadline_s:
            raise ValueError(
                f"min_deadline_s {self.min_deadline_s} > max_deadline_s "
                f"{self.max_deadline_s}")
        self.min_samples = max(1, int(min_samples))
        self.quorum_floor = float(quorum_floor)
        self.quorum_slack = float(quorum_slack)
        #: each closed round's fraction of the live silos that reported
        self._report_fracs: deque = deque(maxlen=int(window))

    def observe_round(self, reported: int, live: int) -> None:
        """Record one closed round's participation (reported / live)."""
        self._report_fracs.append(min(1.0, reported / max(1, live)))

    def next_deadline(self, latencies) -> float:
        """``latencies`` has ``count()`` and ``quantile(q)`` (a
        SlidingQuantileTracker). Below ``min_samples`` the base deadline
        holds: steering never extrapolates from nothing."""
        if latencies is None or latencies.count() < self.min_samples:
            return self.base_deadline_s
        q = latencies.quantile(self.quantile)
        return min(self.max_deadline_s,
                   max(self.min_deadline_s, q * self.margin))

    def next_quorum_frac(self) -> float:
        if len(self._report_fracs) < self.min_samples:
            return self.quorum_floor
        p25 = interpolated_quantile(list(self._report_fracs), 0.25)
        return min(QUORUM_CEIL,
                   max(self.quorum_floor, p25 - self.quorum_slack))

    def state(self) -> Dict:
        return {"report_fracs": [float(f) for f in self._report_fracs]}

    def load_state(self, state: Optional[Dict]) -> None:
        if not state:
            return
        self._report_fracs.clear()
        self._report_fracs.extend(float(f)
                                  for f in state.get("report_fracs", ()))
