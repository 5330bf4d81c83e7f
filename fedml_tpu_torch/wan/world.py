"""The WAN world model: one seeded object driving the cross-silo
federation through realistic population dynamics (the port's copy of
``fedml_tpu/wan/world.py``).

:class:`WanWorld` composes:

- an :class:`~fedml_tpu_torch.wan.trace.AvailabilityTrace` (diurnal churn
  and flap bursts) on a **virtual clock**: round ``r`` is at sim time
  ``r * round_s``, so everything population-side is a pure function of
  the round index and a churn run replays bit for bit under one seed;
- :class:`~fedml_tpu_torch.wan.profiles.ClientProfiles` turned into
  injected report delays;
- **availability-restricted cohorts**: ``sample_cohort`` wraps
  :func:`fedml_tpu_torch.core.sampling.sample_clients_available` with
  the trace at the round's sim time;
- **mass-churn accounting**: each round the trace's estimated JOIN wave
  drains a SHADOW
  :class:`~fedml_tpu_torch.control.admission.JoinAdmissionController`
  on the sim clock (``wan_mass_joins`` / ``wan_mass_join_throttled``),
  without touching the real silos' JOINs;
- per-silo :class:`WanAgent` instances: a silo whose device the trace
  marks offline drops its reply and goes dark (the server's deadline
  evicts it, the real eviction path), and an online silo sleeps its
  client's profiled report delay before replying.

Silo ``rank`` maps to a fixed device id (a Knuth hash over the
population's id space), so silo churn follows the same diurnal model.
The server gates rejoin on the trace (``silo_online``): an evicted
silo's JOINs get BACKPRESSURE until its device is online again, which
ties the rejoin round to the trace instead of to the wall clock.

:func:`compose_fault_plan` merges message-level fault rules
(``comm/faults.py``) into the same launch, so ``--fault_plan`` and
``--wan_trace`` run together.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from fedml_tpu_torch.wan.profiles import (ClientProfiles, ProfileConfig,
                                    parse_wan_profiles)
from fedml_tpu_torch.wan.trace import (AvailabilityTrace, TraceConfig,
                                       parse_wan_trace)

#: Knuth multiplicative hash — spreads silo ranks over the population id
#: space so neighboring silos' devices land in uncorrelated trace draws
_RANK_SPREAD = 2654435761


class WanWorld:
    """The shared world: one instance per launch, handed to the server
    (sampling, rejoin gating, churn telemetry) and — via :meth:`agent` —
    to every silo (offline drops, injected delays)."""

    def __init__(self, trace: Optional[TraceConfig] = None,
                 profiles: Optional[ProfileConfig] = None,
                 round_s: float = 60.0,
                 population: Optional[int] = None,
                 delay_scale: float = 1.0,
                 delay_wall_cap_s: float = 2.0,
                 offline_hold_s: float = 0.6,
                 join_retry_s: float = 0.5,
                 mass_join_rate: float = 0.0,
                 churn_sample: int = 4096,
                 max_join_deferrals_per_round: int = 25):
        self.trace = AvailabilityTrace(parse_wan_trace(trace)
                                       if not isinstance(trace, TraceConfig)
                                       else trace)
        prof_cfg = (profiles if isinstance(profiles, ProfileConfig)
                    else parse_wan_profiles(profiles))
        self.profiles = ClientProfiles(prof_cfg) if prof_cfg else None
        if round_s <= 0:
            raise ValueError(f"round_s must be > 0, got {round_s}")
        self.round_s = float(round_s)
        #: the population the aggregate estimates scale to (set late by
        #: the launcher from the dataset when not given)
        self.population = int(population) if population else None
        #: injected sim delays are multiplied by this before sleeping
        #: them in wall time (compressing a 60 s sim round into a
        #: sub-second wall round), then capped at ``delay_wall_cap_s``
        self.delay_scale = float(delay_scale)
        self.delay_wall_cap_s = float(delay_wall_cap_s)
        self.offline_hold_s = float(offline_hold_s)
        self.join_retry_s = float(join_retry_s)
        self.churn_sample = int(churn_sample)
        #: graceful-degradation valve for the server's trace-gated
        #: rejoin: the virtual clock only advances when rounds close, so
        #: a round stuck extending (every live silo dark) would freeze
        #: the trace and defer every JOIN forever — a deadlock the WAN
        #: layer must never introduce. After this many deferrals of one
        #: silo's JOIN inside ONE round, the server admits it anyway
        #: (the device "came back early"). Sized above any healthy
        #: round's JOIN-retry count (a deadline-paced round sees
        #: ~deadline/join_retry_s of them) but WELL below the
        #: deadline-extension budget, so it fires only where the
        #: alternative was a SchedulingStallError.
        self.max_join_deferrals_per_round = int(max_join_deferrals_per_round)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        #: ranks the anti-starvation valve forced online: the server's
        #: valve admit must be visible to the silo's OWN agent (same
        #: world instance, silos are threads), or the re-admitted silo
        #: would keep dropping broadcasts against the frozen trace and
        #: the stall the valve exists to break would persist. The force
        #: clears itself the moment the trace naturally flips online.
        self._forced_online: set = set()
        # shadow admission bucket on the SIM clock (deterministic): the
        # population-scale JOIN wave drains it, the real silo JOINs keep
        # the server's own bucket
        self._mass_admission = None
        if mass_join_rate and mass_join_rate > 0:
            from fedml_tpu_torch.control.admission import (
                JoinAdmissionController)
            self._sim_now = 0.0
            self._mass_admission = JoinAdmissionController(
                float(mass_join_rate), clock=lambda: self._sim_now)

    # -- virtual clock ------------------------------------------------------
    def t_of_round(self, round_idx: int) -> float:
        """Sim time of round ``round_idx`` — THE clock every trace query
        uses; never the wall."""
        return float(round_idx) * self.round_s

    # -- counters -----------------------------------------------------------
    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def drain_counters(self) -> Dict[str, int]:
        """Return-and-clear the accumulated counter deltas (the server
        folds them into its RoundTimer at each round close)."""
        with self._lock:
            out, self._counters = self._counters, {}
            return out

    # -- population side ----------------------------------------------------
    def sample_cohort(self, round_idx: int, total: int,
                      per_round: int, record: bool = True) -> np.ndarray:
        """Availability-restricted cohort draw at the round's sim time
        (the server's ``client_sampling`` hook). ``record=False`` skips
        the telemetry counters — the silos' prefetch PREDICTION runs the
        same pure draw (so speculation stays exact under WAN sampling)
        without double-counting the server's per-round stats."""
        from fedml_tpu_torch.core.sampling import sample_clients_available
        t = self.t_of_round(round_idx)
        stats: Dict[str, int] = {}
        out = sample_clients_available(
            round_idx, total, per_round,
            lambda cids: self.trace.available(cids, t), stats=stats)
        if record and stats.get("rejected"):
            self.bump("wan_cohort_rejections", stats["rejected"])
        if record and stats.get("forced"):
            self.bump("wan_forced_cohorts", stats["forced"])
        return out

    def available_frac(self, round_idx: int) -> Optional[float]:
        if not self.population:
            return None
        return self.trace.available_frac(self.t_of_round(round_idx),
                                         self.population,
                                         sample=self.churn_sample)

    def mass_churn(self, round_idx: int) -> Tuple[int, int, int]:
        """Estimated population ``(joins, leaves, throttled)`` across the
        closed round: the trace's churn wave, with the join side driven
        through the shadow admission bucket on the sim clock. All
        deterministic — a replay sees the identical wave."""
        if not self.population or round_idx < 1:
            return 0, 0, 0
        joins, leaves = self.trace.churn_between(
            self.t_of_round(round_idx - 1), self.t_of_round(round_idx),
            self.population, sample=self.churn_sample)
        throttled = 0
        if self._mass_admission is not None and joins:
            self._sim_now = self.t_of_round(round_idx)
            # drive the wave through the REAL bucket one JOIN at a time,
            # capped so a million-device edge costs the round close a
            # few thousand cheap calls, not 10^5 — past the cap the
            # bucket is provably empty (the cap exceeds any sane
            # burst + one round's refill), so the remainder is
            # throttled arithmetically
            cap = 4096
            for _ in range(min(joins, cap)):
                if not self._mass_admission.try_acquire():
                    throttled += 1
            if joins > cap:
                throttled += joins - cap
        return joins, leaves, throttled

    # -- silo (device) side -------------------------------------------------
    def silo_device(self, rank: int) -> int:
        """The fixed device id silo ``rank`` embodies for availability
        purposes (spread over the population id space — or a synthetic
        1k space when no population is set)."""
        space = self.population or 1024
        return (int(rank) * _RANK_SPREAD) % space

    def silo_online(self, rank: int, round_idx: int) -> bool:
        """Is silo ``rank``'s device online at round ``round_idx``? Pure
        function of (trace seed, rank, round) — the server's rejoin gate
        and the agents' drop decision agree by construction — except
        while the anti-starvation valve holds the rank forced online
        (:meth:`force_online`), which wins until the trace itself flips
        back."""
        dev = self.silo_device(rank)
        on = bool(self.trace.available(
            np.asarray([dev], dtype=np.int64),
            self.t_of_round(round_idx))[0])
        with self._lock:
            if int(rank) in self._forced_online:
                if on:
                    # the trace caught up: normal dynamics resume
                    self._forced_online.discard(int(rank))
                return True
        return on

    def force_online(self, rank: int) -> None:
        """Anti-starvation override (the server's valve): treat this
        silo's device as online — for BOTH the server's gates and the
        silo's own agent — until the trace naturally flips it back."""
        with self._lock:
            self._forced_online.add(int(rank))

    def agent(self, rank: int) -> "WanAgent":
        return WanAgent(self, rank)

    def report_delay_s(self, client_idx: int, up_bytes: float,
                       down_bytes: float) -> float:
        """The WALL delay a silo embodying ``client_idx`` injects before
        its reply: the profiled sim delay scaled by ``delay_scale`` and
        capped (a tail draw degrades a round, never wedges one)."""
        if self.profiles is None:
            return 0.0
        sim = float(self.profiles.report_delay_s(
            np.asarray([client_idx], dtype=np.int64),
            up_bytes=up_bytes, down_bytes=down_bytes)[0])
        return min(sim * self.delay_scale, self.delay_wall_cap_s)


class WanAgent:
    """One silo's view of the world: decides, per round, whether the
    embodied device drops off (trace) and how long its report takes
    (profiles). Holds ONLY transient dark-window state — every decision
    input is a pure function of (seed, rank/client, round)."""

    def __init__(self, world: WanWorld, rank: int):
        self.world = world
        self.rank = int(rank)
        self._dark_until = 0.0
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {"wan_offline_drops": 0,
                                         "wan_delay_injected_ms": 0}

    def on_round(self, round_idx: int, client_idx: int,
                 up_bytes: float = 0.0,
                 down_bytes: float = 0.0) -> Tuple[bool, float]:
        """Called by the silo on every broadcast it would train on.
        Returns ``(drop, delay_s)``: ``drop`` means the device is
        offline this round — no training, no reply, and the silo goes
        dark (no heartbeats) for ``offline_hold_s`` so the server's
        deadline eviction is what removes it, exactly the real path."""
        if not self.world.silo_online(self.rank, round_idx):
            with self._lock:
                self._dark_until = (time.monotonic()
                                    + self.world.offline_hold_s)
                self.counters["wan_offline_drops"] += 1
            return True, 0.0
        delay = self.world.report_delay_s(client_idx, up_bytes, down_bytes)
        if delay > 0:
            with self._lock:
                self.counters["wan_delay_injected_ms"] += int(delay * 1e3)
        return False, delay

    def online_now(self) -> bool:
        """Heartbeat-thread gate: False while the device is inside its
        dark hold — no beats, no JOIN escalation (the trace-side rejoin
        gate at the server anchors the REJOIN round; this hold only
        keeps the dark window quiet)."""
        with self._lock:
            # the dark hold is a wall-clock window by design; the rejoin
            # ROUND comes from the server's trace gate, not from it
            return time.monotonic() >= self._dark_until


def build_wan_world(wan_trace=None, wan_profiles=None,
                    wan_round_s: float = 60.0,
                    population: Optional[int] = None,
                    mass_join_rate: float = 0.0,
                    **kw) -> Optional[WanWorld]:
    """Launcher front door: returns None when no trace spec is given
    (the WAN layer stays completely off — byte-identical legacy
    behavior), else a :class:`WanWorld` from the parsed specs."""
    trace = parse_wan_trace(wan_trace)
    if trace is None:
        if wan_profiles:
            raise ValueError("--wan_profiles without --wan_trace: the "
                             "profile delays ride the WAN world's clock — "
                             "pass a trace spec (even a flat one: "
                             "'peak=1.0;trough=1.0')")
        return None
    return WanWorld(trace=trace, profiles=parse_wan_profiles(wan_profiles),
                    round_s=wan_round_s, population=population,
                    mass_join_rate=mass_join_rate, **kw)


def compose_fault_plan(base_plan, extra_rules=()):
    """Merge message-level chaos rules into a launch that also runs a
    WAN world, through :func:`fedml_tpu_torch.comm.faults.merge_plans`:
    the base plan's rules first, its seed keying every stream."""
    from fedml_tpu_torch.comm.faults import FaultPlan, merge_plans
    extra = FaultPlan(seed=getattr(base_plan, "seed", 0) if base_plan
                      else 0, rules=tuple(extra_rules))
    return merge_plans(base_plan, extra)
