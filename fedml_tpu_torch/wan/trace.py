"""Seeded diurnal availability traces: WAN population dynamics as a pure
function of ``(seed, client_id, simulated_time)`` (the port's copy of
``fedml_tpu/wan/trace.py``, bit for bit the same draws).

Device availability follows the day/night cycle (Bonawitz et al., MLSys
2019, section 2.1), with per-device phase and duty spread and short
correlated outages. :class:`AvailabilityTrace` models that with no
per-client state: ``available(cids, t)`` is a vectorized pure function of
a sinusoid-of-day base rate, per-client phase and duty jitter from the
splitmix64 per-client hash
(:func:`fedml_tpu_torch.state.population.client_uniform`) and one
independent draw a ``slot`` (``slot = t // slot_s``), so devices hold
coherent ON/OFF episodes. ``t`` is sim seconds (round ``r`` is at
``r * round_s``, ``wan/world.py``); nothing here reads the wall clock,
so a trace replays bit for bit.

A ``FlapBurst(start_s, duration_s, frac)`` forces a seeded ``frac`` of
the population OFF for its window, on top of the diurnal draw.

Spec DSL (``--wan_trace``): semicolon-separated ``key=value`` tokens with
repeatable ``flap=start:duration:frac`` windows, or inline JSON / a
``.json`` path with the same field names::

    seed=7;period_s=86400;peak=0.95;trough=0.45;slot_s=600;
        flap=3600:300:0.5;flap=7200:120:0.3
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from fedml_tpu_torch.state.population import client_uniform

#: hash-salt families: each independent per-client draw gets its own
#: namespace so phase, duty, episode, and flap draws never correlate
_SALT_PHASE = 0xA11CE
_SALT_DUTY = 0xD07
_SALT_SLOT = 0x51075
_SALT_FLAP = 0xF1A9


@dataclass(frozen=True)
class FlapBurst:
    """A correlated outage: a seeded ``frac`` of the population is
    forced OFF for ``[start_s, start_s + duration_s)`` sim seconds."""

    start_s: float
    duration_s: float
    frac: float

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(f"flap duration must be > 0, got "
                             f"{self.duration_s}")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"flap frac must be in [0, 1], got {self.frac}")

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.start_s + self.duration_s


@dataclass(frozen=True)
class TraceConfig:
    """The diurnal world model. ``peak``/``trough`` are the population
    availability rates at the sinusoid's extremes; ``phase_jitter_s``
    spreads per-client peak hours (timezones), ``duty_jitter`` scales
    each client's personal ceiling down by up to that fraction, and
    ``slot_s`` is the ON/OFF episode length (a device re-draws its state
    once per slot, not per query)."""

    seed: int = 0
    period_s: float = 86_400.0
    peak: float = 0.95
    trough: float = 0.45
    #: global phase offset (sim seconds): positions the sinusoid so a
    #: schedule starting at t=0 meets its trough where the scenario
    #: wants it (phase0_s = period/2 puts the trough at period/4)
    phase0_s: float = 0.0
    phase_jitter_s: float = 0.0
    duty_jitter: float = 0.1
    slot_s: float = 600.0
    flaps: Tuple[FlapBurst, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.period_s <= 0 or self.slot_s <= 0:
            raise ValueError("period_s and slot_s must be > 0")
        if not 0.0 <= self.trough <= self.peak <= 1.0:
            raise ValueError(
                f"need 0 <= trough <= peak <= 1, got trough={self.trough} "
                f"peak={self.peak}")
        if not 0.0 <= self.duty_jitter < 1.0:
            raise ValueError(f"duty_jitter must be in [0, 1), got "
                             f"{self.duty_jitter}")
        object.__setattr__(self, "flaps", tuple(self.flaps))


class AvailabilityTrace:
    """``available(cids, t)`` and friends — every method is a pure,
    vectorized function of ``(config, cids, t)``; the instance holds
    only the (frozen) config."""

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config or TraceConfig()

    # -- per-client static attributes (pure hashes) -------------------------
    def _phase_s(self, cids: np.ndarray) -> np.ndarray:
        cfg = self.config
        if not cfg.phase_jitter_s:
            return np.zeros(len(cids))
        u = client_uniform(cids, cfg.seed, salt=_SALT_PHASE)
        return (u - 0.5) * 2.0 * cfg.phase_jitter_s

    def _duty(self, cids: np.ndarray) -> np.ndarray:
        cfg = self.config
        if not cfg.duty_jitter:
            return np.ones(len(cids))
        u = client_uniform(cids, cfg.seed, salt=_SALT_DUTY)
        return 1.0 - cfg.duty_jitter * u

    # -- the availability rate (the sinusoid, before the episode draw) ------
    def rate(self, cids, t: float) -> np.ndarray:
        """Per-client P(on) at sim time ``t``: the diurnal sinusoid
        evaluated at the client's personal phase, scaled by its duty."""
        cfg = self.config
        cids = np.asarray(cids, dtype=np.uint64)
        tt = float(t) + cfg.phase0_s + self._phase_s(cids)
        base = cfg.trough + (cfg.peak - cfg.trough) * 0.5 * (
            1.0 + np.sin(2.0 * math.pi * tt / cfg.period_s))
        return np.clip(base * self._duty(cids), 0.0, 1.0)

    def flapped(self, cids, t: float) -> np.ndarray:
        """True where a flap burst active at ``t`` forces the client
        OFF (each burst picks its own seeded ``frac`` of the ids)."""
        cids = np.asarray(cids, dtype=np.uint64)
        out = np.zeros(len(cids), dtype=bool)
        for i, burst in enumerate(self.config.flaps):
            if burst.active(t):
                u = client_uniform(cids, self.config.seed,
                                   salt=_SALT_FLAP + 7919 * (i + 1))
                out |= u < burst.frac
        return out

    def available(self, cids, t: float) -> np.ndarray:
        """The trace itself: bool per client at sim time ``t``. One
        independent draw per ``(client, slot)`` compared against the
        client's diurnal rate, minus any active flap burst."""
        cfg = self.config
        cids = np.asarray(cids, dtype=np.uint64)
        slot = int(float(t) // cfg.slot_s)
        u = client_uniform(cids, cfg.seed,
                           salt=_SALT_SLOT + 0x9E37 * slot)
        on = u < self.rate(cids, t)
        flaps = self.flapped(cids, t)
        if flaps.any():
            on &= ~flaps
        return on

    # -- population aggregates (deterministic strided sample) ---------------
    def _sample_ids(self, population: int, sample: int) -> np.ndarray:
        n = min(int(population), int(sample))
        stride = max(1, population // n)
        return (np.arange(n, dtype=np.int64) * stride) % population

    def available_frac(self, t: float, population: int,
                       sample: int = 4096) -> float:
        """Fraction of the population online at ``t``, measured on a
        deterministic strided sample (exact when sample >= population)."""
        ids = self._sample_ids(population, sample)
        return float(np.mean(self.available(ids, t)))

    def churn_between(self, t0: float, t1: float, population: int,
                      sample: int = 4096) -> Tuple[int, int]:
        """Estimated ``(joins, leaves)`` across ``[t0, t1]``: clients
        offline at t0 and online at t1 joined (and vice versa), the
        sampled fractions scaled to the population. Deterministic — the
        mass-JOIN wave the admission controller is fed with."""
        ids = self._sample_ids(population, sample)
        a0 = self.available(ids, t0)
        a1 = self.available(ids, t1)
        scale = population / max(1, len(ids))
        joins = int(round(float(np.sum(~a0 & a1)) * scale))
        leaves = int(round(float(np.sum(a0 & ~a1)) * scale))
        return joins, leaves


# -- spec parsing (--wan_trace) --------------------------------------------
_FLOAT_KEYS = {"period_s", "peak", "trough", "phase0_s", "phase_jitter_s",
               "duty_jitter", "slot_s"}


def parse_wan_trace(spec: Union[None, str, dict, TraceConfig]
                    ) -> Optional[TraceConfig]:
    """``--wan_trace`` front door: an existing config, inline JSON, a
    ``.json`` path, or the compact DSL (module docstring). ``None`` or an
    empty spec returns None — the WAN layer stays off."""
    if spec is None or isinstance(spec, TraceConfig):
        return spec
    if isinstance(spec, dict):
        return _trace_from_obj(spec)
    s = str(spec).strip()
    if not s:
        return None
    if s.startswith("{"):
        return _trace_from_obj(json.loads(s))
    if s.endswith(".json"):
        if not os.path.exists(s):
            raise FileNotFoundError(f"--wan_trace file not found: {s}")
        with open(s, "r", encoding="utf-8") as fh:
            return _trace_from_obj(json.load(fh))
    kw: dict = {}
    flaps = []
    for token in filter(None, (tok.strip() for tok in s.split(";"))):
        key, _, val = token.partition("=")
        key = key.strip()
        val = val.strip()
        if key == "flap":
            parts = val.split(":")
            if len(parts) != 3:
                raise ValueError(
                    f"flap spec must be start:duration:frac, got {val!r}")
            flaps.append(FlapBurst(float(parts[0]), float(parts[1]),
                                   float(parts[2])))
        elif key == "seed":
            kw["seed"] = int(val)
        elif key in _FLOAT_KEYS:
            kw[key] = float(val)
        else:
            raise ValueError(
                f"unknown --wan_trace key {key!r} "
                f"(known: seed, flap, {', '.join(sorted(_FLOAT_KEYS))})")
    return TraceConfig(flaps=tuple(flaps), **kw)


def _trace_from_obj(obj: dict) -> TraceConfig:
    flaps = tuple(FlapBurst(**f) if isinstance(f, dict)
                  else FlapBurst(*f) for f in obj.get("flaps", ()))
    kw = {k: obj[k] for k in obj if k != "flaps"}
    if "seed" in kw:
        kw["seed"] = int(kw["seed"])
    return TraceConfig(flaps=flaps, **kw)
