"""Heterogeneous client profiles: per-client compute and network rates
as pure functions of ``(seed, client_id)`` (the port's copy of
``fedml_tpu/wan/profiles.py``, bit for bit the same draws).

:class:`ClientProfiles` derives, statelessly and vectorized:

- **compute time**: lognormal around ``compute_median_s`` with shape
  ``compute_sigma``; the normal deviate is a Box-Muller transform of two
  splitmix64 per-client uniforms;
- **uplink / downlink bandwidth**: Pareto with scale ``*_min_bps`` and
  tail ``bw_alpha``, bounded below by the scale, with most devices near
  that floor (where stragglers live).

``report_delay_s(cids, up_bytes, down_bytes)`` composes the three into
the report latency a silo embodying that client adds before its reply;
``delay_quantile(q, ...)`` is the exact injected quantile on a
deterministic strided sample. Sim-time arithmetic only: no wall-clock
reads.

Spec DSL (``--wan_profiles``)::

    seed=5;compute_median_s=0.1;compute_sigma=0.8;up_min_bps=250000;
        down_min_bps=1000000;bw_alpha=1.5;delay_cap_s=2.0
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from fedml_tpu_torch.state.population import client_uniform

_SALT_Z1 = 0xC0FFEE
_SALT_Z2 = 0xBEEF
_SALT_UP = 0x0B5
_SALT_DOWN = 0xD0108


@dataclass(frozen=True)
class ProfileConfig:
    seed: int = 0
    #: lognormal compute-time model: median seconds per local round and
    #: the log-space sigma (0 = homogeneous compute)
    compute_median_s: float = 0.05
    compute_sigma: float = 0.8
    #: Pareto bandwidth model: scale (the SLOWEST device's rate) and the
    #: shared tail index; most mass sits near the scale, which is the
    #: point — the slow tail is what stragglers are made of
    up_min_bps: float = 250_000.0
    down_min_bps: float = 1_000_000.0
    bw_alpha: float = 1.6
    #: hard cap on any single injected delay (sim seconds): a pathological
    #: tail draw must degrade a round, not wedge the schedule
    delay_cap_s: float = 8.0

    def __post_init__(self):
        if self.compute_median_s < 0 or self.compute_sigma < 0:
            raise ValueError("compute_median_s and compute_sigma must be "
                             ">= 0")
        if self.up_min_bps <= 0 or self.down_min_bps <= 0:
            raise ValueError("bandwidth scales must be > 0")
        if self.bw_alpha <= 0:
            raise ValueError(f"bw_alpha must be > 0, got {self.bw_alpha}")
        if self.delay_cap_s <= 0:
            raise ValueError(f"delay_cap_s must be > 0, got "
                             f"{self.delay_cap_s}")


class ClientProfiles:
    """Vectorized pure-function profile lookups (no per-client state)."""

    def __init__(self, config: Optional[ProfileConfig] = None):
        self.config = config or ProfileConfig()

    def _normal(self, cids: np.ndarray) -> np.ndarray:
        """One standard-normal deviate per client: Box–Muller over two
        independent per-client hashed uniforms."""
        cfg = self.config
        u1 = client_uniform(cids, cfg.seed, salt=_SALT_Z1)
        u2 = client_uniform(cids, cfg.seed, salt=_SALT_Z2)
        return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * math.pi * u2)

    def compute_s(self, cids) -> np.ndarray:
        """Per-client local-train wall cost (sim seconds), lognormal."""
        cfg = self.config
        cids = np.asarray(cids, dtype=np.uint64)
        if not cfg.compute_median_s:
            return np.zeros(len(cids))
        return cfg.compute_median_s * np.exp(
            cfg.compute_sigma * self._normal(cids))

    def _pareto_bps(self, cids: np.ndarray, scale: float,
                    salt: int) -> np.ndarray:
        u = client_uniform(cids, self.config.seed, salt=salt)
        # inverse CDF: scale * u^(-1/alpha); u near 1 -> near the scale
        # (the slow floor), u near 0 -> the fast tail
        return scale * u ** (-1.0 / self.config.bw_alpha)

    def uplink_bps(self, cids) -> np.ndarray:
        return self._pareto_bps(np.asarray(cids, dtype=np.uint64),
                                self.config.up_min_bps, _SALT_UP)

    def downlink_bps(self, cids) -> np.ndarray:
        return self._pareto_bps(np.asarray(cids, dtype=np.uint64),
                                self.config.down_min_bps, _SALT_DOWN)

    def report_delay_s(self, cids, up_bytes: float = 0.0,
                       down_bytes: float = 0.0) -> np.ndarray:
        """The injected broadcast-to-reply latency for each client:
        download + compute + upload, capped at ``delay_cap_s``."""
        cids = np.asarray(cids, dtype=np.uint64)
        delay = self.compute_s(cids)
        if down_bytes:
            delay = delay + float(down_bytes) / self.downlink_bps(cids)
        if up_bytes:
            delay = delay + float(up_bytes) / self.uplink_bps(cids)
        return np.minimum(delay, self.config.delay_cap_s)

    def delay_quantile(self, q: float, population: int,
                       up_bytes: float = 0.0, down_bytes: float = 0.0,
                       sample: int = 4096) -> float:
        """The injected delay distribution's q-quantile over a
        deterministic strided population sample — the steering bench's
        oracle (what the steered deadline must track)."""
        n = min(int(population), int(sample))
        stride = max(1, population // n)
        ids = (np.arange(n, dtype=np.int64) * stride) % population
        delays = self.report_delay_s(ids, up_bytes, down_bytes)
        return float(np.quantile(delays, q))


# -- spec parsing (--wan_profiles) -----------------------------------------
_PROFILE_FLOAT_KEYS = {"compute_median_s", "compute_sigma", "up_min_bps",
                       "down_min_bps", "bw_alpha", "delay_cap_s"}


def parse_wan_profiles(spec: Union[None, str, dict, ProfileConfig]
                       ) -> Optional[ProfileConfig]:
    """``--wan_profiles`` front door (same shapes as the trace spec):
    config / inline JSON / .json path / ``key=value;...`` DSL."""
    if spec is None or isinstance(spec, ProfileConfig):
        return spec
    if isinstance(spec, dict):
        return _profiles_from_obj(spec)
    s = str(spec).strip()
    if not s:
        return None
    if s.startswith("{"):
        return _profiles_from_obj(json.loads(s))
    if s.endswith(".json"):
        if not os.path.exists(s):
            raise FileNotFoundError(f"--wan_profiles file not found: {s}")
        with open(s, "r", encoding="utf-8") as fh:
            return _profiles_from_obj(json.load(fh))
    kw: dict = {}
    for token in filter(None, (tok.strip() for tok in s.split(";"))):
        key, _, val = token.partition("=")
        key = key.strip()
        if key == "seed":
            kw["seed"] = int(val.strip())
        elif key in _PROFILE_FLOAT_KEYS:
            kw[key] = float(val.strip())
        else:
            raise ValueError(
                f"unknown --wan_profiles key {key!r} (known: seed, "
                f"{', '.join(sorted(_PROFILE_FLOAT_KEYS))})")
    return ProfileConfig(**kw)


def _profiles_from_obj(obj: dict) -> ProfileConfig:
    kw = dict(obj)
    if "seed" in kw:
        kw["seed"] = int(kw["seed"])
    return ProfileConfig(**kw)
