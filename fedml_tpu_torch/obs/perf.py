"""Roofline/MFU accounting: the flight recorder's derived performance leg
(the port's counterpart of ``fedml_tpu/obs/perf.py``, with the same
arithmetic).

Each closed ``round`` record becomes one ``perf`` record:

- **MFU**: achieved FLOP/s (the round's analytic FLOP count,
  ``utils/flops.analytic_flops``, over the measured round duration) over
  the device fleet's peak. The peak resolves from the card's name
  (``torch.cuda.get_device_name``) in the table below: NVIDIA's dense
  BF16 tensor-core peaks, the convention the JAX package reports against
  (bf16 per chip), so an f32 round reads conservatively. The per-device
  figure times the device count; ``$FEDML_TPU_PEAK_FLOPS`` overrides the
  per-device figure. The CPU or an unknown card: no peak, MFU omitted,
  never guessed.
- **comm/compute overlap**: the fraction of host pack+upload work the
  round pipeline hid behind device compute. With a prefetch hit the
  caller pays only ``prefetch_wait``, so ``hidden = pack + upload -
  prefetch_wait`` and the fraction is ``hidden / (pack + upload)``; a
  serial round hides nothing and reads 0.0.
- **wire rates**: ``comm_bytes_up``/``comm_bytes_down`` counter deltas
  over the round duration (bytes/s, actual encoded frame lengths).
- **device memory**: ``torch.cuda.memory_stats()``'s current and peak
  ``allocated_bytes.all`` in MB; omitted on the CPU.

Derivation reads ONLY the closed round record plus static facts (flops,
peak): a pure observer by construction, and :func:`derive_perf_record`
is a pure function tested against a hand-computed oracle.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Optional

#: dense BF16 tensor-core peak FLOP/s PER CARD by a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA's H100 datasheet). First match
#: wins, so the PCIe part precedes the SXM names.
PEAK_FLOPS_TABLE = [
    ("H100 PCIe", 756.0e12),
    ("H100 80GB HBM3", 989.4e12),
    ("H100 SXM", 989.4e12),
]


def device_peak_flops(device=None) -> Optional[float]:
    """Peak FLOP/s of ONE device: the ``$FEDML_TPU_PEAK_FLOPS`` override
    when set, else the table keyed by a substring of the card's name.
    ``device`` is a CUDA device (index, string or ``torch.device``; None
    = the current one) or a card's name. None on the CPU and for cards
    the table does not list: MFU against a made-up peak is worse than no
    MFU."""
    env = os.environ.get("FEDML_TPU_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            logging.warning("ignoring unparseable $FEDML_TPU_PEAK_FLOPS=%r",
                            env)
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        try:
            import torch
            if device is not None and torch.device(device).type != "cuda":
                return None
            if not torch.cuda.is_available():
                return None
            name = torch.cuda.get_device_name(device)
        except Exception:  # no CUDA runtime: no peak, never a crash
            return None
    for key, peak in PEAK_FLOPS_TABLE:
        if key in name:
            return peak
    return None


def device_memory_gauges(device=None) -> Optional[Dict[str, float]]:
    """The card's allocator watermarks in MB (``torch.cuda.memory_stats``:
    ``allocated_bytes.all.peak`` and ``.current``), or None on the CPU."""
    try:
        import torch
        if not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats(device)
    except Exception:  # degrade contract: gauges omitted, never an exception
        return None
    peak = stats.get("allocated_bytes.all.peak")
    cur = stats.get("allocated_bytes.all.current")
    if peak is None and cur is None:
        return None
    out: Dict[str, float] = {}
    if peak is not None:
        out["device_mem_peak_mb"] = round(float(peak) / (1024.0 * 1024.0),
                                          3)
    if cur is not None:
        out["device_mem_in_use_mb"] = round(float(cur) / (1024.0 * 1024.0),
                                            3)
    return out


def derive_perf_record(round_rec: Dict[str, Any], *,
                       round_flops: Optional[float] = None,
                       flops_source: Optional[str] = None,
                       peak_flops: Optional[float] = None,
                       memory: Optional[Dict[str, float]] = None
                       ) -> Optional[Dict[str, Any]]:
    """One ``perf`` record from one closed ``round`` record, a PURE
    function of its inputs (the JAX package's field for field).

    ``round_flops`` is the whole round's FLOP count (every client's local
    training plus the aggregation); ``peak_flops`` the fleet peak
    (per-device peak x device count). Fields whose inputs are missing are
    omitted, never guessed."""
    duration = round_rec.get("duration_s")
    if not duration or duration <= 0:
        return None
    rec: Dict[str, Any] = {"kind": "perf",
                           "round": round_rec.get("round"),
                           "duration_s": duration}
    phases = round_rec.get("phases") or {}
    counters = round_rec.get("counters") or {}
    # -- MFU / achieved FLOP/s --------------------------------------------
    if round_flops:
        achieved = round_flops / duration
        rec["round_flops"] = float(round_flops)
        rec["achieved_flops_per_s"] = round(achieved, 3)
        if flops_source:
            rec["flops_source"] = flops_source
        if peak_flops:
            rec["peak_flops"] = float(peak_flops)
            # significant digits, not decimal places: a CPU-smoke MFU of
            # 3e-7 must serialize as 3e-07, not round to 0.0
            rec["mfu"] = float(f"{achieved / peak_flops:.6g}")

    # -- comm/compute overlap ---------------------------------------------
    def _psec(name: str) -> float:
        return float((phases.get(name) or {}).get("s", 0.0))

    pack_s = _psec("pack") + _psec("upload")
    if pack_s > 0.0:
        if counters.get("prefetch_hit", 0) > 0:
            hidden = max(0.0, pack_s - _psec("prefetch_wait"))
            rec["comm_compute_overlap_frac"] = round(hidden / pack_s, 6)
        else:
            # serial round: the pack ran inline, nothing was hidden
            rec["comm_compute_overlap_frac"] = 0.0
    # -- wire rates ---------------------------------------------------------
    up = counters.get("comm_bytes_up")
    down = counters.get("comm_bytes_down")
    if up is not None:
        rec["wire_bytes_per_sec_up"] = round(up / duration, 3)
    if down is not None:
        rec["wire_bytes_per_sec_down"] = round(down / duration, 3)
    if memory:
        rec.update(memory)
    return rec


class PerfAccountant:
    """Per-process roofline state: the (lazily probed) round FLOP count
    plus the resolved fleet peak; :meth:`derive` turns each closed round
    record into a ``perf`` record. ``device_count`` scales the per-device
    peak to the fleet the round spans; ``device`` pins which card's name
    rates the per-device peak."""

    def __init__(self, *, peak_flops: Optional[float] = None,
                 device_count: int = 1, device=None,
                 memory_fn: Optional[Callable[[], Optional[Dict]]]
                 = device_memory_gauges):
        per_dev = (peak_flops if peak_flops is not None
                   else device_peak_flops(device))
        self.peak_flops = (per_dev * max(1, int(device_count))
                           if per_dev else None)
        self.round_flops: Optional[float] = None
        self.flops_source: Optional[str] = None
        self._memory_fn = memory_fn
        self._flops_probed = False
        self._flops_failed = False

    def probe_round_flops(self, thunk: Callable[[], float],
                          source: str = "analytic_flops") -> None:
        """Count the FLOPs of the round the next :meth:`derive` reads (a
        driver whose rounds differ in work calls it every round). A
        failure warns and omits MFU from then on (latched: it is not
        retried) — perf accounting never takes down a round loop."""
        if self._flops_failed:
            return
        try:
            flops = float(thunk())
        except Exception:  # degrade contract: a failed probe omits mfu
            logging.warning("perf accounting: round-FLOP probe failed — "
                            "mfu omitted from perf records", exc_info=True)
            self._flops_failed = True
            self.round_flops = self.flops_source = None
            return
        if flops == flops and flops > 0:
            self.set_round_flops(flops, source)

    def probe_flops_once(self, thunk: Callable[[], float],
                         source: str = "analytic_flops") -> None:
        """The JAX package's one-shot probe (every round bills the same
        work): :meth:`probe_round_flops` on the first call only."""
        if not self._flops_probed:
            self._flops_probed = True
            self.probe_round_flops(thunk, source)

    def set_round_flops(self, flops: float, source: str) -> None:
        """Pin the round FLOP count directly (replaces any probed value)."""
        self.round_flops = float(flops)
        self.flops_source = source

    def derive(self, round_rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        memory = None
        if self._memory_fn is not None:
            try:
                memory = self._memory_fn()
            except Exception:  # degrade contract: gauges omitted
                memory = None
        return derive_perf_record(round_rec,
                                  round_flops=self.round_flops,
                                  flops_source=self.flops_source,
                                  peak_flops=self.peak_flops,
                                  memory=memory)
