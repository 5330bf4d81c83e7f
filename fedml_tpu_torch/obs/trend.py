"""Bench trend ledger: continuous performance regression tracking (the
port's copy of ``fedml_tpu/obs/trend.py``, stdlib only).

A write-once run artifact lets a 2x rounds/sec regression between two
bench invocations ship silently because nothing compares them. This
module keeps an append-only trajectory, ``runs/trends.jsonl``: one
compact row per measured stage, keyed by ``(stage, host_fingerprint)`` so
a CPU smoke never gates against a card's capture, and a check that
compares each new row against the TRAILING MEDIAN of its key:

- ``rounds_per_sec`` dropping more than ``max_rps_drop`` (default 30%)
  below the median is a regression;
- ``bytes_per_round`` growing more than ``max_bytes_x`` (default 1.5x)
  over the median is a regression (the wire dimension: on a WAN-bound
  deployment bytes/round IS the round rate);
- the first row of a key always passes: the ledger has to start
  somewhere, and a fresh host/stage has no trend to regress against.

Medians, not latest-vs-previous: one noisy capture must neither gate
the next run nor poison the baseline. Writers append a complete line +
flush (the flight-log discipline: readers skip a torn final line).
``python -m fedml_tpu_torch.obs trend`` is the standalone
inspector/gate. Rows written by either package read the same.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import time
from typing import Any, Dict, List, Optional

TREND_SCHEMA_VERSION = 1

#: default gate thresholds (flag-tunable everywhere they are applied)
DEFAULT_MAX_RPS_DROP = 0.30
DEFAULT_MAX_BYTES_X = 1.5
#: trailing rows per key feeding the median
DEFAULT_WINDOW = 8


def _median(values) -> Optional[float]:
    """Median over the non-None values (None when none) — shared by the
    gate and the inspector so their baselines can never diverge."""
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


def host_fingerprint(host_tag: Optional[str] = None) -> str:
    """Stable identity of the measuring substrate: OS, arch, core
    count, plus the caller's host tag (``cpu-smoke`` vs
    ``gpu:<name>``: the same number on different silicon is not a
    trend). A short hash, so the ledger rows stay compact."""
    parts = [platform.system(), platform.machine(),
             str(os.cpu_count() or 0)]
    if host_tag:
        parts.append(str(host_tag))
    raw = "|".join(parts)
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def load_rows(path: str) -> List[Dict[str, Any]]:
    """Ledger rows in file order; a torn final line (a killed writer)
    is skipped with a warning, like every jsonl reader here."""
    rows: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    logging.warning("trend ledger %s: skipping torn "
                                    "line %r", path, line[:80])
    except OSError:
        return []
    return rows


def make_row(stage: str, metrics: Dict[str, Any], *,
             host_tag: Optional[str] = None,
             run_id: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One compact ledger row. ``metrics`` carries the gated figures
    (``rounds_per_sec`` and/or ``bytes_per_round``); anything else
    rides in ``extra`` for inspection, never gating."""
    row: Dict[str, Any] = {
        "schema_version": TREND_SCHEMA_VERSION,
        "t_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "stage": str(stage),
        "host_fingerprint": host_fingerprint(host_tag),
    }
    if host_tag:
        row["host"] = str(host_tag)
    if run_id:
        row["run_id"] = str(run_id)
    for key in ("rounds_per_sec", "bytes_per_round"):
        v = metrics.get(key)
        if v is not None:
            row[key] = float(v)
    if extra:
        row["extra"] = extra
    return row


def append_row(path: str, row: Dict[str, Any]) -> None:
    """Durably append one row (complete line + flush; parent dir
    created). Never raises — the trend ledger is an observer, a full
    disk must not fail a bench or a test session."""
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
            f.flush()
    except (OSError, TypeError, ValueError):
        logging.warning("trend ledger append to %s failed — row dropped",
                        path, exc_info=True)


def check_row(prior_rows: List[Dict[str, Any]], row: Dict[str, Any], *,
              max_rps_drop: float = DEFAULT_MAX_RPS_DROP,
              max_bytes_x: float = DEFAULT_MAX_BYTES_X,
              window: int = DEFAULT_WINDOW) -> List[str]:
    """Regression descriptions for ``row`` against the trailing median
    of its ``(stage, host_fingerprint)`` key inside ``prior_rows``
    (empty list = pass). The first-ever row of a key always passes."""
    key = (row.get("stage"), row.get("host_fingerprint"))
    history = [r for r in prior_rows
               if (r.get("stage"), r.get("host_fingerprint")) == key]
    history = history[-max(1, int(window)):]
    problems: List[str] = []
    rps = row.get("rounds_per_sec")
    med_rps = _median([r.get("rounds_per_sec") for r in history])
    if rps is not None and med_rps is not None and med_rps > 0:
        floor = med_rps * (1.0 - max_rps_drop)
        if rps < floor:
            problems.append(
                f"{row.get('stage')}: rounds_per_sec {rps:.4g} fell "
                f"below {floor:.4g} (trailing median {med_rps:.4g} over "
                f"{len(history)} rows, max drop "
                f"{max_rps_drop:.0%})")
    bpr = row.get("bytes_per_round")
    med_bpr = _median([r.get("bytes_per_round") for r in history])
    if bpr is not None and med_bpr is not None and med_bpr > 0:
        ceil = med_bpr * max_bytes_x
        if bpr > ceil:
            problems.append(
                f"{row.get('stage')}: bytes_per_round {bpr:.4g} exceeded "
                f"{ceil:.4g} (trailing median {med_bpr:.4g} over "
                f"{len(history)} rows, max growth {max_bytes_x:g}x)")
    return problems


def check_latest(path: str, *, stage: Optional[str] = None,
                 max_rps_drop: float = DEFAULT_MAX_RPS_DROP,
                 max_bytes_x: float = DEFAULT_MAX_BYTES_X,
                 window: int = DEFAULT_WINDOW,
                 rows: Optional[List[Dict[str, Any]]] = None
                 ) -> List[str]:
    """Check the NEWEST row of every ``(stage, host_fingerprint)`` key
    in the ledger (optionally one stage) against its own trailing
    history — the CI gate: after a run appends its rows, any key whose
    latest row regressed is reported. ``rows`` reuses an already-loaded
    ledger (one read, one consistent snapshot)."""
    rows = load_rows(path) if rows is None else list(rows)
    if stage is not None:
        rows = [r for r in rows if r.get("stage") == stage]
    latest: Dict[Any, int] = {}
    for i, r in enumerate(rows):
        latest[(r.get("stage"), r.get("host_fingerprint"))] = i
    problems: List[str] = []
    for key, idx in sorted(latest.items(), key=lambda kv: str(kv[0])):
        problems.extend(check_row(rows[:idx], rows[idx],
                                  max_rps_drop=max_rps_drop,
                                  max_bytes_x=max_bytes_x,
                                  window=window))
    return problems


def summarize_ledger(path: str,
                     rows: Optional[List[Dict[str, Any]]] = None
                     ) -> List[Dict[str, Any]]:
    """Per-key inspection rows: count, median/latest rounds_per_sec and
    bytes_per_round — what ``obs trend`` prints without ``--check``.
    ``rows`` reuses an already-loaded ledger."""
    rows = load_rows(path) if rows is None else list(rows)
    by_key: Dict[Any, List[Dict[str, Any]]] = {}
    for r in rows:
        by_key.setdefault((r.get("stage"), r.get("host_fingerprint")),
                          []).append(r)
    out = []
    for (stage, fp), group in sorted(by_key.items(),
                                     key=lambda kv: str(kv[0])):
        out.append({
            "stage": stage,
            "host_fingerprint": fp,
            "host": group[-1].get("host"),
            "rows": len(group),
            "rounds_per_sec_median": _median(
                [r.get("rounds_per_sec") for r in group]),
            "rounds_per_sec_latest": group[-1].get("rounds_per_sec"),
            "bytes_per_round_median": _median(
                [r.get("bytes_per_round") for r in group]),
            "bytes_per_round_latest": group[-1].get("bytes_per_round"),
            "latest_t_utc": group[-1].get("t_utc"),
        })
    return out
