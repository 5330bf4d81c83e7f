"""Merge N per-process flight logs into one global round timeline (the
port's copy of ``fedml_tpu/obs/merge.py``).

Each federation process records its own view: the server's flight log
has the authoritative per-round rows (cohort, reported set, partial
flag, counter deltas) plus per-silo digest rows; every silo's log has
its local-train timings. The merge aligns them on ``(job_id, round)``
— the cross-process span identity all records carry — into one
timeline, and can cross-check the result against the control-plane
``ledger.jsonl`` (the durable schedule trace): for every round both
sides know, cohort / reported set / partial flag must agree exactly.

``python -m fedml_tpu_torch.obs merge <dir-or-logs...>`` is the CLI wrapper.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

from fedml_tpu_torch.obs.flight import flight_scan_entries, read_flight_log


def _resolve_paths(inputs: Sequence[str]) -> List[str]:
    """Expand directories to their flight logs. A directory's own logs
    AND one level of subdirectories are included
    (:func:`flight_scan_entries` — the federation scheduler's shared
    obs layout, ``obs/job_<id>/`` per tenant), so ``obs merge
    <shared-obs-dir> --job <id>`` inspects one tenant of a multi-job
    run without path archaeology."""
    paths: List[str] = []
    for p in inputs:
        if os.path.isdir(p):
            for _d, log_paths in flight_scan_entries(p):
                paths.extend(log_paths)
        else:
            paths.append(p)
    return sorted(set(paths))


def fold_records(records: Sequence[Dict[str, Any]],
                 job_id: Optional[str] = None) -> Dict[str, Any]:
    """The merge fold: N flight-log record streams (already read, in
    per-rank file order) -> one global timeline. Shared verbatim by the
    offline merge and the live tail (``obs/tail.py``), so the tail's
    reconstructed table IS the merge ground truth by construction."""
    if job_id is not None:
        records = [r for r in records if r.get("job_id") == job_id]
    job_ids = sorted({str(r.get("job_id")) for r in records})

    # rows are keyed per (job, round): N tenants sharing one obs dir
    # reuse the same round numbers, and an unfiltered merge must yield
    # N disjoint per-tenant timelines, not one blended row per number
    rounds: Dict[tuple, Dict[str, Any]] = {}
    anomalies: List[Dict[str, Any]] = []
    unmatched: List[Dict[str, Any]] = []

    def row(rec: Dict[str, Any], r: int) -> Dict[str, Any]:
        job = rec.get("job_id")
        return rounds.setdefault((str(job), int(r)), {
            "round": int(r), "job_id": job, "server": None, "perf": None,
            "silo_rounds": {}, "silo_reports": [], "serve": [],
            "anomalies": []})

    for rec in records:
        kind = rec.get("kind")
        r = rec.get("round")
        if r is None:
            unmatched.append(rec)
            continue
        if kind == "round":
            if rec.get("rank") == 0:
                prev = row(rec, r)["server"]
                # a failover re-close re-records the round: keep the
                # LAST occurrence, the same dedup rule the ledger
                # reader applies
                if prev is None or (rec.get("t_wall", 0)
                                    >= prev.get("t_wall", 0)):
                    row(rec, r)["server"] = rec
            else:
                row(rec, r)["silo_rounds"][int(rec["rank"])] = rec
        elif kind == "perf":
            # the round's derived roofline record (obs/perf.py) — same
            # keep-last rule as the server round row it derives from
            prev = row(rec, r)["perf"]
            if prev is None or (rec.get("t_wall", 0)
                                >= prev.get("t_wall", 0)):
                row(rec, r)["perf"] = rec
        elif kind == "serve":
            # serving-tier rows (swap / slo snapshots)
            # keyed on the SERVED round — obs report's serving section
            # folds exactly these, so live tail == offline report
            row(rec, r)["serve"].append(rec)
        elif kind == "silo":
            row(rec, r)["silo_reports"].append(rec)
        elif kind == "anomaly":
            row(rec, r)["anomalies"].append(rec)
            anomalies.append(rec)
        else:
            unmatched.append(rec)

    timeline = [rounds[k] for k in sorted(rounds)]
    return {"job_ids": job_ids, "rounds": timeline,
            "anomalies": anomalies, "unmatched": unmatched}


def merge_flight_logs(inputs: Sequence[str],
                      job_id: Optional[str] = None) -> Dict[str, Any]:
    """One global timeline from N flight logs (paths or directories).

    Returns ``{"job_ids": [...], "rounds": [...], "anomalies": [...],
    "unmatched": [...]}`` where each round row carries the server's
    ``round`` record (``server``), its derived roofline record
    (``perf``), every silo's own ``round`` record (``silo_rounds``,
    keyed by rank), and the server-side per-silo digest rows
    (``silo_reports``). ``job_id`` restricts the merge to one job when
    several share a directory."""
    records: List[Dict[str, Any]] = []
    for path in _resolve_paths(inputs):
        records.extend(read_flight_log(path))
    return fold_records(records, job_id=job_id)


def check_against_ledger(merged: Dict[str, Any],
                         ledger_rows: Iterable[Dict[str, Any]]
                         ) -> List[str]:
    """Mismatch descriptions (empty = the merged timeline agrees with
    the ledger). For every round present in BOTH, the server flight
    row's cohort, reported set, and partial flag must equal the
    ledger's; a ledger round with no server flight row is a gap (the
    flight log rotated past it, or observability was off for part of
    the run) and is reported as such."""
    ledger_rows = list(ledger_rows)
    by_round = {int(r["round"]): r for r in ledger_rows}
    flight_rows = merged["rounds"]
    # a ledger belongs to ONE job, but its rows carry no job_id — the
    # caller's --job filter (merge_flight_logs(job_id=...)) is the only
    # way to scope a multi-tenant merge to the ledger's tenant
    if len({row.get("job_id") for row in flight_rows}) > 1:
        # nothing identifies which tenant this ledger belongs to —
        # comparing it against a blended timeline would yield phantom
        # mismatches for every co-tenant round
        return ["merged timeline spans multiple jobs ("
                + ", ".join(merged.get("job_ids", [])) +
                ") and the ledger rows carry no job_id — re-run with "
                "--job <id> to scope the check to one tenant"]
    flight_by_round = {row["round"]: row["server"]
                       for row in flight_rows
                       if row.get("server") is not None}
    problems: List[str] = []
    for r in sorted(by_round):
        led = by_round[r]
        srv = flight_by_round.get(r)
        if srv is None:
            problems.append(f"round {r}: in ledger but no server flight "
                            "row")
            continue
        for key in ("cohort", "reported", "partial"):
            lv, fv = led.get(key), srv.get(key)
            if key == "partial":
                lv, fv = bool(lv), bool(fv)
            if lv != fv:
                problems.append(
                    f"round {r}: {key} mismatch — ledger {lv!r} vs "
                    f"flight {fv!r}")
    for r in sorted(flight_by_round):
        if r not in by_round:
            problems.append(f"round {r}: server flight row with no "
                            "ledger row")
    return problems
