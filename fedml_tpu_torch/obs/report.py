"""Per-job performance report — the SLO/billing artifact.

The port's copy of ``fedml_tpu/obs/report.py``.

``python -m fedml_tpu_torch.obs report <dir>`` folds a flight-log directory
(or an already-merged timeline) into ONE summary per ``job_id``:
round-time distribution, rounds/s, report-latency quantiles, MFU trend
(first-half vs second-half mean — is the job speeding up or
degrading?), wire byte totals, the eviction/retry/checkpoint counter
roll-up, and an anomaly index. This is the per-job artifact the
multi-job tenancy ROADMAP item consumes as-is: one federation cluster,
N tenants, one report each — latency quantiles are the SLO half,
wire/compute totals are the billing half.

Emitted as JSON (machine-readable, default) or markdown (review-ready).
All derivation is a pure function of the merged timeline, so the
report equals what ``obs merge`` + hand-arithmetic would give.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from fedml_tpu_torch.obs.tail import _quantile, round_table_rows

#: counter families rolled up into the report (everything else a round
#: record carries still lands under ``counters_total``)
_ROLLUP_PREFIXES = ("ft_", "cp_", "state_", "obs_", "comm_",
                    "prefetch_", "serve_")


def _dist(values: List[float]) -> Optional[Dict[str, float]]:
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return {
        "p50": round(_quantile(vals, 0.5), 6),
        "p90": round(_quantile(vals, 0.9), 6),
        "mean": round(sum(vals) / len(vals), 6),
        "max": round(max(vals), 6),
    }


def _mfu_trend(mfus: List[float]) -> Optional[Dict[str, Any]]:
    vals = [v for v in mfus if v is not None]
    if not vals:
        return None
    half = len(vals) // 2
    first = vals[:half] or vals
    second = vals[half:] or vals
    fm = sum(first) / len(first)
    sm = sum(second) / len(second)
    # 5% relative movement before calling a direction — measurement noise
    # must not read as a performance verdict
    if sm > fm * 1.05:
        direction = "improving"
    elif sm < fm * 0.95:
        direction = "degrading"
    else:
        direction = "flat"
    return {
        "mean": round(sum(vals) / len(vals), 6),
        "min": round(min(vals), 6),
        "max": round(max(vals), 6),
        "first_half_mean": round(fm, 6),
        "second_half_mean": round(sm, 6),
        "trend": direction,
    }


def _serving_section(rounds: List[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    """The serving tier's SLO summary, folded from the ``serve`` flight
    records the merge keyed per round (the serving tier): cumulative
    request/batch/shed counts from the NEWEST slo snapshot (they are
    cumulative by construction), latency p50/p99 from the same row,
    swap-cost distribution over every swap record, and the staleness
    distribution across swaps. None when the job never served."""
    slo_rows: List[Dict[str, Any]] = []
    swap_rows: List[Dict[str, Any]] = []
    for row in rounds:
        for rec in row.get("serve", []):
            if rec.get("event") == "slo":
                slo_rows.append(rec)
            elif rec.get("event") == "swap":
                swap_rows.append(rec)
    if not slo_rows and not swap_rows:
        return None
    slo_rows.sort(key=lambda r: (r.get("t_wall", 0), r.get("seq", 0)))
    latest = slo_rows[-1] if slo_rows else {}
    swap_ms = [r.get("swap_ms") for r in swap_rows
               if r.get("swap_ms") is not None]
    staleness = [r.get("staleness") for r in slo_rows
                 if r.get("staleness") is not None]
    requests = latest.get("requests", 0)
    p50 = latest.get("latency_p50_ms")
    p99 = latest.get("latency_p99_ms")
    # request rate over the serving window (first serve record to the
    # newest slo snapshot) — None when the window is a single instant
    walls = [r.get("t_wall") for r in (slo_rows + swap_rows)
             if r.get("t_wall") is not None]
    window = (max(walls) - min(walls)) if len(walls) > 1 else 0.0
    rate = (round(requests / window, 2) if window > 0 and requests
            else None)
    return {
        "requests": int(requests),
        "requests_per_sec": rate,
        "batches": int(latest.get("batches", 0)),
        "shed": int(latest.get("shed", 0)),
        "latency_p50_ms": p50,
        "latency_p99_ms": p99,
        "swaps": len(swap_rows),
        # the FIRST swap carries the one-off bucket warmup; the swap
        # records themselves already exclude it (endpoint.install)
        "swap_ms": _dist([float(v) for v in swap_ms]),
        "served_round": latest.get("served_round"),
        "staleness": {
            "max": max(staleness) if staleness else 0,
            "values": sorted({int(s) for s in staleness}),
        } if staleness else None,
    }


def _availability_section(rounds: List[Dict[str, Any]]
                          ) -> Optional[Dict[str, Any]]:
    """The churn/availability summary, folded from the server round
    records' existing fields (live set, cumulative eviction/rejoin/
    throttle counters, the per-round deadline, the WAN availability
    fraction): live-set size timeline, per-round eviction/rejoin
    deltas, admission throttles, and the steered-deadline trajectory.
    None when the job never ran the fault-tolerant path (no record
    carries a live set)."""
    live_sizes: List[int] = []
    evict_deltas: List[int] = []
    rejoin_deltas: List[int] = []
    throttle_deltas: List[int] = []
    deadlines: List[float] = []
    wan_fracs: List[float] = []
    prev_ev = prev_rj = prev_th = 0
    saw_live = False
    for row in rounds:
        srv = row.get("server") or {}
        live = srv.get("live")
        if live is None:
            continue
        saw_live = True
        live_sizes.append(len(live))
        ev = int(srv.get("evictions") or 0)
        rj = int(srv.get("rejoins") or 0)
        th = int(srv.get("joins_throttled") or 0)
        evict_deltas.append(max(0, ev - prev_ev))
        rejoin_deltas.append(max(0, rj - prev_rj))
        throttle_deltas.append(max(0, th - prev_th))
        prev_ev, prev_rj, prev_th = ev, rj, th
        if srv.get("deadline_s") is not None:
            deadlines.append(float(srv["deadline_s"]))
        if srv.get("wan_available_frac") is not None:
            wan_fracs.append(float(srv["wan_available_frac"]))
    if not saw_live:
        return None
    out: Dict[str, Any] = {
        "live_set": {
            "first": live_sizes[0],
            "min": min(live_sizes),
            "last": live_sizes[-1],
            "series": live_sizes,
        },
        "evictions": sum(evict_deltas),
        "rejoins": sum(rejoin_deltas),
        "admission_throttles": sum(throttle_deltas),
        "evictions_per_round": evict_deltas,
        "rejoins_per_round": rejoin_deltas,
    }
    if deadlines:
        out["deadline_s"] = {
            "first": round(deadlines[0], 6),
            "last": round(deadlines[-1], 6),
            "min": round(min(deadlines), 6),
            "max": round(max(deadlines), 6),
            "series": [round(d, 6) for d in deadlines],
        }
    if wan_fracs:
        out["wan_available_frac"] = {
            "min": round(min(wan_fracs), 4),
            "max": round(max(wan_fracs), 4),
            "series": wan_fracs,
        }
    return out


def summarize_job(merged: Dict[str, Any], job_id: str) -> Dict[str, Any]:
    """One job's summary from that job's OWN merged timeline (the
    caller merges per job — round rows are keyed by round index, so two
    jobs' round 0 must never share a fold)."""
    rounds = merged["rounds"]
    table = round_table_rows(merged)
    durations = [r["duration_s"] for r in table
                 if r["duration_s"] is not None]
    latencies = [s.get("report_latency_s")
                 for row in rounds for s in row.get("silo_reports", [])
                 if s.get("report_latency_s") is not None]
    bytes_up = sum(r["bytes_up"] or 0 for r in table)
    bytes_down = sum(r["bytes_down"] or 0 for r in table)
    counters_total: Dict[str, int] = {}
    for row in rounds:
        srv = row.get("server") or {}
        for k, v in (srv.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters_total[k] = counters_total.get(k, 0) + v
    rollup = {k: v for k, v in sorted(counters_total.items())
              if k.startswith(_ROLLUP_PREFIXES)}
    anomalies = [{"round": a.get("round"), "reason": a.get("reason"),
                  "detail": a.get("detail")}
                 for a in merged.get("anomalies", [])]
    n_rounds = len([r for r in table if r["duration_s"] is not None])
    epochs = sorted({rec.get("epoch")
                     for row in rounds
                     for rec in [row.get("server")] if rec} - {None})
    return {
        "job_id": job_id,
        "rounds": len(table),
        "first_round": table[0]["round"] if table else None,
        "last_round": table[-1]["round"] if table else None,
        "server_epochs": epochs,
        "partial_rounds": sum(1 for r in table if r["partial"]),
        "round_time_s": _dist(durations),
        "rounds_per_sec": (round(n_rounds / sum(durations), 4)
                           if durations and sum(durations) > 0 else None),
        "report_latency_s": _dist(latencies),
        "mfu": _mfu_trend([r["mfu"] for r in table]),
        "wire": {
            "bytes_up": bytes_up,
            "bytes_down": bytes_down,
            "bytes_per_round": (round((bytes_up + bytes_down)
                                      / len(table), 1) if table else None),
        },
        "counters": rollup,
        "availability": _availability_section(rounds),
        "serving": _serving_section(rounds),
        "anomaly_count": len(anomalies),
        "anomalies": anomalies,
    }


def summarize(inputs, job_id: Optional[str] = None) -> Dict[str, Any]:
    """Per-job summaries from flight-log paths/directories. Returns
    ``{"jobs": {job_id: summary, ...}}`` (restricted to one job when
    ``job_id`` is given). The logs are read ONCE and folded per job, so
    a directory shared by several jobs reports them independently; a
    ``job_id`` no record carries yields an empty ``jobs`` map (the CLI's
    exit-2 input error), never a vacuous zero-round summary."""
    from fedml_tpu_torch.obs.flight import read_flight_log
    from fedml_tpu_torch.obs.merge import _resolve_paths, fold_records
    records: List[Dict[str, Any]] = []
    for path in _resolve_paths(inputs):
        records.extend(read_flight_log(path))
    jobs = sorted({str(r.get("job_id")) for r in records
                   if r.get("job_id") is not None})
    if job_id is not None:
        jobs = [j for j in jobs if j == job_id]
    return {"jobs": {j: summarize_job(fold_records(records, job_id=j), j)
                     for j in jobs}}


def to_markdown(report: Dict[str, Any]) -> str:
    """The review-ready rendering: one section per job."""
    lines: List[str] = []
    for job_id, s in sorted(report["jobs"].items()):
        lines.append(f"## job `{job_id}`")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        rt = s.get("round_time_s") or {}
        rl = s.get("report_latency_s") or {}
        mfu = s.get("mfu") or {}
        wire = s.get("wire") or {}
        rows = [
            ("rounds", f"{s['rounds']} "
                       f"(r{s['first_round']}..r{s['last_round']}, "
                       f"{s['partial_rounds']} partial)"),
            ("server epochs", ", ".join(str(e)
                                        for e in s["server_epochs"])
             or "-"),
            ("rounds/s", s.get("rounds_per_sec")),
            ("round time p50/p90/max (s)",
             "/".join(str(rt.get(k, "-"))
                      for k in ("p50", "p90", "max")) if rt else "-"),
            ("report latency p50/p90 (s)",
             "/".join(str(rl.get(k, "-"))
                      for k in ("p50", "p90")) if rl else "-"),
            ("MFU mean (trend)",
             (f"{mfu.get('mean')} ({mfu.get('trend')}: "
              f"{mfu.get('first_half_mean')} -> "
              f"{mfu.get('second_half_mean')})") if mfu else "-"),
            ("wire bytes up/down",
             f"{wire.get('bytes_up', 0)}/{wire.get('bytes_down', 0)} "
             f"({wire.get('bytes_per_round')} B/round)"),
            ("anomalies", s.get("anomaly_count", 0)),
        ]
        avail = s.get("availability")
        if avail:
            ls = avail.get("live_set") or {}
            rows.append(("live set (first/min/last)",
                         f"{ls.get('first', '-')}/{ls.get('min', '-')}/"
                         f"{ls.get('last', '-')}"))
            rows.append(("evictions / rejoins / throttles",
                         f"{avail.get('evictions', 0)}/"
                         f"{avail.get('rejoins', 0)}/"
                         f"{avail.get('admission_throttles', 0)}"))
            dl = avail.get("deadline_s")
            if dl:
                rows.append(("steered deadline first->last (min..max s)",
                             f"{dl.get('first')} -> {dl.get('last')} "
                             f"({dl.get('min')}..{dl.get('max')})"))
            wf = avail.get("wan_available_frac")
            if wf:
                rows.append(("WAN availability (min..max)",
                             f"{wf.get('min')}..{wf.get('max')}"))
        serving = s.get("serving")
        if serving:
            sw = serving.get("swap_ms") or {}
            st = serving.get("staleness") or {}
            rows.extend([
                ("serving requests (rate)",
                 f"{serving['requests']} "
                 f"({serving.get('requests_per_sec') or '-'}/s, "
                 f"{serving['shed']} shed)"),
                ("serving latency p50/p99 (ms)",
                 f"{serving.get('latency_p50_ms', '-')}/"
                 f"{serving.get('latency_p99_ms', '-')}"),
                ("serving swaps (p50/max ms)",
                 f"{serving['swaps']} "
                 f"({sw.get('p50', '-')}/{sw.get('max', '-')})"),
                ("serving round (max staleness)",
                 f"r{serving.get('served_round')} "
                 f"({st.get('max', 0)} rounds)"),
            ])
        for name, value in rows:
            lines.append(f"| {name} | {value if value is not None else '-'}"
                         " |")
        counters = s.get("counters") or {}
        if counters:
            lines.append("")
            lines.append("counters: " + ", ".join(
                f"`{k}`={v}" for k, v in counters.items()))
        if s.get("anomalies"):
            lines.append("")
            lines.append("anomaly index:")
            for a in s["anomalies"]:
                lines.append(f"- round {a['round']}: {a['reason']}")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
