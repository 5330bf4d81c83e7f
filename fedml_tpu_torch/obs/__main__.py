"""CLI: ``python -m fedml_tpu_torch.obs <command>``: the flight-deck tools
(the port's copy of ``fedml_tpu/obs/__main__.py``, same exit codes).

``merge`` — reconstruct one global round timeline from N flight logs::

    python -m fedml_tpu_torch.obs merge <dir-or-flight.jsonl ...> \
        [--ledger ledger.jsonl] [--output merged.json] [--job_id JOB] \
        [--format lines|json|csv]

Directories expand to every ``flight_rank*.jsonl`` inside (rotated
segments are folded in automatically). ``--ledger`` cross-checks the
merged per-round rows (cohort, reported set, partial flag) against the
control-plane ledger and exits 1 on any mismatch — the acceptance
oracle the chaos tests script. ``--output`` writes the merged timeline
as JSON; ``--format json`` (whole timeline) / ``csv`` (flat per-round
rows) emit machine-readable stdout for external tooling instead of the
default human-oriented ``lines``.

``tail`` — live console: follow the flight logs while the federation
writes them (rotation-aware, torn-line tolerant), re-rendering a
merged round table (rounds/s, latency quantiles, MFU, wire rates,
ft/cp counters, anomalies highlighted).

``report`` — per-job summary (round-time distribution, MFU trend, wire
bytes, eviction/retry totals, anomaly index) as JSON or markdown — the
per-job SLO/billing artifact.

``trend`` — inspect/gate a bench trend ledger (``runs/trends.jsonl``):
without flags prints per-key medians vs latest; ``--check-latest``
exits 1 when any key's newest row regressed beyond the thresholds.

``registry`` (alias ``metrics``): print the documented metric table
(markdown), with a column saying whether the port emits each metric or
which ROADMAP item brings it.

Exit codes (all subcommands): 0 = success / no regression; 1 = a check
failed (ledger mismatch, trend regression); 2 = usage or input error
(no flight logs found, unreadable ledger).
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from typing import List, Optional

_EXIT_CODES_EPILOG = (
    "exit codes: 0 = success / no regression; 1 = check failed "
    "(ledger mismatch, trend regression); 2 = usage or input error")


def _cmd_merge(args) -> int:
    from fedml_tpu_torch.obs.merge import (check_against_ledger,
                                           merge_flight_logs)
    from fedml_tpu_torch.obs.tail import round_table_rows
    merged = merge_flight_logs(args.inputs, job_id=args.job_id)
    if not merged["rounds"] and not merged["unmatched"]:
        # the documented input-error code: a typo'd directory (or a
        # job_id filter matching nothing) must not read as a clean merge
        print("no flight records found", file=sys.stderr)
        return 2
    problems: List[str] = []
    if args.ledger:
        rows = _read_ledger_file(args.ledger)
        problems = check_against_ledger(merged, rows)
        merged["ledger_check"] = {"ledger": args.ledger,
                                  "rounds_checked": len(rows),
                                  "mismatches": problems}
    if args.output:
        with open(args.output, "w") as f:
            json.dump(merged, f, indent=2)
        print(f"wrote merged timeline ({len(merged['rounds'])} rounds, "
              f"{len(merged['anomalies'])} anomalies) to {args.output}",
              file=sys.stderr)
    if args.format == "json":
        json.dump(merged, sys.stdout, indent=2)
        print()
    elif args.format == "csv":
        flat = round_table_rows(merged)
        cols = ["round", "job_id", "duration_s", "cohort", "reported",
                "partial",
                "mfu", "overlap_frac", "wire_up_bps", "wire_down_bps",
                "bytes_up", "bytes_down", "report_latency_p50_s",
                "silo_reports", "anomalies"]
        writer = csv.writer(sys.stdout)
        writer.writerow(cols)
        for row in flat:
            writer.writerow([
                ";".join(a for a in row["anomalies"] if a)
                if c == "anomalies" else row.get(c)
                for c in cols])
    elif not args.output:
        for row in merged["rounds"]:
            srv = row["server"] or {}
            perf = row.get("perf") or {}
            print(json.dumps({
                "round": row["round"],
                "cohort": srv.get("cohort"),
                "reported": srv.get("reported"),
                "partial": srv.get("partial"),
                "duration_s": srv.get("duration_s"),
                "mfu": perf.get("mfu"),
                "silo_reports": len(row["silo_reports"]),
                "silo_rounds": sorted(row["silo_rounds"]),
                "anomalies": [a.get("reason") for a in row["anomalies"]],
            }))
    for p in problems:
        print(f"LEDGER MISMATCH: {p}", file=sys.stderr)
    if args.ledger:
        print(f"ledger check: {len(problems)} mismatch(es) over "
              f"{merged['ledger_check']['rounds_checked']} ledger rounds",
              file=sys.stderr)
    return 1 if problems else 0


def _read_ledger_file(path: str):
    """Ledger rows with the standard dedup (last occurrence per round
    wins) and torn-line skip, without requiring the checkpoint dir."""
    import logging
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                logging.warning("ledger %s: skipping torn line %r", path,
                                line[:80])
    by_round = {int(r["round"]): r for r in rows}
    return [by_round[r] for r in sorted(by_round)]


def _cmd_tail(args) -> int:
    from fedml_tpu_torch.obs.tail import tail_command
    return tail_command(args.directory, job_id=args.job_id,
                        interval_s=args.interval,
                        max_seconds=args.max_seconds,
                        once=args.once, last=args.last)


def _cmd_report(args) -> int:
    from fedml_tpu_torch.obs.report import summarize, to_markdown
    report = summarize(args.inputs, job_id=args.job_id)
    if not report["jobs"]:
        print("no flight records found", file=sys.stderr)
        return 2
    if args.format == "markdown":
        out = to_markdown(report)
    else:
        out = json.dumps(report, indent=2) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"wrote report for {len(report['jobs'])} job(s) to "
              f"{args.output}", file=sys.stderr)
    else:
        sys.stdout.write(out)
    return 0


def _cmd_trend(args) -> int:
    from fedml_tpu_torch.obs import trend
    rows = trend.load_rows(args.ledger)
    if not rows:
        print(f"no trend rows in {args.ledger}", file=sys.stderr)
        # an absent/empty ledger is only an error when asked to GATE on
        # it: inspection of a not-yet-seeded trajectory is vacuously ok
        return 2 if args.check_latest and args.require_rows else 0
    if args.check_latest:
        # one read, one snapshot: the count printed below and the rows
        # actually gated can never disagree under a concurrent writer
        problems = trend.check_latest(args.ledger, stage=args.stage,
                                      max_rps_drop=args.max_rps_drop,
                                      max_bytes_x=args.max_bytes_x,
                                      window=args.window, rows=rows)
        for p in problems:
            print(f"TREND REGRESSION: {p}", file=sys.stderr)
        print(f"trend check: {len(problems)} regression(s) across "
              f"{len(rows)} ledger rows", file=sys.stderr)
        return 1 if problems else 0
    summary = trend.summarize_ledger(args.ledger, rows=rows)
    if args.stage is not None:
        summary = [s for s in summary if s["stage"] == args.stage]
    for s in summary:
        print(json.dumps(s))
    return 0


def _cmd_registry(_args) -> int:
    from fedml_tpu_torch.obs.registry import markdown_table
    print(markdown_table())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fedml_tpu_torch.obs",
        description="federation flight recorder tools",
        epilog=_EXIT_CODES_EPILOG)
    sub = parser.add_subparsers(dest="command", required=True)

    m = sub.add_parser("merge", help="merge N flight logs into one "
                                     "global round timeline",
                       epilog=_EXIT_CODES_EPILOG)
    m.add_argument("inputs", nargs="+",
                   help="flight log files and/or directories holding "
                        "flight_rank*.jsonl")
    m.add_argument("--ledger", type=str, default=None,
                   help="cross-check cohort/reported/partial against "
                        "this ledger.jsonl; exit 1 on mismatch")
    m.add_argument("--output", type=str, default=None,
                   help="write the merged timeline JSON here")
    m.add_argument("--job_id", "--job", type=str, default=None,
                   help="restrict the merge to one job id (tenant) — "
                        "with a scheduler-shared obs dir this is the "
                        "per-tenant inspection filter")
    m.add_argument("--format", choices=["lines", "json", "csv"],
                   default="lines",
                   help="stdout format: human per-round lines "
                        "(default), the whole merged timeline as JSON, "
                        "or flat per-round CSV for external tooling")
    m.set_defaults(fn=_cmd_merge)

    t = sub.add_parser("tail", help="live console: follow flight logs "
                                    "and render a merged round table",
                       epilog=_EXIT_CODES_EPILOG)
    t.add_argument("directory", help="obs directory being written by a "
                                     "live federation")
    t.add_argument("--job_id", "--job", type=str, default=None,
                   help="follow one tenant's records only")
    t.add_argument("--interval", type=float, default=0.5,
                   help="poll/render interval seconds (default 0.5)")
    t.add_argument("--max-seconds", type=float, default=None,
                   dest="max_seconds",
                   help="stop after this many seconds (scripted runs)")
    t.add_argument("--once", action="store_true",
                   help="render a single frame and exit")
    t.add_argument("--last", type=int, default=20,
                   help="round rows to show (default 20)")
    t.set_defaults(fn=_cmd_tail)

    r = sub.add_parser("report", help="per-job summary (SLO/billing "
                                      "artifact) as JSON or markdown",
                       epilog=_EXIT_CODES_EPILOG)
    r.add_argument("inputs", nargs="+",
                   help="flight log files and/or directories")
    r.add_argument("--job_id", "--job", type=str, default=None,
                   help="report one tenant only (default: every job "
                        "found in the inputs)")
    r.add_argument("--format", choices=["json", "markdown"],
                   default="json")
    r.add_argument("--output", type=str, default=None,
                   help="write the report here instead of stdout")
    r.set_defaults(fn=_cmd_report)

    tr = sub.add_parser("trend", help="inspect/gate the bench trend "
                                      "ledger (runs/trends.jsonl)",
                        epilog=_EXIT_CODES_EPILOG)
    tr.add_argument("ledger", nargs="?", default="runs/trends.jsonl",
                    help="trend ledger path (default runs/trends.jsonl)")
    tr.add_argument("--stage", type=str, default=None,
                    help="restrict to one stage")
    tr.add_argument("--check-latest", action="store_true",
                    dest="check_latest",
                    help="gate: exit 1 when any key's newest row "
                         "regressed vs its trailing median")
    tr.add_argument("--require-rows", action="store_true",
                    dest="require_rows",
                    help="with --check-latest, an empty/absent ledger "
                         "is an error (exit 2) instead of a pass")
    tr.add_argument("--max-rps-drop", type=float, default=0.30,
                    dest="max_rps_drop",
                    help="rounds/sec drop fraction vs median that "
                         "counts as regression (default 0.30)")
    tr.add_argument("--max-bytes-x", type=float, default=1.5,
                    dest="max_bytes_x",
                    help="bytes/round growth factor vs median that "
                         "counts as regression (default 1.5)")
    tr.add_argument("--window", type=int, default=8,
                    help="trailing rows per key feeding the median "
                         "(default 8)")
    tr.set_defaults(fn=_cmd_trend)

    g = sub.add_parser("registry", aliases=["metrics"],
                       help="print the documented metric table (markdown)")
    g.set_defaults(fn=_cmd_registry)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except OSError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
