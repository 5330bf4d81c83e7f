"""Live operator console: follow N flight logs and render a round table.

The port's copy of ``fedml_tpu/obs/tail.py``.

``python -m fedml_tpu_torch.obs tail <dir>`` follows every
``flight_rank<r>.jsonl`` under a directory *while the federation is
writing them*: each rank gets a :class:`LogFollower` that reads only
COMPLETE lines (a torn final line — the writer mid-``write()`` — stays
buffered until its newline lands, the same tolerance as the offline
reader), survives ``os.replace`` rotation by draining the sealed
segment through its still-open handle before reopening the fresh live
file (sealed-segment inodes are tracked so a segment is never read
twice), and picks up ranks that appear after the tail started (a silo
JOINing late writes its first record mid-tail).

The merge semantics are NOT reimplemented: the tailer accumulates
records per rank in file order and folds them through the exact
:func:`fedml_tpu_torch.obs.merge.fold_records` the offline ``obs merge``
tool uses, concatenated in the same sorted-stem order — so the reconstructed
table equals the ``obs merge`` ground truth by construction (pinned by
test). Rendering derives rounds/s, report-latency quantiles, MFU, wire
bytes, and the ``ft_*``/``cp_*`` counters from the folded rows;
anomalous rounds are flagged inline.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.obs.flight import _SEGMENT_RE, flight_scan_entries
from fedml_tpu_torch.obs.merge import fold_records



def _parse_lines(path: str, lines: List[str]) -> List[Dict[str, Any]]:
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            logging.warning("tail %s: skipping unparseable line %r",
                            path, line[:80])
    return out


class LogFollower:
    """Incremental reader of ONE rank's flight log (live file + its
    sealed rotation segments).

    Torn-final-line tolerant: only newline-terminated lines parse; the
    trailing fragment stays buffered until its newline lands. Rotation
    handling: while the handle is open, an ``os.replace`` seal leaves
    the handle pointing at the sealed segment — it is drained to EOF,
    its inode remembered, and the fresh live file opened; the
    whole-file segment catch-up (startup, or a seal that raced an
    open) skips any segment whose name or inode was already consumed,
    so no record is missed or double-read."""

    def __init__(self, path: str):
        self.path = str(path)
        self.directory = os.path.dirname(self.path) or "."
        self.stem = os.path.basename(self.path)[:-len(".jsonl")]
        self._fh = None
        self._ino: Optional[int] = None
        self._buf = ""
        self._seen_segment_names: set = set()
        self._seen_inos: set = set()

    # -- internals ----------------------------------------------------------
    def _segment_paths(self) -> List[str]:
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        return [os.path.join(self.directory, fn) for fn in names
                if (m := _SEGMENT_RE.match(fn))
                and m.group("stem") == self.stem]

    def _read_new_segments(self) -> List[Dict[str, Any]]:
        """Whole-file read of sealed segments this follower has neither
        file-read nor handle-drained (oldest first)."""
        out: List[Dict[str, Any]] = []
        for path in self._segment_paths():
            name = os.path.basename(path)
            if name in self._seen_segment_names:
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue  # swept by keep_last_n mid-listing
            if st.st_ino in self._seen_inos:
                # this segment IS a live file we drained through our
                # handle — mark its name consumed and RETIRE the inode
                # from the set (names are monotone and never recycled;
                # inodes are, and a stale entry would silently skip a
                # future segment that reuses it after a sweep)
                self._seen_segment_names.add(name)
                self._seen_inos.discard(st.st_ino)
                continue
            try:
                with open(path, "r") as f:
                    text = f.read()
            except OSError:
                continue
            self._seen_segment_names.add(name)
            lines = text.split("\n")
            if lines and lines[-1]:
                logging.warning("tail %s: dropping torn final line %r",
                                path, lines[-1][:80])
                lines = lines[:-1]
            out.extend(_parse_lines(path, lines))
        return out

    def poll(self) -> List[Dict[str, Any]]:
        """Every record appended since the last poll (possibly across a
        rotation), in file order."""
        out: List[Dict[str, Any]] = []
        while True:
            if self._fh is None:
                # catch up on segments sealed while we had no handle
                # (startup, or between a seal and the next live birth)
                out.extend(self._read_new_segments())
                try:
                    fh = open(self.path, "r")
                except OSError:
                    return out  # live file not born yet
                self._fh = fh
                self._ino = os.fstat(fh.fileno()).st_ino
                self._seen_inos.add(self._ino)
            chunk = self._fh.read()
            if chunk:
                self._buf += chunk
                *complete, self._buf = self._buf.split("\n")
                out.extend(_parse_lines(self.path, complete))
                continue  # drain to EOF before checking for rotation
            # at EOF: is the path still the file we hold open?
            try:
                st = os.stat(self.path)
            except OSError:
                st = None  # sealed; fresh live file not created yet
            if st is not None and st.st_ino == self._ino:
                return out  # still the live file — caught up
            # rotated: our handle was the sealed segment, fully drained
            # above (its inode is in _seen_inos, so the segment sweep
            # will not re-read it); a leftover fragment can only be a
            # torn line — the writer never seals mid-line
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
            if self._buf:
                logging.warning("tail %s: dropping torn line at rotation "
                                "%r", self.path, self._buf[:80])
                self._buf = ""
            # loop: sweep any missed segments and open the new live file

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


class TimelineTailer:
    """Follow every rank log in ``directory`` and fold the accumulated
    records into the live merged timeline.

    Retention is bounded: the console is a live view, not an archive —
    beyond ``max_records_per_rank`` the OLDEST records of a rank are
    dropped (with a one-time warning), so a week-long federation can't
    grow the tail's memory or its per-frame refold without bound. The
    table then covers the retained window, exactly as the recorder's
    own rotation bounds the on-disk log."""

    def __init__(self, directory: str, job_id: Optional[str] = None,
                 max_records_per_rank: int = 100_000):
        self.directory = str(directory)
        self.job_id = job_id
        self.max_records_per_rank = max(1, int(max_records_per_rank))
        self._trim_warned = False
        #: stem -> ordered record list (file order within the rank)
        self._records: Dict[str, List[Dict[str, Any]]] = {}
        self._followers: Dict[str, LogFollower] = {}

    def _discover(self) -> None:
        """Create a follower for every rank stem present (live file OR
        sealed segments — ``flight_log_paths`` lists a rank by its live
        name either way). The shared-obs-dir rule (the directory's own
        logs plus ONE level of ``obs/job_<id>/`` tenant subdirs) lives
        in :func:`flight_scan_entries` — the one definition merge and
        tail both follow, one scan per poll — so one tail follows every
        tenant of a multi-job run, or one with ``--job``. Stems are
        prefixed by subdir so two tenants' rank-0 logs stay distinct."""
        for d, log_paths in flight_scan_entries(self.directory):
            prefix = ("" if d == self.directory
                      else os.path.basename(d) + "/")
            for path in log_paths:
                key = prefix + os.path.basename(path)[:-len(".jsonl")]
                if key not in self._followers:
                    self._followers[key] = LogFollower(path)
                    self._records[key] = []

    def poll(self) -> int:
        """Drain every follower once; returns how many new records
        landed (0 = nothing changed, the render can be skipped)."""
        self._discover()
        new = 0
        for stem in sorted(self._followers):
            recs = self._followers[stem].poll()
            if recs:
                self._records[stem].extend(recs)
                new += len(recs)
            if len(self._records[stem]) > self.max_records_per_rank:
                if not self._trim_warned:
                    self._trim_warned = True
                    logging.warning(
                        "tail: retention cap reached (%d records/rank) "
                        "— the table now covers the newest window only",
                        self.max_records_per_rank)
                self._records[stem] = \
                    self._records[stem][-self.max_records_per_rank:]
        return new

    def records(self) -> List[Dict[str, Any]]:
        """Accumulated records concatenated rank-by-rank in sorted-stem
        order — the same stream order ``merge_flight_logs`` produces
        from the files, so the fold below is the merge ground truth."""
        out: List[Dict[str, Any]] = []
        for stem in sorted(self._records):
            out.extend(self._records[stem])
        return out

    def merged(self) -> Dict[str, Any]:
        """The live merged timeline — ``fold_records`` over the
        accumulated stream, identical to ``obs merge`` on the same
        directory."""
        return fold_records(self.records(), job_id=self.job_id)

    def close(self) -> None:
        for f in self._followers.values():
            f.close()


# -- rendering ---------------------------------------------------------------
_FT_FAMILIES = ("ft_", "cp_", "state_")


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0:
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}TB"


def _fmt(value, spec: str = "") -> str:
    if value is None:
        return "-"
    return format(value, spec)


def _quantile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = q * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


def round_table_rows(merged: Dict[str, Any],
                     last: Optional[int] = None) -> List[Dict[str, Any]]:
    """Flat per-round display rows from a merged timeline (the tail
    table's data model, shared with ``obs merge --format csv``)."""
    rows = []
    for row in merged["rounds"][-last:] if last else merged["rounds"]:
        srv = row.get("server") or {}
        perf = row.get("perf") or {}
        counters = srv.get("counters") or {}
        ft = {k: v for k, v in counters.items()
              if k.startswith(_FT_FAMILIES) and v}
        latencies = [s.get("report_latency_s")
                     for s in row.get("silo_reports", [])
                     if s.get("report_latency_s") is not None]
        rows.append({
            "round": row["round"],
            # disambiguates tenants in an unfiltered multi-job tail
            # (rows are per (job, round); round numbers repeat)
            "job_id": row.get("job_id"),
            "duration_s": srv.get("duration_s"),
            "cohort": len(srv.get("cohort") or []) or None,
            "reported": (len(srv["reported"])
                         if srv.get("reported") is not None else None),
            "partial": bool(srv.get("partial")),
            "mfu": perf.get("mfu"),
            "overlap_frac": perf.get("comm_compute_overlap_frac"),
            "wire_up_bps": perf.get("wire_bytes_per_sec_up"),
            "wire_down_bps": perf.get("wire_bytes_per_sec_down"),
            "bytes_up": counters.get("comm_bytes_up"),
            "bytes_down": counters.get("comm_bytes_down"),
            "report_latency_p50_s": _quantile(latencies, 0.5),
            "silo_reports": len(row.get("silo_reports", [])),
            "ft": ft,
            "anomalies": [a.get("reason")
                          for a in row.get("anomalies", [])],
        })
    return rows


def _window_rows(all_rows: List[Dict[str, Any]], job_ids,
                 last: int) -> List[Dict[str, Any]]:
    """The round rows the refreshing frame displays. Single-tenant: the
    newest ``last`` rows. Multi-tenant: the window is split evenly and
    each tenant contributes ITS newest rows — the timeline sorts by
    (job, round), so a global tail would pin the whole window to the
    lexicographically-last job while every other tenant's fresh rounds
    insert invisibly mid-list and the tail looks frozen for them."""
    if len(job_ids) <= 1:
        return all_rows[-last:]
    share = max(1, last // len(job_ids))
    window: List[Dict[str, Any]] = []
    for job in job_ids:  # merged job_ids are sorted
        rows = [r for r in all_rows if r.get("job_id") == job]
        window.extend(rows[-share:])
    return window


def render_table(merged: Dict[str, Any], last: int = 20) -> str:
    """The refreshing console frame: a header of derived aggregates
    over the whole timeline plus the newest ``last`` round rows (split
    evenly across tenants on a shared obs dir, with a job column)."""
    all_rows = round_table_rows(merged)
    durations = [r["duration_s"] for r in all_rows
                 if r["duration_s"] is not None]
    latencies = [r["report_latency_p50_s"] for r in all_rows
                 if r["report_latency_p50_s"] is not None]
    mfus = [r["mfu"] for r in all_rows if r["mfu"] is not None]
    n_anom = sum(len(r["anomalies"]) for r in all_rows)
    rps = (len(durations) / sum(durations)) if durations \
        and sum(durations) > 0 else None

    def _qfmt(values, q):
        v = _quantile(values, q)
        return f"{v:.3f}s" if v is not None else "-"

    head = [
        "jobs: " + (", ".join(merged["job_ids"]) or "-")
        + f"   rounds: {len(all_rows)}   anomalies: {n_anom}",
        "rounds/s: " + _fmt(rps, ".3f")
        + f"   round p50/p90: {_qfmt(durations, 0.5)}/"
        + _qfmt(durations, 0.9)
        + f"   report p50/p90: {_qfmt(latencies, 0.5)}/"
        + _qfmt(latencies, 0.9)
        + ("   mfu(mean): " + f"{sum(mfus) / len(mfus):.4f}"
           if mfus else ""),
    ]
    multi_job = len(merged["job_ids"]) > 1
    job_w = (max(3, max(len(str(j)) for j in merged["job_ids"]))
             if multi_job else 0)
    job_col = f"{'job':>{job_w}} " if multi_job else ""
    cols = (f"{job_col}{'rnd':>5} {'dur_s':>8} {'coh':>4} {'rep':>4} "
            f"{'part':>4} {'mfu':>7} {'ovl':>5} {'up/s':>9} {'down/s':>9} "
            f"{'ft/cp':<22} anomalies")
    lines = head + ["-" * len(cols), cols]
    for r in _window_rows(all_rows, merged["job_ids"], last):
        ft = ",".join(f"{k.replace('ft_', '').replace('cp_', '')}={v}"
                      for k, v in sorted(r["ft"].items())) or "-"
        anom = ",".join(a for a in r["anomalies"] if a)
        lines.append(
            (f"{str(r['job_id']):>{job_w}} " if multi_job else "")
            + f"{r['round']:>5} "
            f"{_fmt(r['duration_s'], '.3f'):>8} "
            f"{_fmt(r['cohort']):>4} "
            f"{_fmt(r['reported']):>4} "
            f"{'yes' if r['partial'] else '-':>4} "
            f"{_fmt(r['mfu'], '.4f'):>7} "
            f"{_fmt(r['overlap_frac'], '.2f'):>5} "
            f"{_fmt_bytes(r['wire_up_bps']):>9} "
            f"{_fmt_bytes(r['wire_down_bps']):>9} "
            f"{ft:<22.22}"
            + (f" !! {anom}" if anom else ""))
    return "\n".join(lines)


def tail_command(directory: str, *, job_id: Optional[str] = None,
                 interval_s: float = 0.5,
                 max_seconds: Optional[float] = None,
                 once: bool = False, last: int = 20,
                 out=None) -> int:
    """The ``obs tail`` loop: poll + re-render until interrupted (or
    ``--max-seconds``/``--once`` for scripted runs). Returns 0 once any
    record rendered; 2 when the directory never produced one."""
    out = out if out is not None else sys.stdout
    tailer = TimelineTailer(directory, job_id=job_id)
    t0 = time.monotonic()
    is_tty = hasattr(out, "isatty") and out.isatty()
    saw_any = False
    try:
        while True:
            changed = tailer.poll()
            if changed or not saw_any:
                merged = tailer.merged()
                saw_any = saw_any or bool(tailer.records())
                frame = render_table(merged, last=last)
                if is_tty:
                    out.write("\x1b[2J\x1b[H" + frame + "\n")
                else:
                    out.write(frame + "\n")
                out.flush()
            if once:
                break
            elapsed = time.monotonic() - t0
            # an interactive console budget: the wall clock is the
            # contract (nothing downstream reads it)
            if max_seconds is not None and elapsed >= max_seconds:
                break
            time.sleep(interval_s)
    except KeyboardInterrupt:
        pass
    finally:
        tailer.close()
    return 0 if saw_any else 2
