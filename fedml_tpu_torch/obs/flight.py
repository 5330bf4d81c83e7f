"""The federation flight recorder: an append-only, crash-tolerant
per-process telemetry log (the port's copy of ``fedml_tpu/obs/flight.py``;
the file format is the JAX package's byte for byte, so either package
reads the other's logs).

Every process in a federation (server rank 0, each silo rank) writes one
``flight_rank<rank>.jsonl`` next to the control-plane ledger: one JSON
line per record, stamped with the cross-process correlation identity
``(job_id, rank, epoch, seq)``. ``epoch`` reuses the reliable
transport's per-endpoint-incarnation stream epoch (``comm/base.py``
``WIRE_SEQ_KEY``): a restarted silo's flight records carry a NEW epoch,
so the merge tool can tell its two lives apart exactly as the dedup
layer tells their frames apart.

Durability discipline (the same family as the control-plane ledger and
the state store):

- **atomic line writes** — a record is one ``write()`` of a complete
  line, flushed; ``round``/``anomaly`` records (the crash oracle's
  input) are additionally fsynced with a GROUP COMMIT (every
  ``fsync_lines`` sync-worthy records or ``fsync_ms`` milliseconds,
  whichever first, plus flush-on-close — the same batching the
  control-plane ledger uses), while high-rate silo digest rows ride the
  page cache so the receive thread never pays a disk sync per
  heartbeat. A kill mid-write leaves at most one torn FINAL line,
  which the reader skips exactly like the ledger reader;
- **keep_last_n rotation** — when the live file reaches
  ``rotate_lines`` records it is sealed via ``os.replace`` into a
  numbered segment (``flight_rank0.000001.jsonl``) and segments beyond
  ``keep_last_n`` are swept in sorted order, so the recorder is bounded
  on disk no matter how long the schedule runs;
- **never load-bearing** — every write path swallows ``OSError`` with a
  logged warning: observability must be a pure observer, a full disk
  cannot kill a round loop.

Record kinds written by the wiring (unknown kinds round-trip freely):

- ``round``   — a per-round snapshot-delta from ``RoundTimer.end_round``
  (phases/counters/gauges for exactly that round, plus driver extras:
  the cross-silo server adds cohort/reported/partial/evictions);
- ``silo``    — the server's per-silo row for a round, built from the
  compact counter digest piggybacked on replies/heartbeats plus the
  server-measured report latency;
- ``anomaly`` — a watchdog stall, slow round, or deadline extension
  (``obs/anomaly.py``), written when the one-shot profiler arms.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.utils.fsio import fsync_dir

#: bumped when the record layout changes incompatibly
FLIGHT_FORMAT = 1

_SEGMENT_RE = re.compile(r"^(?P<stem>flight_rank\d+)\.(?P<seq>\d{6})\.jsonl$")


class FlightRecorder:
    """One process's append-only flight log (thread-safe)."""

    def __init__(self, directory: str, *, job_id: str = "job",
                 rank: int = 0, epoch: Optional[int] = None,
                 rotate_lines: int = 20000, keep_last_n: int = 4,
                 fsync_lines: int = 8, fsync_ms: float = 50.0):
        import threading
        self.directory = str(directory)
        self.job_id = str(job_id)
        self.rank = int(rank)
        self.epoch = int(epoch) if epoch is not None else None
        self.rotate_lines = max(1, int(rotate_lines))
        self.keep_last_n = max(1, int(keep_last_n))
        #: group-commit cadence for the sync-worthy (round/anomaly)
        #: records: 1/0 = the legacy fsync-per-record
        self.fsync_lines = max(1, int(fsync_lines))
        self.fsync_ms = float(fsync_ms)
        self._lock = threading.Lock()
        self._seq = 0
        self._lines = 0
        self._sync_pending = 0
        self._last_fsync = time.monotonic()
        self.fsync_batches = 0
        self._fsync_batches_popped = 0
        self._disabled = False
        #: persistent append handle — re-opening per record costs more
        #: than the record on the server's receive thread
        self._fh = None
        try:
            os.makedirs(self.directory, exist_ok=True)
            # resume the live file's line count (a restarted server keeps
            # appending to its previous life's log — the epoch stamp is
            # what separates the two lives for readers)
            if os.path.exists(self.path):
                with open(self.path, "rb") as f:
                    self._lines = sum(1 for _ in f)
        except OSError:
            logging.warning("flight recorder disabled: cannot open %s",
                            self.directory, exc_info=True)
            self._disabled = True

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"flight_rank{self.rank}.jsonl")

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Bind the transport endpoint's stream epoch once it exists
        (the comm manager is constructed after the recorder)."""
        if epoch is not None:
            self.epoch = int(epoch)

    # -- writing ------------------------------------------------------------
    def append(self, record: Dict[str, Any]) -> None:
        """Stamp and durably append one record. Never raises: a failed
        write warns and drops the record (pure-observer contract)."""
        if self._disabled:
            return
        with self._lock:
            self._seq += 1
            rec = {"format": FLIGHT_FORMAT, "job_id": self.job_id,
                   "rank": self.rank, "epoch": self.epoch,
                   "seq": self._seq,
                   "t_wall": round(time.time(), 3), **record}
            try:
                line = json.dumps(rec, default=_json_default)
            except (TypeError, ValueError):
                logging.warning("flight record not serializable — dropped",
                                exc_info=True)
                return
            try:
                # one write() of a complete line + flush: a kill
                # mid-write tears at most THIS line, never an earlier
                # one. fsync is reserved for the records the crash
                # oracle reads (round closes, anomalies) and GROUP
                # COMMITTED — every fsync_lines sync-worthy records or
                # fsync_ms ms, whichever first — so neither the round
                # thread nor the receive thread pays a disk sync per
                # record; the high-rate silo digest rows never fsync at
                # all.
                if self._fh is None:
                    self._fh = open(self.path, "a")
                self._fh.write(line + "\n")
                self._fh.flush()
                if record.get("kind") in ("round", "anomaly"):
                    self._sync_pending += 1
                    now = time.monotonic()
                    due = (self._sync_pending >= self.fsync_lines
                           or (self.fsync_ms > 0.0
                               and (now - self._last_fsync) * 1e3
                               >= self.fsync_ms))
                    if due:
                        os.fsync(self._fh.fileno())
                        self.fsync_batches += 1
                        self._sync_pending = 0
                        self._last_fsync = now
                self._lines += 1
                if self._lines >= self.rotate_lines:
                    self._rotate_locked()
            except OSError:
                logging.warning("flight append to %s failed — record "
                                "dropped", self.path, exc_info=True)

    def sync(self) -> None:
        """Force-fsync any pending sync-worthy records (the barrier the
        merge/scan tools may take before reading a live log; close()
        calls it implicitly). Never raises."""
        with self._lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        if self._fh is None or not self._sync_pending:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.fsync_batches += 1
            self._sync_pending = 0
            self._last_fsync = time.monotonic()
        except OSError:
            logging.warning("flight sync of %s failed", self.path,
                            exc_info=True)

    def pop_fsync_batches(self) -> int:
        """Group-commit fsyncs since the last pop (the server credits
        this into the ``obs_fsync_batches`` counter at round close)."""
        with self._lock:
            delta = self.fsync_batches - self._fsync_batches_popped
            self._fsync_batches_popped = self.fsync_batches
            return delta

    def close(self) -> None:
        """Flush-on-close (sync any pending group-commit tail) and
        release the append handle (tests and short-lived tools; the
        long-running recorders just hold it for the process lifetime)."""
        with self._lock:
            self._sync_locked()
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def _rotate_locked(self) -> None:
        """Seal the live file into the next numbered segment
        (``os.replace`` — atomic) and sweep segments beyond
        ``keep_last_n`` in sorted order."""
        if self._fh is not None:
            # the handle points at the file being sealed; sync the
            # group-commit tail INTO the segment first — a sealed
            # segment is immutable, its durability gap must not ride
            # until the next live-file fsync
            self._sync_locked()
            self._fh.close()
            self._fh = None
        stem = f"flight_rank{self.rank}"
        seqs = [int(m.group("seq"))
                for m in (_SEGMENT_RE.match(fn)
                          for fn in sorted(os.listdir(self.directory)))
                if m and m.group("stem") == stem]
        nxt = (max(seqs) + 1) if seqs else 1
        sealed = os.path.join(self.directory,
                              f"{stem}.{nxt:06d}.jsonl")
        os.replace(self.path, sealed)
        # the rename lives in the directory entry: without a dirfd fsync
        # a crash right after rotation can lose the sealed segment's
        # name (degrade-to-warning inside fsync_dir on filesystems that
        # refuse directory fsync)
        # rotation is rare (every rotate_lines records) and the recorder
        # lock is its own — never a round/receive-thread lock
        fsync_dir(self.directory)
        self._lines = 0
        keep = set(sorted(seqs + [nxt])[-self.keep_last_n:])
        for s in sorted(seqs):
            if s not in keep:
                try:
                    os.remove(os.path.join(self.directory,
                                           f"{stem}.{s:06d}.jsonl"))
                except FileNotFoundError:
                    pass


def _json_default(v):
    """Numpy scalars/arrays out of counter digests -> plain JSON."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    raise TypeError(f"not JSON serializable: {type(v).__name__}")


# -- reading ----------------------------------------------------------------
def read_flight_log(path: str) -> List[Dict[str, Any]]:
    """Records of ONE rank's flight log, rotated segments first (oldest
    to newest), then the live file. A torn final line — a kill mid-write
    — is skipped with a warning, exactly like the ledger reader."""
    live = Path(path)
    stem = live.name[:-len(".jsonl")]
    segs = []
    if live.parent.is_dir():
        for fn in sorted(os.listdir(live.parent)):
            m = _SEGMENT_RE.match(fn)
            if m and m.group("stem") == stem:
                segs.append(live.parent / fn)
    rows: List[Dict[str, Any]] = []
    for p in [*segs, live]:
        if not p.is_file():
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    logging.warning("flight log %s: skipping torn line %r",
                                    p, line[:80])
    return rows


def flight_log_paths(directory: str) -> List[str]:
    """One path per RANK under ``directory`` (sorted) — the merge
    tool's default input when handed a directory. A rank whose live
    file was rotated away (only sealed ``.NNNNNN.jsonl`` segments left,
    e.g. the final append landed exactly on a rotation boundary) is
    still listed by its live-file name: :func:`read_flight_log` folds
    the segments in whether or not the live file exists."""
    stems = set()
    for fn in sorted(os.listdir(directory)):
        if re.fullmatch(r"flight_rank\d+\.jsonl", fn):
            stems.add(fn[:-len(".jsonl")])
        else:
            m = _SEGMENT_RE.match(fn)
            if m:
                stems.add(m.group("stem"))
    return [os.path.join(directory, f"{stem}.jsonl")
            for stem in sorted(stems)]


def flight_scan_entries(directory: str):
    """``[(dir, log_paths)]`` for the directories actually holding
    ``directory``'s flight logs: the directory itself when it has logs
    of its own, PLUS any immediate subdirectory that does — ONE level,
    the federation scheduler's shared obs layout (``obs/job_<id>/`` per
    tenant). The single definition of that layout rule, shared by
    ``obs merge`` and ``obs tail`` so the two tools can never disagree
    about which tenants a shared dir contains — computed in ONE scan
    (the live tail re-discovers every poll interval). Both-and rather
    than either-or: a solo run pointed at the shared root must not
    silently hide the tenant subdirs (records are job-stamped;
    ``--job`` filters). Empty when nothing is found yet (a live tail
    keeps watching)."""
    entries = []
    try:
        own = flight_log_paths(directory)
        if own:
            entries.append((directory, own))
        subs = sorted(os.listdir(directory))
    except OSError:
        return entries
    for sub in subs:
        subdir = os.path.join(directory, sub)
        try:
            if os.path.isdir(subdir):
                sub_paths = flight_log_paths(subdir)
                if sub_paths:
                    entries.append((subdir, sub_paths))
        except OSError:
            # one tenant's dir vanishing mid-scan (a finished job being
            # cleaned up under a live tail) must not hide every OTHER
            # tenant's logs
            continue
    return entries
