"""Durable server control-plane snapshots and the round/cohort ledger (the
port's counterpart of ``fedml_tpu/control/checkpoint.py``).

:class:`ServerControlCheckpointer` stores the whole control state that
the cross-silo server captures (``_capture_control_state`` in
``algorithms/fedavg_cross_silo.py``; field manifest in
``control/manifest.py``) and gives it back on restart, so a killed and
restarted server resumes mid-schedule while the silos' own rejoin
protocol reconnects the fleet.

**The blob** (``state_<seq>.npz``, the port's own format): an
uncompressed zip whose first member, ``skeleton.json``, holds the state's
structure as JSON (the pending-reply dict, nested counters, ``None``s),
with every array replaced by ``{"__npy__": "<member>"}``; each array is a
``<field>/<i>.npy`` member, so f32 leaves keep their bits. Neither package
reads the other's blob. Beside each blob a ``state_<seq>.json`` sidecar
carries the round index, the format and the blob's sha256. Writes are
atomic (a temporary file, fsync, ``os.replace``; blob first, sidecar last,
then the directory fsync through ``utils/fsio.fsync_dir``): a crash at
any point leaves a complete older snapshot or a complete newer one. A
blob without its sidecar is invisible to :meth:`load_latest` and swept by
the ``keep_last_n`` GC with any stray temporary file. Each checkpointer
writes under its own temporary name (the process id and an instance
number), so an aborted writer and a second checkpointer of one process
never write one file.

**Incremental serialization** (:class:`IncrementalStateSerializer`):
``save(state, versions=...)`` caches each versioned field's skeleton
fragment and ``.npy`` members (with their CRC-32s) under the caller's
version token and a content sha256, and splices the zip from the cache
while the token is unchanged. The global model changes only at a close,
so a mid-round snapshot reuses its bytes. The splice must give the bytes
``zipfile`` writes for the same members; that is checked once a process,
and a mismatch falls back to ``zipfile`` for good.

**Asynchronous writes** (:class:`AsyncCheckpointWriter`): ``save``
becomes a hand-off to a writer thread behind a depth-1 slot (newest
wins). Before it publishes a snapshot the writer syncs the ledger, so a
crash only ever loses trailing state: restore lands on an older complete
boundary and the deterministic schedule replays forward (re-appended
ledger rows dedup by round). ``flush()`` is the barrier of the close, a
SIGTERM and the extension cap; ``abort()`` is the simulated SIGKILL of
the in-process failover harness: it drops the pending snapshot, and a
write in flight never publishes.

**The ledger** (``ledger.jsonl``): one JSON line a closed round (round,
cohort, reporters, partial, deadline), the oracle of a failover. A line
is appended before the round's snapshot, so a crash between the two
re-closes the round after restore and appends it again: readers keep
the last row of each round and skip a torn final line. The fsync is
group-committed (every ``group_commit_lines`` lines or
``group_commit_ms``, plus the writer's pre-publish barrier and the
flush on close); the synchronous checkpointer fsyncs every line.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import logging
import os
import re
import struct
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from fedml_tpu_torch.utils.fsio import fsync_dir

_STATE_RE = re.compile(r"state_(\d+)\.npz$")

#: bumped when the snapshot layout changes incompatibly
STATE_FORMAT = 1

#: group-commit defaults of the asynchronous control plane (the
#: synchronous checkpointer fsyncs every ledger line: lines=1, ms=0)
GROUP_COMMIT_LINES = 8
GROUP_COMMIT_MS = 50.0

SKELETON = "skeleton.json"
_REF = "__npy__"
#: every member's timestamp and mode: the blob is a pure function of the
#: state
_DATE_TIME = (1980, 1, 1, 0, 0, 0)
_EXTERNAL_ATTR = 0o644 << 16
_DOS_DATE = (_DATE_TIME[0] - 1980) << 9 | _DATE_TIME[1] << 5 | _DATE_TIME[2]
_DOS_TIME = _DATE_TIME[3] << 11 | _DATE_TIME[4] << 5 | _DATE_TIME[5] // 2
_ZIP_VERSION = 20
#: a member past this needs zip64, which the splice does not write
_ZIP32_LIMIT = (1 << 31) - 1

_WRITER_IDS = itertools.count()


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    # (np.ascontiguousarray would turn a 0-d array into a 1-d one)
    np.lib.format.write_array(buf, np.asarray(arr, order="C"),
                              allow_pickle=False)
    return buf.getvalue()


def _encode_field(field: str, value: Any):
    """One top-level field -> (its skeleton fragment as JSON text, its
    members ``[(name, npy bytes, crc32)]``)."""
    members = []

    def walk(v):
        if isinstance(v, dict):
            if _REF in v:
                raise ValueError(f"snapshot key {_REF!r} is reserved")
            out = {}
            for k, x in v.items():
                if not isinstance(k, str):
                    raise ValueError(f"snapshot dict key {k!r} in "
                                     f"{field!r}: keys are strings")
                out[k] = walk(x)
            return out
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        if isinstance(v, (np.ndarray, np.generic)):
            arr = np.asarray(v)
            if arr.dtype.hasobject:
                raise ValueError(f"snapshot field {field!r} holds an "
                                 "object array")
            name = f"{field}/{len(members)}.npy"
            data = _npy_bytes(arr)
            members.append((name, data, zlib.crc32(data)))
            return {_REF: name}
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        raise TypeError(f"snapshot field {field!r}: cannot store "
                        f"{type(v).__name__} (numpy arrays, dicts with "
                        "string keys, lists, scalars and None)")

    # insertion order, not sorted: a state dict's order is part of it
    # (its structure fingerprint hashes the names in order)
    fragment = json.dumps(walk(value), separators=(",", ":"))
    return fragment, members


def _skeleton_text(fragments: Dict[str, str]) -> bytes:
    """The skeleton member, written from the fields' fragments: the
    top-level fields sorted, each field's dicts in their own order."""
    return ("{" + ",".join(f"{json.dumps(k)}:{fragments[k]}"
                           for k in sorted(fragments)) + "}").encode()


def _zip_monolithic(members: List[Tuple[str, bytes]]) -> bytes:
    """The blob as ``zipfile`` writes it: stored members, fixed metadata."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for name, data in members:
            info = zipfile.ZipInfo(name, date_time=_DATE_TIME)
            info.create_system = 3
            info.external_attr = _EXTERNAL_ATTR
            zf.writestr(info, data)
    return buf.getvalue()


def _zip_splice(members: List[Tuple[str, bytes, int]]) -> bytes:
    """The same archive assembled from members whose CRC-32 is known:
    local headers and data, then the central directory and its end
    record (the layout ``zipfile`` writes for stored, non-zip64
    members)."""
    parts, central, offset = [], [], 0
    for name, data, crc in members:
        fname = name.encode("ascii")
        size = len(data)
        if size > _ZIP32_LIMIT or offset > _ZIP32_LIMIT:
            raise ValueError("snapshot member past the zip32 limit")
        header = struct.pack(zipfile.structFileHeader,
                             zipfile.stringFileHeader, _ZIP_VERSION, 0, 0,
                             zipfile.ZIP_STORED, _DOS_TIME, _DOS_DATE, crc,
                             size, size, len(fname), 0)
        parts += [header, fname, data]
        central.append(struct.pack(
            zipfile.structCentralDir, zipfile.stringCentralDir,
            _ZIP_VERSION, 3, _ZIP_VERSION, 0, 0, zipfile.ZIP_STORED,
            _DOS_TIME, _DOS_DATE, crc, size, size, len(fname), 0, 0, 0, 0,
            _EXTERNAL_ATTR, offset) + fname)
        offset += len(header) + len(fname) + size
    cdir = b"".join(central)
    end = struct.pack(zipfile.structEndArchive, zipfile.stringEndArchive,
                      0, 0, len(members), len(members), len(cdir), offset, 0)
    return b"".join(parts) + cdir + end


def encode_state(state: Dict[str, Any]) -> bytes:
    """The monolithic blob of ``state`` (a dict of top-level fields)."""
    fragments, members = {}, []
    for field in sorted(state):
        fragments[field], ms = _encode_field(field, state[field])
        members += [(n, d) for n, d, _ in ms]
    return _zip_monolithic([(SKELETON, _skeleton_text(fragments))]
                           + members)


def decode_state(blob: bytes) -> Dict[str, Any]:
    """A blob back to the state: numpy arrays where arrays were."""
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        skeleton = json.loads(zf.read(SKELETON))

        def walk(v):
            if isinstance(v, dict):
                if set(v) == {_REF}:
                    with zf.open(v[_REF]) as f:
                        return np.lib.format.read_array(
                            f, allow_pickle=False)
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, list):
                return [walk(x) for x in v]
            return v
        return walk(skeleton)


class IncrementalStateSerializer:
    """A per-field byte cache for the snapshot blob.

    A field with a version token keeps its skeleton fragment and its
    ``.npy`` members (with their CRC-32s) under that token; while the
    token is unchanged the blob is spliced from the cache instead of
    re-encoding megabytes. Each entry carries a sha256 of its bytes, so a
    reuse is traceable to what it stands for.

    The first spliced blob of a process is checked against the
    monolithic ``zipfile`` encoding; a mismatch logs once and falls back
    to monolithic serialization for good."""

    def __init__(self) -> None:
        #: field -> (version token, (fragment, members), content sha256)
        self._cache: Dict[str, Tuple[Any, tuple, str]] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self._verified = False
        self._fallback = False

    def serialize(self, state: Dict[str, Any],
                  versions: Optional[Dict[str, Any]] = None) -> bytes:
        if self._fallback or not versions:
            return encode_state(state)
        fragments, members = {}, []
        for field in sorted(state):
            token = versions.get(field)
            cached = self._cache.get(field) if token is not None else None
            if cached is not None and cached[0] == token:
                self.cache_hits += 1
                encoded = cached[1]
            else:
                encoded = _encode_field(field, state[field])
                if token is not None:
                    self.cache_misses += 1
                    sha = hashlib.sha256(encoded[0].encode())
                    for _, data, _ in encoded[1]:
                        sha.update(data)
                    self._cache[field] = (token, encoded, sha.hexdigest())
            fragments[field] = encoded[0]
            members += encoded[1]
        skeleton = _skeleton_text(fragments)
        blob = _zip_splice([(SKELETON, skeleton, zlib.crc32(skeleton))]
                           + members)
        if not self._verified:
            # once a process: the splice must be byte for byte what the
            # monolithic writer gives before any cached reuse is trusted
            self._verified = True
            full = encode_state(state)
            if blob != full:
                logging.warning(
                    "incremental snapshot serializer does not match the "
                    "monolithic zip (%d vs %d bytes): falling back to "
                    "monolithic serialization", len(blob), len(full))
                self._fallback = True
                self._cache.clear()
                return full
        return blob

    def field_sha(self, field: str) -> Optional[str]:
        """The content fingerprint of a cached field's bytes."""
        entry = self._cache.get(field)
        return entry[2] if entry is not None else None


class ServerControlCheckpointer:
    """The synchronous snapshot and ledger store (the substrate of both
    ``checkpoint_sync`` and the async writer).

    ``save`` and ``append_ledger`` are not re-entrant with themselves,
    but ``append_ledger`` (the round thread) is safe against
    ``sync_ledger`` and ``save`` (the writer thread): the ledger handle
    is guarded by ``_ledger_wlock`` and a snapshot touches only fresh
    files. :meth:`kill` is a simulated SIGKILL: from then on nothing of
    this instance is published (a publish already under way completes
    first)."""

    def __init__(self, directory: str, keep_last_n: int = 3,
                 group_commit_lines: int = 1,
                 group_commit_ms: float = 0.0):
        self.directory = directory
        self.keep_last_n = max(1, int(keep_last_n))
        #: the ledger's fsync cadence: 1 line / 0 ms fsyncs every line
        self.group_commit_lines = max(1, int(group_commit_lines))
        self.group_commit_ms = float(group_commit_ms)
        self._serializer = IncrementalStateSerializer()
        #: this instance's part of every temporary name
        self._tmp_tag = f"{os.getpid()}.{next(_WRITER_IDS)}"
        self._publish_lock = threading.Lock()
        self._killed = False
        # the ledger's handle and group-commit bookkeeping; the only
        # blocking work under this lock is the ledger's own write,
        # flush and fsync
        self._ledger_wlock = threading.Lock()
        self._ledger_fh = None
        self._ledger_pending = 0
        self._ledger_last_fsync = time.monotonic()
        # durability accounting (pure observers)
        self.fsync_count = 0
        self.ledger_fsync_count = 0
        self.ledger_lines = 0
        self.save_count = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, seq: int) -> str:
        return os.path.join(self.directory, f"state_{seq:012d}.npz")

    def _seqs(self) -> List[int]:
        """The snapshots with both files present (a blob whose sidecar
        never landed is a torn write, invisible)."""
        names = set(os.listdir(self.directory))
        out = []
        for fn in names:
            m = _STATE_RE.fullmatch(fn)
            if m and fn[:-len(".npz")] + ".json" in names:
                out.append(int(m.group(1)))
        return sorted(out)

    def _publish(self, tmp: str, dest: str) -> bool:
        """``os.replace`` unless this instance was killed; False (and the
        temporary file gone) when it was."""
        with self._publish_lock:
            if not self._killed:
                os.replace(tmp, dest)
                return True
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        return False

    def kill(self) -> None:
        """Publish nothing more: what a SIGKILL does to the writer."""
        with self._publish_lock:
            self._killed = True

    def save(self, state: Dict[str, Any],
             versions: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Atomically persist one control-state snapshot; returns its path
        (None after :meth:`kill`). ``state`` holds numpy arrays, dicts
        with string keys, lists, scalars and None, the shape the
        server's capture gives. ``versions`` maps fields to version
        tokens for the incremental serializer."""
        seqs = self._seqs()
        seq = (seqs[-1] + 1) if seqs else 0
        path = self._path(seq)
        blob = self._serializer.serialize(
            dict(state, format=STATE_FORMAT), versions)
        tmp = f"{path}.{self._tmp_tag}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
            self.fsync_count += 1
        if not self._publish(tmp, path):
            return None
        # the sidecar LAST: _seqs() needs both files, so a crash anywhere
        # in here leaves the previous snapshot authoritative
        side = path[:-len(".npz")] + ".json"
        stmp = f"{side}.{self._tmp_tag}.tmp"
        with open(stmp, "w") as f:
            json.dump({"seq": seq, "round_idx": int(state["round_idx"]),
                       "format": STATE_FORMAT,
                       "blob_sha256": hashlib.sha256(blob).hexdigest()}, f)
            f.flush()
            os.fsync(f.fileno())
            self.fsync_count += 1
        if not self._publish(stmp, side):
            return None
        # the renames live in the directory entry: fsync it, so the
        # publish survives power loss as well as process death
        if fsync_dir(self.directory):
            self.fsync_count += 1
        self.save_count += 1
        self._gc()
        return path

    def serializer_cache_hits(self) -> int:
        return self._serializer.cache_hits

    def load_latest(self) -> Optional[Dict[str, Any]]:
        """The newest complete snapshot (numpy leaves), or None."""
        seqs = self._seqs()
        if not seqs:
            return None
        path = self._path(seqs[-1])
        with open(path, "rb") as f:
            blob = f.read()
        try:
            state = decode_state(blob)
            fmt = int(state.get("format", 0))
        except (zipfile.BadZipFile, KeyError, ValueError) as exc:
            raise ValueError(f"server snapshot {path} is not a format-"
                             f"{STATE_FORMAT} blob ({exc!r}): refusing a "
                             "silently wrong resume") from exc
        if fmt != STATE_FORMAT:
            raise ValueError(
                f"server snapshot {path} has format {fmt}, this build "
                f"reads {STATE_FORMAT}: refusing a silently wrong resume")
        return state

    def latest_round(self) -> Optional[int]:
        seqs = self._seqs()
        if not seqs:
            return None
        with open(self._path(seqs[-1])[:-len(".npz")] + ".json") as f:
            return int(json.load(f)["round_idx"])

    def _gc(self) -> None:
        keep = set(self._seqs()[-self.keep_last_n:])
        # sorted: a crash mid-GC leaves a deterministic survivor set
        for fn in sorted(os.listdir(self.directory)):
            if not fn.startswith("state_"):
                continue
            try:
                seq = int(fn.split(".")[0].split("_")[1])
            except (IndexError, ValueError):
                continue
            # stray temporary files and sidecar-less blobs of a crash are
            # orphans _seqs() never reports: sweep them too
            if fn.endswith(".tmp") or seq not in keep:
                try:
                    os.remove(os.path.join(self.directory, fn))
                except FileNotFoundError:
                    pass

    # -- the round/cohort ledger ----------------------------------------------
    @property
    def ledger_path(self) -> str:
        return os.path.join(self.directory, "ledger.jsonl")

    def append_ledger(self, rec: Dict[str, Any]) -> None:
        """One closed round -> one JSON line, written and flushed whole
        (a reader sees at most a torn final line). The fsync is
        group-committed: every ``group_commit_lines`` lines or
        ``group_commit_ms``, whichever comes first. ``sync_ledger`` is the
        barrier the async writer takes before each publish."""
        line = json.dumps(rec) + "\n"
        with self._ledger_wlock:
            if self._ledger_fh is None:
                self._ledger_fh = open(self.ledger_path, "a")
            self._ledger_fh.write(line)
            self._ledger_fh.flush()
            self.ledger_lines += 1
            self._ledger_pending += 1
            now = time.monotonic()
            due = (self._ledger_pending >= self.group_commit_lines
                   or (self.group_commit_ms > 0.0
                       and (now - self._ledger_last_fsync) * 1e3
                       >= self.group_commit_ms))
            if due:
                os.fsync(self._ledger_fh.fileno())
                self.fsync_count += 1
                self.ledger_fsync_count += 1
                self._ledger_pending = 0
                self._ledger_last_fsync = now

    def sync_ledger(self) -> None:
        """fsync the pending ledger lines (the pre-publish barrier and the
        flush on close)."""
        with self._ledger_wlock:
            if self._ledger_fh is not None and self._ledger_pending:
                self._ledger_fh.flush()
                os.fsync(self._ledger_fh.fileno())
                self.fsync_count += 1
                self.ledger_fsync_count += 1
                self._ledger_pending = 0
                self._ledger_last_fsync = time.monotonic()

    def close(self) -> None:
        """Flush on close: sync the pending lines and release the handle
        (safe to repeat)."""
        with self._ledger_wlock:
            if self._ledger_fh is not None:
                try:
                    self._ledger_fh.flush()
                    if self._ledger_pending:
                        os.fsync(self._ledger_fh.fileno())
                        self.fsync_count += 1
                        self.ledger_fsync_count += 1
                        self._ledger_pending = 0
                    self._ledger_fh.close()
                except OSError:
                    logging.warning("ledger close for %s failed",
                                    self.ledger_path, exc_info=True)
                self._ledger_fh = None

    def read_ledger(self, dedup: bool = True) -> List[Dict[str, Any]]:
        """The ledger's rows in round order. ``dedup`` keeps the last row
        of each round (a crash between the ledger line and the snapshot
        makes the restored server close that round again). A torn final
        line is skipped."""
        if not os.path.exists(self.ledger_path):
            return []
        rows: List[Dict[str, Any]] = []
        with open(self.ledger_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    logging.warning("ledger %s: skipping torn line %r",
                                    self.ledger_path, line[:80])
        if dedup:
            by_round = {int(r["round"]): r for r in rows}
            rows = [by_round[r] for r in sorted(by_round)]
        return rows


class AsyncCheckpointWriter:
    """A writer thread with a depth-1 newest-wins slot over a
    :class:`ServerControlCheckpointer`: the round thread's ``save`` is a
    slot swap, and serialization, the temporary write, the fsyncs and the
    publish run on the writer.

    A submit that finds the slot full replaces it and counts
    ``coalesced``: a writer that falls behind publishes the newest state,
    never a backlog. Restore may then land on an older boundary than the
    ledger's tail; the schedule replays forward to the same ledger,
    because the writer syncs the ledger before each publish.

    ``flush()`` is the synchronous barrier; ``abort()`` the simulated
    SIGKILL: the pending snapshot is dropped, and a write in flight is
    killed before it publishes."""

    def __init__(self, inner: ServerControlCheckpointer,
                 name: str = "ckpt-writer"):
        self.inner = inner
        self._cond = threading.Condition()
        self._slot: Optional[Tuple[Dict[str, Any],
                                   Optional[Dict[str, Any]]]] = None
        self._seq_submitted = 0
        self._seq_done = 0
        self._stopped = False
        self.coalesced = 0
        self._coalesced_popped = 0
        self.published = 0
        self.failed = 0
        self.last_flush_ms = 0.0
        self.flush_ms_total = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    # -- the checkpointer surface the server drives ---------------------------
    @property
    def directory(self) -> str:
        return self.inner.directory

    @property
    def ledger_path(self) -> str:
        return self.inner.ledger_path

    def append_ledger(self, rec: Dict[str, Any]) -> None:
        self.inner.append_ledger(rec)

    def read_ledger(self, dedup: bool = True) -> List[Dict[str, Any]]:
        return self.inner.read_ledger(dedup=dedup)

    def load_latest(self) -> Optional[Dict[str, Any]]:
        return self.inner.load_latest()

    def latest_round(self) -> Optional[int]:
        return self.inner.latest_round()

    def save(self, state: Dict[str, Any],
             versions: Optional[Dict[str, Any]] = None) -> None:
        """Hand one snapshot to the writer (a slot swap and a notify).
        Once the writer is stopped (close, abort) the save runs inline,
        so a late save on the error path still lands (after an abort the
        killed checkpointer publishes nothing)."""
        with self._cond:
            if not self._stopped:
                if self._slot is not None:
                    self.coalesced += 1
                self._slot = (state, versions)
                self._seq_submitted += 1
                self._cond.notify_all()
                return
        self.inner.save(state, versions=versions)

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._slot is None and not self._stopped:
                    self._cond.wait()
                if self._slot is None:
                    return
                state, versions = self._slot
                self._slot = None
                target = self._seq_submitted
            t0 = time.perf_counter()
            try:
                # the ledger is durable through the round this snapshot
                # covers BEFORE the snapshot publishes, or a crash could
                # leave a snapshot newer than the durable ledger
                self.inner.sync_ledger()
                if self.inner.save(state, versions=versions) is not None:
                    self.published += 1
            except Exception:
                self.failed += 1
                logging.warning(
                    "async control snapshot write failed: the schedule "
                    "continues WITHOUT failover protection", exc_info=True)
            finally:
                self.last_flush_ms = (time.perf_counter() - t0) * 1e3
                self.flush_ms_total += self.last_flush_ms
                with self._cond:
                    self._seq_done = max(self._seq_done, target)
                    self._cond.notify_all()

    def flush(self, timeout: Optional[float] = 60.0) -> bool:
        """Block until every snapshot submitted before this call is
        published (or failed with a warning)."""
        with self._cond:
            target = self._seq_submitted
            ok = self._cond.wait_for(
                lambda: self._seq_done >= target or self._stopped,
                timeout=timeout)
        self.inner.sync_ledger()
        return bool(ok)

    def drain_to_newest(self, timeout: Optional[float] = 60.0) -> bool:
        """Block until every snapshot but the newest submitted one is
        published: the failover harness kills here, with the writer
        caught up to the previous boundary and the newest snapshot still
        pending or in flight."""
        with self._cond:
            target = self._seq_submitted - 1
            return bool(self._cond.wait_for(
                lambda: self._seq_done >= target or self._stopped,
                timeout=timeout))

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """flush, stop the writer, and flush the ledger on close."""
        self.flush(timeout=timeout)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        self.inner.close()

    def abort(self) -> None:
        """The simulated SIGKILL: drop the pending slot, kill the inner
        checkpointer (a write in flight is not published) and stop,
        without a flush. Restore lands on the last published boundary."""
        self.inner.kill()
        with self._cond:
            self._slot = None
            self._stopped = True
            self._seq_done = self._seq_submitted
            self._cond.notify_all()
        # the kill already fences every publish: a write blocked in I/O
        # may finish on its own time
        self._thread.join(timeout=1.0)

    def pop_coalesced(self) -> int:
        """Coalesced submits since the last pop (the server credits them
        into ``cp_writer_queue_coalesced`` at a round close)."""
        with self._cond:
            delta = self.coalesced - self._coalesced_popped
            self._coalesced_popped = self.coalesced
            return delta

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {"published": self.published,
                    "coalesced": self.coalesced,
                    "failed": self.failed,
                    "pending": 0 if self._slot is None else 1,
                    "last_flush_ms": self.last_flush_ms,
                    "flush_ms_total": self.flush_ms_total}
