"""The port's server control checkpointer: the snapshot blob, the
incremental serializer, the async writer and the round/cohort ledger
(``fedml_tpu_torch/control/checkpoint.py``), the counterparts of the JAX
package's ``TestServerCheckpointer``, ``TestIncrementalSerializer`` and
``TestAsyncCheckpointWriter`` (``tests/test_control_plane.py:183-465``).

The blob is the port's own (an uncompressed zip of ``.npy`` members and a
JSON skeleton), so neither package reads the other's; the sidecar, the
atomic publish, the GC and the ledger keep the JAX layout, and each
package's ``read_ledger`` reads the other's ``ledger.jsonl``. The JAX
package's abort test is known to race (an aborted writer and a second
checkpointer share one ``.tmp`` name); its port counterpart here holds
the fixed writer, with the in-flight write gated so it is mid-write when
the abort lands."""

import json
import logging
import os
import threading
import time
import zipfile

import numpy as np
import pytest

from fedml_tpu.control import ServerControlCheckpointer as JaxCheckpointer
from fedml_tpu_torch.control import (AsyncCheckpointWriter,
                                     ServerControlCheckpointer)
from fedml_tpu_torch.control import checkpoint as ck


def _state(r):
    return {"round_idx": r,
            "tree": {"w": np.full(4, r, np.float32)},
            "none": None, "flag": True,
            "nested": [{"round": r, "reported": [0, 1]}]}


def _blobs(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".npz"))


# -- the snapshot store -------------------------------------------------------

def test_save_load_round_trip(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path))
    assert ckp.load_latest() is None and ckp.latest_round() is None
    state = dict(_state(3), f32=np.float32(1.5), i64=np.int64(-7),
                 empty=np.zeros((0, 3), np.float16), text="x", big=2**40,
                 neg0=np.array([-0.0, np.nan, np.inf], np.float32),
                 keys={"conv.weight": np.arange(6.0).reshape(2, 3),
                       "a": None, "0": [1.25, None]})
    ckp.save(state)
    back = ckp.load_latest()
    assert back["round_idx"] == 3 and back["none"] is None
    assert back["flag"] is True and back["format"] == ck.STATE_FORMAT
    assert back["nested"] == [{"round": 3, "reported": [0, 1]}]
    for k in ("f32", "i64", "empty", "neg0"):
        assert back[k].dtype == np.asarray(state[k]).dtype
        assert back[k].shape == np.asarray(state[k]).shape
        assert back[k].tobytes() == np.asarray(state[k]).tobytes(), k
    # dict order survives (a state dict's order is its fingerprint's)
    assert list(back["keys"]) == ["conv.weight", "a", "0"]
    assert back["text"] == "x" and back["big"] == 2**40
    assert ckp.latest_round() == 3
    with zipfile.ZipFile(tmp_path / _blobs(tmp_path)[0]) as zf:
        assert zf.namelist()[0] == ck.SKELETON
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in zf.infolist())
    side = json.loads((tmp_path / "state_000000000000.json").read_text())
    assert side["round_idx"] == 3 and side["format"] == ck.STATE_FORMAT
    assert len(side["blob_sha256"]) == 64


def test_unstorable_values_are_refused(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path))
    for bad in ({"round_idx": 0, "x": object()},
                {"round_idx": 0, "x": {1: 2}},
                {"round_idx": 0, "x": np.array([object()])},
                {"round_idx": 0, "x": {"__npy__": "a"}}):
        with pytest.raises((TypeError, ValueError)):
            ckp.save(bad)
    assert ckp.load_latest() is None


def test_keep_last_n_gc(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path), keep_last_n=2)
    for r in range(5):
        ckp.save(_state(r))
    assert _blobs(tmp_path) == ["state_000000000003.npz",
                                "state_000000000004.npz"]
    assert ckp.load_latest()["round_idx"] == 4


def test_torn_write_leaves_old_complete(tmp_path):
    """A blob without its sidecar and a stray temporary file are
    invisible; the next save sweeps them."""
    ckp = ServerControlCheckpointer(str(tmp_path))
    ckp.save(_state(1))
    (tmp_path / "state_000000000007.npz").write_bytes(
        ck.encode_state(dict(_state(2), format=1)))
    (tmp_path / "state_000000000009.npz.123.0.tmp").write_bytes(b"torn")
    assert ckp.load_latest()["round_idx"] == 1
    ckp.save(_state(3))
    assert ckp.load_latest()["round_idx"] == 3
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    assert "state_000000000007.npz" not in os.listdir(tmp_path)


@pytest.mark.parametrize("blob", ["format", "garbage"])
def test_format_mismatch_raises(tmp_path, blob):
    ckp = ServerControlCheckpointer(str(tmp_path))
    data = (ck.encode_state({"round_idx": 0, "format": 99})
            if blob == "format" else b"not a zip")
    (tmp_path / "state_000000000000.npz").write_bytes(data)
    (tmp_path / "state_000000000000.json").write_text(
        json.dumps({"seq": 0, "round_idx": 0, "format": 99}))
    with pytest.raises(ValueError, match="format"):
        ckp.load_latest()


def test_ledger_dedup_keeps_last_and_skips_torn_line(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path))
    ckp.append_ledger({"round": 0, "cohort": [1], "reported": [0]})
    ckp.append_ledger({"round": 1, "cohort": [2], "reported": [0]})
    # a crash between the ledger line and the snapshot closes round 1
    # again: the re-append is the row that counts
    ckp.append_ledger({"round": 1, "cohort": [2], "reported": [0, 1]})
    with open(ckp.ledger_path, "a") as f:
        f.write('{"round": 2, "coh')  # killed mid-write
    rows = ckp.read_ledger()
    assert [r["round"] for r in rows] == [0, 1]
    assert rows[1]["reported"] == [0, 1]
    assert len(ckp.read_ledger(dedup=False)) == 3
    ckp.close()


def test_each_package_reads_the_others_ledger(tmp_path):
    rows = [{"round": 0, "cohort": [3, 1], "reported": [0, 1],
             "partial": False, "deadline_s": 2.0},
            {"round": 1, "cohort": [0, 2], "reported": [1],
             "partial": True, "deadline_s": None},
            {"round": 1, "cohort": [0, 2], "reported": [0, 1],
             "partial": False, "deadline_s": 1.5}]
    for writer, reader in ((ServerControlCheckpointer, JaxCheckpointer),
                           (JaxCheckpointer, ServerControlCheckpointer)):
        d = str(tmp_path / writer.__module__.split(".")[0])
        w = writer(d)
        for r in rows:
            w.append_ledger(r)
        w.close()
        for dedup in (True, False):
            assert reader(d).read_ledger(dedup=dedup) == \
                w.read_ledger(dedup=dedup)
        assert reader(d).read_ledger() == [rows[0], rows[2]]


# -- the incremental serializer -----------------------------------------------

def _sstate(r):
    return {"round_idx": r, "format": 1,
            "global_model": {"w": np.arange(8, dtype=np.float32) * r},
            "zeta": None, "alpha": [1, {"b": 2}]}


def test_splice_is_byte_identical_and_caches():
    ser = ck.IncrementalStateSerializer()
    s1 = _sstate(1)
    assert ser.serialize(s1, versions={"global_model": 0}) == \
        ck.encode_state(s1)
    assert ser.cache_misses == 1 and ser.cache_hits == 0
    # the token unchanged: cached bytes, still the monolithic blob
    s2 = dict(s1, round_idx=2)
    assert ser.serialize(s2, versions={"global_model": 0}) == \
        ck.encode_state(s2)
    assert ser.cache_hits == 1
    assert ser.field_sha("global_model") is not None
    assert ser.field_sha("zeta") is None
    # the token bumped: fresh bytes for the new value
    s3 = dict(s1, round_idx=3,
              global_model={"w": np.arange(8, dtype=np.float32) * 9})
    assert ser.serialize(s3, versions={"global_model": 1}) == \
        ck.encode_state(s3)
    assert ser.cache_misses == 2 and not ser._fallback


@pytest.mark.parametrize("members", [0, 1, 17, 300])
def test_splice_matches_zipfile_across_sizes(members):
    """The hand-assembled archive equals ``zipfile``'s for any member
    count and size (the once-a-process oracle's premise)."""
    rng = np.random.RandomState(members)
    state = {"round_idx": 0, "m": {f"k{i}": rng.rand(i % 5, 3).astype(
        np.float32) for i in range(members)}}
    ser = ck.IncrementalStateSerializer()
    assert ser.serialize(state, versions={"m": 0}) == ck.encode_state(state)
    assert not ser._fallback
    assert ck.decode_state(ck.encode_state(state))["m"].keys() == \
        state["m"].keys()


def test_no_versions_means_monolithic():
    ser = ck.IncrementalStateSerializer()
    s = _sstate(4)
    assert ser.serialize(s, versions=None) == ck.encode_state(s)
    assert ser.cache_misses == 0


def test_mismatch_falls_back_permanently(caplog):
    """A poisoned cache entry trips the one-time oracle: the call returns
    the correct monolithic bytes and the splice is retired."""
    ser = ck.IncrementalStateSerializer()
    ser._cache["global_model"] = (0, ('{"w":null}', []), "bogus")
    s = _sstate(5)
    with caplog.at_level(logging.WARNING):
        blob = ser.serialize(s, versions={"global_model": 0})
    assert blob == ck.encode_state(s)
    assert ser._fallback and not ser._cache
    assert "falling back" in caplog.text
    assert ser.serialize(s, versions={"global_model": 0}) == blob


def test_checkpointer_counts_its_cache_hits(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path))
    ckp.save(_sstate(1), versions={"global_model": 0})
    ckp.save(_sstate(1), versions={"global_model": 0})
    assert ckp.serializer_cache_hits() == 1
    np.testing.assert_array_equal(ckp.load_latest()["global_model"]["w"],
                                  _sstate(1)["global_model"]["w"])


# -- the async writer ---------------------------------------------------------

def _gated(tmp_path, **kw):
    """An async writer whose inner save blocks until released:
    deterministic backpressure."""
    inner = ServerControlCheckpointer(str(tmp_path), **kw)
    gate = threading.Event()
    entered = threading.Event()
    orig = inner.save

    def gated_save(state, versions=None):
        entered.set()
        gate.wait(10)
        return orig(state, versions=versions)

    inner.save = gated_save
    return AsyncCheckpointWriter(inner), inner, gate, entered


def test_flush_barrier_publishes_newest(tmp_path):
    w = AsyncCheckpointWriter(ServerControlCheckpointer(str(tmp_path)))
    for r in range(3):
        w.save(_state(r))
    assert w.flush()
    assert w.load_latest()["round_idx"] == 2
    assert w.directory == str(tmp_path)
    w.close()


def test_coalescing_under_backpressure(tmp_path):
    w, _, gate, entered = _gated(tmp_path)
    w.save(_state(0))
    assert entered.wait(10)  # the writer holds the first save
    for r in range(1, 5):
        w.save(_state(r))
    gate.set()
    assert w.flush()
    stats = w.stats()
    # the first save in flight and the newest-wins slot: the middle
    # snapshots were coalesced away, the last publish is round 4
    assert stats["coalesced"] == 3 and stats["published"] == 2
    assert stats["pending"] == 0 and stats["failed"] == 0
    assert w.load_latest()["round_idx"] == 4
    assert w.pop_coalesced() == 3
    assert w.pop_coalesced() == 0
    w.close()


def test_abort_mid_async_write_restores_older_boundary(tmp_path):
    """The race fixed: a simulated SIGKILL while the writer is mid-write
    (the ledger tail newer than the newest snapshot, a torn temporary
    file beside it), then a second checkpointer in the same process.
    The killed write never publishes, the restore lands on the older
    boundary, and the schedule replays forward (the re-appended row
    dedups by round)."""
    w, inner, gate, entered = _gated(tmp_path)
    gate.set()
    w.append_ledger({"round": 0, "cohort": [1], "reported": [0]})
    w.append_ledger({"round": 1, "cohort": [2], "reported": [0]})
    w.save(_state(1))
    assert w.flush()
    # round 2 closes: its ledger line, its snapshot handed to the writer,
    # and the process dies while the writer is inside the save
    gate.clear()
    entered.clear()
    w.append_ledger({"round": 2, "cohort": [3], "reported": [0]})
    w.save(_state(2))
    assert entered.wait(10)
    (tmp_path / f"state_000000000099.npz.{os.getpid()}.9.tmp").write_bytes(
        b"torn mid-write")
    t0 = time.monotonic()
    w.abort()
    assert time.monotonic() - t0 < 5.0  # the abort does not wait it out
    gate.set()  # the killed write resumes: it must not publish
    ckp2 = ServerControlCheckpointer(str(tmp_path))
    assert ckp2._tmp_tag != inner._tmp_tag
    restored = ckp2.load_latest()
    assert restored["round_idx"] == 1  # older than the ledger's tail
    assert [r["round"] for r in ckp2.read_ledger()] == [0, 1, 2]
    # replay forward: round 2 closes again, appends, snapshots
    ckp2.append_ledger({"round": 2, "cohort": [3], "reported": [0]})
    ckp2.save(_state(2))
    w._thread.join(10)
    assert not w._thread.is_alive()
    assert ckp2.load_latest()["round_idx"] == 2
    assert [r["round"] for r in ckp2.read_ledger()] == [0, 1, 2]
    assert _blobs(tmp_path) == ["state_000000000000.npz",
                                "state_000000000001.npz"]
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    assert w.stats()["published"] == 1
    ckp2.close()


def test_post_close_save_degrades_inline(tmp_path):
    w = AsyncCheckpointWriter(ServerControlCheckpointer(str(tmp_path)))
    w.close()
    w.save(_state(7))  # no thread left: it still lands
    assert w.load_latest()["round_idx"] == 7


def test_a_killed_checkpointer_publishes_nothing(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path))
    ckp.save(_state(1))
    ckp.kill()
    assert ckp.save(_state(2)) is None
    assert ServerControlCheckpointer(str(tmp_path)).latest_round() == 1
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_ledger_group_commit_batches_fsyncs(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path), group_commit_lines=4,
                                    group_commit_ms=0.0)
    for r in range(3):
        ckp.append_ledger({"round": r, "cohort": [], "reported": []})
    assert ckp.ledger_fsync_count == 0
    # every line is readable already (a write and flush a line)
    assert [r["round"] for r in ckp.read_ledger()] == [0, 1, 2]
    ckp.append_ledger({"round": 3, "cohort": [], "reported": []})
    assert ckp.ledger_fsync_count == 1  # the batch of 4 committed
    ckp.sync_ledger()
    assert ckp.ledger_fsync_count == 1  # nothing pending: a no-op
    ckp.append_ledger({"round": 4, "cohort": [], "reported": []})
    ckp.close()  # the flush on close commits the tail
    assert ckp.ledger_fsync_count == 2
    assert ckp.ledger_lines == 5


def test_ledger_group_commit_by_time(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path), group_commit_lines=100,
                                    group_commit_ms=20.0)
    ckp.append_ledger({"round": 0, "cohort": [], "reported": []})
    fsyncs = ckp.ledger_fsync_count
    time.sleep(0.05)
    ckp.append_ledger({"round": 1, "cohort": [], "reported": []})
    assert ckp.ledger_fsync_count == fsyncs + 1
    ckp.close()


def test_writer_syncs_ledger_before_publish(tmp_path):
    """Snapshot durability never outruns ledger durability."""
    inner = ServerControlCheckpointer(str(tmp_path), group_commit_lines=100,
                                      group_commit_ms=0.0)
    w = AsyncCheckpointWriter(inner)
    w.append_ledger({"round": 0, "cohort": [], "reported": []})
    assert inner.ledger_fsync_count == 0  # far from the batch size
    w.save(_state(0))
    assert w.flush()
    assert inner.ledger_fsync_count >= 1  # the pre-publish barrier
    assert w.read_ledger() == inner.read_ledger()
    w.close()


def test_legacy_default_is_fsync_per_line(tmp_path):
    ckp = ServerControlCheckpointer(str(tmp_path))
    for r in range(3):
        ckp.append_ledger({"round": r, "cohort": [], "reported": []})
    assert ckp.ledger_fsync_count == 3
    ckp.close()


def test_a_failed_write_is_counted_and_logged(tmp_path, caplog):
    inner = ServerControlCheckpointer(str(tmp_path))

    def broken(state, versions=None):
        raise OSError("disk gone")
    inner.save = broken
    w = AsyncCheckpointWriter(inner)
    with caplog.at_level(logging.WARNING):
        w.save(_state(0))
        assert w.flush()
    assert w.stats()["failed"] == 1 and w.stats()["published"] == 0
    assert "WITHOUT failover protection" in caplog.text
    w.close()
