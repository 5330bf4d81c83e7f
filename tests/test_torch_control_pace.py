"""Pace steering and the control plane's option resolution against the JAX
package: ``control/pace.py``'s ``PaceSteerer`` and ``QUORUM_CEIL``, the
latency window's ``values``/``load`` (``utils/watchdog.py``) and
``build_control_plane``.

The steerer is host arithmetic on Python floats, so the same latency
windows and participation give the same deadlines and quorum fractions
exactly, clamps included (``tests/test_control_plane.py:90-153`` are the
JAX package's own checks)."""

import numpy as np
import pytest

from fedml_tpu.control import build_control_plane as jbuild
from fedml_tpu.control import pace as jpace
from fedml_tpu.utils import watchdog as jwatchdog
from fedml_tpu_torch.control import (AsyncCheckpointWriter,
                                     JoinAdmissionController,
                                     ServerControlCheckpointer,
                                     build_control_plane)
from fedml_tpu_torch.control import pace
from fedml_tpu_torch.utils import watchdog


def _tracker(mod, values, window=256):
    t = mod.SlidingQuantileTracker(window=window)
    for v in values:
        t.observe(v)
    return t


STEERERS = [
    dict(base_deadline_s=5.0),
    dict(base_deadline_s=8.0, quantile=0.5, margin=2.0),
    dict(base_deadline_s=8.0, min_deadline_s=1.0, max_deadline_s=3.0),
    dict(base_deadline_s=2.0, min_samples=1, quorum_floor=0.3,
         quorum_slack=0.05, window=5),
    dict(base_deadline_s=30.0, quorum_floor=0.95),
]


@pytest.mark.parametrize("kw", STEERERS)
def test_steered_sequence_equals_jax(kw):
    """A schedule of flapping participation and a drifting, bursty latency
    window through both steerers: every round's deadline and quorum
    fraction, and the state after it, are equal."""
    rng = np.random.RandomState(11)
    ours, theirs = pace.PaceSteerer(**kw), jpace.PaceSteerer(**kw)
    lat_p = watchdog.SlidingQuantileTracker(window=16)
    lat_j = jwatchdog.SlidingQuantileTracker(window=16)
    seq = []
    for r in range(40):
        live = int(rng.randint(1, 11))
        reported = int(rng.randint(0, live + 1))
        ours.observe_round(reported, live)
        theirs.observe_round(reported, live)
        for _ in range(int(rng.randint(0, 4))):
            x = float(rng.exponential(0.5 + (r % 7)) * (50 if r == 20
                                                        else 1))
            lat_p.observe(x)
            lat_j.observe(x)
        got = (ours.next_deadline(lat_p), ours.next_quorum_frac())
        want = (theirs.next_deadline(lat_j), theirs.next_quorum_frac())
        assert got == want, r
        assert ours.state() == theirs.state()
        seq.append(got)
    assert len({d for d, _ in seq}) > 1  # the schedule did steer


def test_state_round_trips_across_packages():
    """``state()`` / ``load_state()`` round-trip exactly, either way
    between the packages (the window rides the snapshot)."""
    p = pace.PaceSteerer(base_deadline_s=5.0)
    for r in range(9):
        p.observe_round(2 + r % 2, 3)
    q = jpace.PaceSteerer(base_deadline_s=5.0)
    q.load_state(p.state())
    assert q.state() == p.state()
    back = pace.PaceSteerer(base_deadline_s=5.0)
    back.load_state(q.state())
    assert back.state() == p.state()
    assert back.next_quorum_frac() == p.next_quorum_frac() == \
        q.next_quorum_frac()
    before = back.state()
    back.load_state(None)  # a snapshot without steering changes nothing
    back.load_state({})
    assert back.state() == before


def test_base_deadline_until_min_samples_and_clamps():
    for mod in (pace, jpace):
        p = mod.PaceSteerer(base_deadline_s=10.0, min_samples=4)
        assert p.next_deadline(None) == 10.0
        assert p.next_deadline(_tracker(watchdog, [1.0] * 3)) == 10.0
        assert p.next_quorum_frac() == 0.5
        band = mod.PaceSteerer(base_deadline_s=8.0)  # [2.0, 32.0]
        assert band.next_deadline(_tracker(watchdog, [1e-4] * 32)) == 2.0
        assert band.next_deadline(_tracker(watchdog, [1e4] * 32)) == 32.0
        for _ in range(64):
            band.observe_round(3, 3)
        assert band.next_quorum_frac() == pytest.approx(0.9)  # p25 - slack
        full = mod.PaceSteerer(base_deadline_s=8.0, quorum_slack=0.0)
        for _ in range(8):
            full.observe_round(3, 3)
        assert full.next_quorum_frac() == mod.QUORUM_CEIL
    assert pace.QUORUM_CEIL == jpace.QUORUM_CEIL == 0.95
    lat = np.linspace(0.4, 4.4, 101)
    np.testing.assert_allclose(
        pace.PaceSteerer(base_deadline_s=5.0).next_deadline(
            _tracker(watchdog, lat)),
        np.percentile(lat, 90) * 1.5, rtol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(base_deadline_s=None), dict(base_deadline_s=0.0),
    dict(base_deadline_s=5.0, quantile=1.5),
    dict(base_deadline_s=5.0, quantile=0.0),
    dict(base_deadline_s=5.0, quorum_floor=0.99),
    dict(base_deadline_s=5.0, min_deadline_s=9.0, max_deadline_s=3.0)])
def test_config_errors_as_jax(kw):
    for mod in (pace, jpace):
        with pytest.raises(ValueError):
            mod.PaceSteerer(**kw)


def test_the_latency_window_round_trips():
    ours = _tracker(watchdog, [3.0, 1.0], window=8)
    theirs = _tracker(jwatchdog, [3.0, 1.0], window=8)
    assert ours.values() == theirs.values() == [3.0, 1.0]
    t2 = watchdog.SlidingQuantileTracker(window=8)
    t2.load(theirs.values())
    assert t2.values() == [3.0, 1.0]
    t2.load(range(20))  # a load keeps the window's width
    assert t2.values() == [float(v) for v in range(12, 20)]


@pytest.mark.parametrize("opts", [
    {}, dict(pace_steering=True, round_deadline_s=4.0),
    dict(pace_steering=True, round_deadline_s=4.0, min_quorum_frac=1.0),
    dict(join_rate_limit=3.0), dict(max_deadline_extensions=None),
    dict(server_checkpoint_dir="ck"),
    dict(server_checkpoint_dir="ck", checkpoint_sync=True)])
def test_build_control_plane_resolves_as_jax(opts, tmp_path):
    if "server_checkpoint_dir" in opts:
        opts = dict(opts, server_checkpoint_dir=str(tmp_path / "ck"))
    ours, theirs = build_control_plane(**opts), jbuild(**opts)
    assert sorted(ours) == sorted(theirs)
    assert ours["max_deadline_extensions"] == \
        theirs["max_deadline_extensions"]
    for key in ("pace", "join_admission", "server_ckpt"):
        assert (ours[key] is None) == (theirs[key] is None), key
    if ours["pace"] is not None:
        assert vars(ours["pace"]).keys() == vars(theirs["pace"]).keys()
        for k in ("base_deadline_s", "min_deadline_s", "max_deadline_s",
                  "quorum_floor", "quantile", "margin"):
            assert getattr(ours["pace"], k) == getattr(theirs["pace"], k)
    if ours["join_admission"] is not None:
        assert isinstance(ours["join_admission"], JoinAdmissionController)
        assert ours["join_admission"].rate_per_s == 3.0
    ck = ours["server_ckpt"]
    if ck is not None:
        # async by default with group commit; inline, a line an fsync
        sync = opts.get("checkpoint_sync", False)
        assert isinstance(ck, ServerControlCheckpointer if sync
                          else AsyncCheckpointWriter)
        inner = ck if sync else ck.inner
        assert inner.group_commit_lines == (1 if sync else 8)
        assert inner.group_commit_ms == (0.0 if sync else 50.0)
        ck.close()
        theirs["server_ckpt"].close()
    with pytest.raises(ValueError, match="round_deadline_s"):
        build_control_plane(pace_steering=True)
