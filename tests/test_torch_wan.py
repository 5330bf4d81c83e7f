"""The WAN world's pure functions against the JAX package's, bit for bit:
the per-client hash, the availability trace, the client profiles, the
availability-restricted cohort draw in both regimes, the JOIN token
bucket under an injected clock, the world's silo and population queries,
the spec parsers (results and error texts), the fault-plan composition,
the registry's ``wan_*`` rows and the launcher flags.

Every comparison is exact (``tobytes`` or ``==`` on float64): both
packages run the same numpy arithmetic on the same inputs.
"""

import argparse
import json

import numpy as np
import pytest

from fedml_tpu import wan as jwan
from fedml_tpu.comm.faults import FaultRule as JFaultRule
from fedml_tpu.control.admission import \
    JoinAdmissionController as JController
from fedml_tpu.core import sampling as jsampling
from fedml_tpu.experiments import args as jargs
from fedml_tpu.state import population as jpopulation
from fedml_tpu_torch import wan
from fedml_tpu_torch.comm.faults import FaultRule
from fedml_tpu_torch.control import JoinAdmissionController
from fedml_tpu_torch.core import sampling
from fedml_tpu_torch.experiments import args as pargs
from fedml_tpu_torch.obs import registry
from fedml_tpu_torch.state import population

SMOKE_TRACE = ("seed=20;period_s=960;phase0_s=480;peak=0.98;trough=0.45;"
               "duty_jitter=0.05;slot_s=120;flap=60:120:0.5")
TRACES = [
    SMOKE_TRACE,
    "seed=7;period_s=3600;slot_s=300",
    "seed=3;period_s=1000;peak=0.95;trough=0.2;duty_jitter=0.0;slot_s=50;"
    "phase_jitter_s=120",
    "seed=5;peak=1.0;trough=1.0;duty_jitter=0.0;slot_s=100;"
    "flap=1000:200:0.5;flap=1100:50:0.25",
]
PROFILES = [
    "seed=5;compute_median_s=0.12;compute_sigma=0.5;delay_cap_s=1.0",
    "seed=1;compute_median_s=0.0;up_min_bps=1e5;down_min_bps=1e6;"
    "bw_alpha=1.5;delay_cap_s=100.0",
    "seed=9;compute_median_s=0.2;compute_sigma=1.0",
]
CIDS = np.concatenate([np.arange(0, 5000, 7), [2**31 - 1, 2**40 + 3,
                                               2**63 - 1]]).astype(np.int64)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- the per-client hash ------------------------------------------------------

@pytest.mark.parametrize("seed, salt", [(0, 0), (20, 0xA11CE), (5, 0xBEEF),
                                        (2**40 + 1, 0x51075 + 0x9E37 * 9)])
def test_client_uniform_and_mix64_match_jax(seed, salt):
    v = CIDS.astype(np.uint64)
    _same(population._mix64(v), jpopulation._mix64(v))
    got = population.client_uniform(CIDS, seed, salt=salt)
    _same(got, jpopulation.client_uniform(CIDS, seed, salt=salt))
    assert got.min() > 0.0 and got.max() < 1.0


# -- the trace ----------------------------------------------------------------

@pytest.mark.parametrize("spec", TRACES)
def test_trace_matches_jax(spec):
    ours = wan.AvailabilityTrace(wan.parse_wan_trace(spec))
    theirs = jwan.AvailabilityTrace(jwan.parse_wan_trace(spec))
    for t in (0.0, 60.0, 119.9, 250.0, 750.0, 1050.0, 1234.5, 86_399.0):
        for fn in ("rate", "flapped", "available"):
            _same(getattr(ours, fn)(CIDS, t), getattr(theirs, fn)(CIDS, t))
        for pop in (24, 1000, 20_000):
            assert ours.available_frac(t, pop) == theirs.available_frac(
                t, pop)
            assert ours.available_frac(t, pop, sample=64) == \
                theirs.available_frac(t, pop, sample=64)
            assert ours.churn_between(t, t + 300.0, pop) == \
                theirs.churn_between(t, t + 300.0, pop)


# -- the profiles -------------------------------------------------------------

@pytest.mark.parametrize("spec", PROFILES)
def test_profiles_match_jax(spec):
    ours = wan.ClientProfiles(wan.parse_wan_profiles(spec))
    theirs = jwan.ClientProfiles(jwan.parse_wan_profiles(spec))
    for fn in ("compute_s", "uplink_bps", "downlink_bps"):
        _same(getattr(ours, fn)(CIDS), getattr(theirs, fn)(CIDS))
    for up, down in ((0.0, 0.0), (400.0, 400.0), (4.8e6, 1e5)):
        _same(ours.report_delay_s(CIDS, up, down),
              theirs.report_delay_s(CIDS, up, down))
        for q in (0.1, 0.5, 0.9):
            for pop in (24, 100_000):
                assert ours.delay_quantile(q, pop, up, down) == \
                    theirs.delay_quantile(q, pop, up, down)


# -- the parsers --------------------------------------------------------------

def _outcome(fn, spec):
    try:
        return "ok", fn(spec)
    except Exception as exc:  # the error's type and text are compared
        return type(exc).__name__, str(exc)


def _plain(cfg):
    """A parsed config as plain data (the two packages' dataclasses are
    different classes)."""
    if cfg is None or isinstance(cfg, str):
        return cfg
    d = dict(vars(cfg))
    if "flaps" in d:
        d["flaps"] = [tuple(vars(f).values()) for f in d["flaps"]]
    return d


TRACE_SPECS = [
    None, "", "   ", SMOKE_TRACE,
    "seed=7;period_s=960;peak=0.9;trough=0.4;phase0_s=480;slot_s=120;"
    "flap=60:120:0.5;flap=300:60:0.25",
    json.dumps({"seed": 7, "period_s": 960, "peak": 0.9, "trough": 0.4,
                "flaps": [{"start_s": 60, "duration_s": 120, "frac": 0.5},
                          [300, 60, 0.25]]}),
    {"seed": "4", "peak": 0.8},
    "bogus_key=1", "flap=60:120", "peak=0.2;trough=0.9",
    "flap=60:0:0.5", "flap=60:10:1.5", "duty_jitter=1.0", "slot_s=0",
    "missing.json", "seed=x",
]
PROFILE_SPECS = [
    None, "", PROFILES[0], PROFILES[1],
    json.dumps({"seed": 3, "compute_median_s": 0.2, "bw_alpha": 2.0}),
    {"seed": 2.0, "delay_cap_s": 3.0},
    "nope=1", "bw_alpha=0", "compute_sigma=-1", "up_min_bps=0",
    "delay_cap_s=0", "missing.json",
]


@pytest.mark.parametrize("spec", TRACE_SPECS)
def test_trace_parser_matches_jax(spec):
    got, want = (_outcome(wan.parse_wan_trace, spec),
                 _outcome(jwan.parse_wan_trace, spec))
    assert got[0] == want[0]
    assert _plain(got[1]) == _plain(want[1])


@pytest.mark.parametrize("spec", PROFILE_SPECS)
def test_profiles_parser_matches_jax(spec):
    got, want = (_outcome(wan.parse_wan_profiles, spec),
                 _outcome(jwan.parse_wan_profiles, spec))
    assert got[0] == want[0]
    assert _plain(got[1]) == _plain(want[1])


def test_json_path_specs_match_jax(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"seed": 11, "trough": 0.3, "flaps": [
        {"start_s": 10, "duration_s": 5, "frac": 0.1}]}))
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps({"seed": 4, "compute_sigma": 0.3}))
    assert _plain(wan.parse_wan_trace(str(trace))) == _plain(
        jwan.parse_wan_trace(str(trace)))
    assert _plain(wan.parse_wan_profiles(str(prof))) == _plain(
        jwan.parse_wan_profiles(str(prof)))
    assert wan.parse_wan_trace(str(trace)).flaps == (
        wan.FlapBurst(10.0, 5.0, 0.1),)


# -- the availability-restricted cohort draw ----------------------------------

def _every_third(cids):
    return (np.asarray(cids) % 3) == 0


def _three_of_fifty(cids):
    return np.isin(np.asarray(cids), [3, 17, 41])


def _dark(cids):
    return np.zeros(len(cids), dtype=bool)


def _evens(cids):
    return (np.asarray(cids) % 2) == 0


def _one_in_10k(cids):
    return (np.asarray(cids) % 10_000) == 7


def _smoke_trace(cids):
    return jwan.AvailabilityTrace(jwan.parse_wan_trace(
        SMOKE_TRACE)).available(cids, 120.0)


SAMPLER_CASES = {
    # (total, per_round, predicate, threshold)
    "resident": (100, 10, _every_third, None),
    "resident_short": (50, 8, _three_of_fifty, None),
    "resident_dark": (50, 5, _dark, None),
    "resident_all": (12, 12, _evens, None),
    "resident_trace": (24, 4, _smoke_trace, None),
    "virtual": (1_000_000, 16, _evens, 1000),
    "virtual_dark": (1_000_000, 8, _dark, 1000),
    "virtual_sparse": (1_000_000, 8, _one_in_10k, 1000),
    "virtual_trace": (50_000, 12, _smoke_trace, 1000),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sample_clients_available_matches_jax(case):
    total, k, pred, threshold = SAMPLER_CASES[case]
    for r in (0, 1, 4, 9):
        stats, jstats = {}, {}
        got = sampling.sample_clients_available(r, total, k, pred,
                                                threshold=threshold,
                                                stats=stats)
        want = jsampling.sample_clients_available(r, total, k, pred,
                                                  threshold=threshold,
                                                  stats=jstats)
        _same(got, want)
        assert stats == jstats
        assert len(got) == min(k, total)
    if case.endswith("dark"):
        assert stats["forced"] == k
    if case == "resident_short":
        assert set(got.tolist()) == {3, 17, 41} and stats["forced"] == 5


# -- the JOIN token bucket ----------------------------------------------------

@pytest.mark.parametrize("rate, burst", [(0.05, None), (2.0, None),
                                         (1.0, 3.0), (10.0, 1.5)])
def test_admission_controller_matches_jax(rate, burst):
    now = [0.0]
    ours = JoinAdmissionController(rate, burst, clock=lambda: now[0])
    theirs = JController(rate, burst, clock=lambda: now[0])
    assert ours.burst == theirs.burst
    for step in [0.0, 0.0, 0.0, 0.1, 0.3, 1.0, 0.0, 7.5, 0.01, 20.0, 0.0]:
        now[0] += step
        assert ours.retry_after_s() == theirs.retry_after_s()
        assert ours.try_acquire() == theirs.try_acquire()
    assert (ours.admitted, ours.throttled) == (theirs.admitted,
                                               theirs.throttled)
    assert ours.admitted >= 1 and ours.throttled >= 1
    for bad in (0.0, -1.0):
        for cls in (JoinAdmissionController, JController):
            with pytest.raises(ValueError, match="rate_per_s must be > 0"):
                cls(bad)


# -- the world ----------------------------------------------------------------

def _worlds(**kw):
    kw.setdefault("trace", SMOKE_TRACE)
    kw.setdefault("round_s", 60.0)
    return (wan.WanWorld(**kw), jwan.WanWorld(**kw))


@pytest.mark.parametrize("population", [None, 24, 200, 1_000_000])
def test_world_matches_jax(population):
    ours, theirs = _worlds(population=population, mass_join_rate=0.05,
                           profiles=PROFILES[0])
    for rank in range(1, 11):
        assert ours.silo_device(rank) == theirs.silo_device(rank)
        for r in range(10):
            assert ours.silo_online(rank, r) == theirs.silo_online(rank, r)
    total = population or 24
    for r in range(10):
        for record in (True, False):
            _same(ours.sample_cohort(r, total, 4, record=record),
                  theirs.sample_cohort(r, total, 4, record=record))
        assert ours.drain_counters() == theirs.drain_counters()
        assert ours.mass_churn(r) == theirs.mass_churn(r)
        assert ours.available_frac(r) == theirs.available_frac(r)
        for client in (0, 7, 23):
            assert ours.report_delay_s(client, 4.8e6, 4.8e6) == \
                theirs.report_delay_s(client, 4.8e6, 4.8e6)
    assert ours.drain_counters() == {}
    if population:
        assert sum(j for j, _, _ in map(ours.mass_churn, range(9))) >= 1


def test_agents_and_the_valve_match_jax():
    ours, theirs = _worlds(offline_hold_s=5.0, profiles=PROFILES[0],
                           delay_wall_cap_s=0.4)
    offline = [(rank, r) for r in range(8) for rank in (1, 2, 3, 4)
               if not ours.silo_online(rank, r)]
    assert offline
    for rank in (1, 2, 3, 4):
        a, b = ours.agent(rank), theirs.agent(rank)
        for r in range(8):
            assert a.on_round(r, 3 * rank + r, 400.0, 400.0) == \
                b.on_round(r, 3 * rank + r, 400.0, 400.0)
        assert a.counters == b.counters
        assert a.online_now() == b.online_now() == all(
            ours.silo_online(rank, r) for r in range(8))
    rank, r = offline[0]
    for w in (ours, theirs):
        w.force_online(rank)
    assert ours.silo_online(rank, r) and theirs.silo_online(rank, r)
    assert ours.agent(rank).on_round(r, 0) == theirs.agent(rank).on_round(
        r, 0)


def test_build_wan_world_front_door_matches_jax():
    assert wan.build_wan_world(None) is None
    assert wan.build_wan_world("") is None
    for build in (wan.build_wan_world, jwan.build_wan_world):
        with pytest.raises(ValueError) as err:
            build(None, wan_profiles="compute_median_s=0.1")
        with pytest.raises(ValueError, match="round_s must be > 0"):
            build("seed=1", wan_round_s=0.0)
    assert "--wan_profiles without --wan_trace" in str(err.value)
    msgs = []
    for build in (wan.build_wan_world, jwan.build_wan_world):
        try:
            build(None, wan_profiles="seed=1")
        except ValueError as exc:
            msgs.append(str(exc))
    assert msgs[0] == msgs[1]
    w = wan.build_wan_world("seed=1;peak=0.9;trough=0.5", wan_round_s=30.0,
                            population=500, wan_profiles="seed=2")
    assert w.round_s == 30.0 and w.population == 500
    assert w.profiles is not None and w.t_of_round(3) == 90.0


def _rules(plan):
    return None if plan is None else (plan.seed, [
        {k: v for k, v in vars(r).items()} for r in plan.rules])


@pytest.mark.parametrize("base, extra", [
    ("seed=4;drop:p=0.5", ()),
    ("seed=4;drop:p=0.5", ("delay",)),
    (None, ("delay",)),
    (None, ()),
    ('{"seed": 3, "rules": [{"op": "corrupt", "p": 0.5}]}', ("drop",
                                                             "delay")),
])
def test_compose_fault_plan_matches_jax(base, extra):
    rules = {"delay": dict(op="delay", delay_ms=5.0, sender=2),
             "drop": dict(op="drop", p=0.1, msg_type=4)}
    got = wan.compose_fault_plan(base, [FaultRule(**rules[e])
                                        for e in extra])
    want = jwan.compose_fault_plan(base, [JFaultRule(**rules[e])
                                          for e in extra])
    assert _rules(got) == _rules(want)


# -- the registry and the flags -----------------------------------------------

def test_no_wan_metric_is_pending():
    wan_rows = [n for n in registry.METRICS if n.startswith("wan_")]
    assert len(wan_rows) == 9
    assert not [n for n in registry.PENDING if n.startswith("wan_")]


def test_parser_accepts_the_wan_flags_as_jax():
    argv = ["--wan_trace", SMOKE_TRACE, "--wan_profiles", PROFILES[0],
            "--wan_round_s", "30"]
    for extra in ([], argv):
        got = vars(pargs.add_federated_args(
            argparse.ArgumentParser()).parse_args(extra))
        want = vars(jargs.add_federated_args(
            argparse.ArgumentParser()).parse_args(extra))
        for k in ("wan_trace", "wan_profiles", "wan_round_s"):
            assert got[k] == want[k]
    assert got["wan_round_s"] == 30.0
