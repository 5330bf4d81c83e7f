"""Replay: the WAN world's churn run is a pure function of the trace seed.
Two port runs of ``smoke_world()`` (the JAX smoke fixture, on the
in-process router) give the same round ledger, row for row and field for
field, and the same trace-decided counters, with every cohort member
available at its round's sim time. About 14 s.
"""

import json

from fedml_tpu_torch.wan.__main__ import (SMOKE_ROUNDS, cohorts_all_available,
                                          run_churn_leg, smoke_world)

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TRACE_COUNTERS = ("wan_cohort_rejections", "wan_offline_drops",
                  "wan_mass_joins", "wan_mass_leaves",
                  "wan_mass_join_throttled", "ft_partial_rounds")


def test_two_runs_of_one_world_replay_the_ledger():
    legs = [run_churn_leg(None, world=smoke_world(), backend="INPROC",
                          port_base=None, device="cpu") for _ in range(2)]
    a, b = (json.dumps(leg["ledger"], sort_keys=True) for leg in legs)
    assert a == b
    assert len(legs[0]["ledger"]) == SMOKE_ROUNDS
    assert any(row["partial"] for row in legs[0]["ledger"])
    for leg in legs:
        assert cohorts_all_available(leg["ledger"], leg["world"])
        assert len(leg["history"]) == SMOKE_ROUNDS
    assert [legs[0]["counters"].get(k, 0) for k in TRACE_COUNTERS] == [
        legs[1]["counters"].get(k, 0) for k in TRACE_COUNTERS]
