"""The WAN churn leg under pace steering, against the JAX package: the JAX
smoke fixture (LR on blobs, 4 silos, 8 rounds, ``SMOKE_TRACE``,
``SMOKE_PROFILES``, a 2.0 s base deadline) through each package's
``run_churn_leg(pace_steering=True)`` on the in-process router, with the
ledger read back from each package's control-plane checkpointer.

The trace decides the schedule: which silos are dark at each deadline
and the rounds where deferred JOINs are re-admitted. Steering only moves
the deadline between base/4 and the base, and the profiles' report
delays (capped at 0.8 s of wall time) stay under it, so the ledgers are
equal row for row on ``round``, ``cohort``, ``reported`` and
``partial``. The steered deadlines themselves follow each run's wall
clock and are held to the JAX package's own check: the last ones under
the base, with the flap burst's resync latencies left out of the window
(``cp_resync_latency_skips``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from fedml_tpu.wan import __main__ as jmain
from fedml_tpu_torch.utils.convert import flax_to_state_dict
from fedml_tpu_torch.wan import __main__ as pmain

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROW = ("round", "cohort", "reported", "partial")


def test_the_steered_churn_leg_follows_jax(tmp_path, monkeypatch):
    jds, jmodule, jcfg = jmain.build_fixture()
    jcfg = dataclasses.replace(jcfg, shuffle=False)
    monkeypatch.setattr(jmain, "build_fixture",
                        lambda: (jds, jmodule, jcfg))
    theirs = jmain.run_churn_leg(str(tmp_path / "jax"),
                                 world=jmain.smoke_world(), backend="INPROC",
                                 port_base=None, pace_steering=True)
    init = jmodule.init(jax.random.key(0),
                        jnp.asarray(jds.train_data_global[0][:1]),
                        train=False)
    ds, model, cfg = pmain.build_fixture()
    cfg = dataclasses.replace(cfg, shuffle=False)
    monkeypatch.setattr(pmain, "build_fixture", lambda: (ds, model, cfg))
    ours = pmain.run_churn_leg(
        str(tmp_path / "port"), world=pmain.smoke_world(), backend="INPROC",
        port_base=None, pace_steering=True, device="cpu",
        init_variables=flax_to_state_dict(jax.tree.map(np.asarray, init),
                                          model))
    assert len(ours["ledger"]) == len(theirs["ledger"]) == 8
    assert [{k: r[k] for k in ROW} for r in ours["ledger"]] == \
        [{k: r[k] for k in ROW} for r in theirs["ledger"]]
    assert ours["ledger"][0]["deadline_s"] == \
        theirs["ledger"][0]["deadline_s"] == 2.0
    for leg in (ours, theirs):
        c, g = leg["counters"], leg["gauges"]
        assert len(leg["history"]) == 8
        assert c["ft_rejoins"] >= 1
        assert c["cp_resync_latency_skips"] >= 1
        assert c["cp_deadline_adjustments"] >= 1
        # the gauge is a high-water mark: an adjustment of the quorum alone
        # (before four latencies are in) records the base deadline
        assert 0.5 <= g["cp_steered_deadline_s"] <= 2.0
        assert 0.5 <= leg["ledger"][-1]["deadline_s"] < 2.0
    # the port's ledger file is the checkpointer's: one line a round
    assert (tmp_path / "port" / "ledger.jsonl").read_text().count("\n") == 8
    assert any((tmp_path / "port").glob("state_*.npz"))
