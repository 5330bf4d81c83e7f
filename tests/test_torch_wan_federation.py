"""The WAN slice as a whole against the JAX package: the JAX smoke
fixture (LR on blobs, 4 silos, 8 rounds, ``SMOKE_TRACE``,
``SMOKE_PROFILES``, a 2.0 s deadline) through each package's
``run_churn_leg`` on the in-process router.

The schedule is a pure function of the trace: the cohorts, which silos
are dark at each deadline, and the rounds where deferred JOINs are
re-admitted. So the two ledgers are equal row for row on ``round``,
``cohort``, ``reported`` and ``partial``, and so are the counters the
trace decides. Both sides start from the same weights (the JAX
initialization, carried by ``utils/convert.py``) and train without
shuffling (the port's batch orders come from its own seed chain), so the
final models agree at the cross-silo files' tolerance (rtol 1e-5,
atol 1e-6). One JAX leg and one port leg, about 20 s together.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fedml_tpu.algorithms import fedavg_cross_silo as jcs
from fedml_tpu.wan import __main__ as jmain
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.utils.convert import flax_to_state_dict
from fedml_tpu_torch.wan import __main__ as pmain

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
#: the counters the trace decides (the rest count heartbeats, retries and
#: JOIN resyncs, which follow the wall clock)
TRACE_COUNTERS = ("wan_cohort_rejections", "wan_forced_cohorts",
                  "wan_offline_drops", "wan_mass_joins", "wan_mass_leaves",
                  "wan_mass_join_throttled", "ft_evictions", "ft_rejoins",
                  "ft_partial_rounds")


def _keep_final(monkeypatch, module):
    """Record the final model ``run_churn_leg``'s launcher returns."""
    run, out = module.run_fedavg_cross_silo, {}

    def keep(*a, **kw):
        out["final"], history = run(*a, **kw)
        return out["final"], history
    monkeypatch.setattr(module, "run_fedavg_cross_silo", keep)
    return out


def test_smoke_fixture_follows_jax(tmp_path, monkeypatch):
    jds, jmodule, jcfg = jmain.build_fixture()
    jcfg = dataclasses.replace(jcfg, shuffle=False)
    monkeypatch.setattr(jmain, "build_fixture",
                        lambda: (jds, jmodule, jcfg))
    jout = _keep_final(monkeypatch, jcs)
    theirs = jmain.run_churn_leg(str(tmp_path / "jax"),
                                 world=jmain.smoke_world(),
                                 backend="INPROC", port_base=None)
    init = jmodule.init(jax.random.key(0),
                        jnp.asarray(jds.train_data_global[0][:1]),
                        train=False)

    ds, model, cfg = pmain.build_fixture()
    cfg = dataclasses.replace(cfg, shuffle=False)
    monkeypatch.setattr(pmain, "build_fixture", lambda: (ds, model, cfg))
    init = flax_to_state_dict(jax.tree.map(np.asarray, init), model)
    pout = _keep_final(monkeypatch, cs)
    ours = pmain.run_churn_leg(
        str(tmp_path / "port"), world=pmain.smoke_world(), backend="INPROC",
        port_base=None, init_variables=init, device="cpu")

    def rows(ledger):
        return [{k: r[k] for k in ("round", "cohort", "reported", "partial")}
                for r in ledger]
    assert len(ours["ledger"]) == len(theirs["ledger"]) == 8
    assert rows(ours["ledger"]) == rows(theirs["ledger"])
    assert [r["deadline_s"] for r in ours["ledger"]] == [2.0] * 8
    c, jc = ours["counters"], theirs["counters"]
    assert {k: c.get(k, 0) for k in TRACE_COUNTERS} == {
        k: jc.get(k, 0) for k in TRACE_COUNTERS}
    # the JAX package's test_diurnal_trough_degrades_but_never_stalls
    assert len(ours["history"]) == 8
    assert c["ft_evictions"] >= 1 and c["ft_rejoins"] >= 1
    assert c["ft_partial_rounds"] >= 1 and c["wan_offline_drops"] >= 1
    assert c.get("wan_forced_cohorts", 0) == 0
    assert pmain.cohorts_all_available(ours["ledger"], ours["world"])
    assert c["wan_mass_joins"] >= 1 and c["wan_mass_join_throttled"] >= 1
    assert ours["gauges"]["wan_available_frac"] == \
        theirs["gauges"]["wan_available_frac"]
    assert (tmp_path / "port" / "ledger.jsonl").read_text().count("\n") == 8
    want = flax_to_state_dict(jax.tree.map(np.asarray, jout["final"]), model)
    for k, v in want.items():
        torch.testing.assert_close(pout["final"][k], v, **TOL)
    for got, exp in zip(ours["history"], theirs["history"]):
        assert got["round"] == exp["round"]
        np.testing.assert_allclose(got["test_loss"], exp["test_loss"],
                                   rtol=1e-5)
