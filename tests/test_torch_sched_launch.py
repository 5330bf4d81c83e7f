"""One job through the port's scheduler (``fedml_tpu_torch/sched/
launcher.py``): bit for bit the plain ``run_fedavg_cross_silo`` launch,
close to the JAX package's ``launch_jobs`` from the same initialization,
and the launcher's refusals and gate switch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.sched import jobs as jjobs
from fedml_tpu.sched import launch_jobs as jax_launch_jobs
from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
    run_fedavg_cross_silo)
from fedml_tpu_torch.control import ServerControlCheckpointer
from fedml_tpu_torch.control.failover_harness import ledger_schedule
from fedml_tpu_torch.sched import (JobSpec, build_job_fixture, launch_jobs,
                                   run_one_job)
from fedml_tpu_torch.sched.chaos import model_blob
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)


def test_scheduler_path_bit_exact_vs_plain_launch(tmp_path):
    """One job through the scheduler (a virtual channel over the shared
    fabric and the device gate) gives the plain launch's history, ledger
    and final model bit for bit."""
    spec = JobSpec(id="solo", workers=2, rounds=4, seed=3, batch_size=8,
                   lr=0.2, compression="topk_ef_int8:0.1")
    ds, module, task, tcfg = build_job_fixture(spec)
    plain_dir = str(tmp_path / "plain")
    plain_model, plain_hist = run_fedavg_cross_silo(
        ds, module, task=task, worker_num=spec.workers,
        comm_round=spec.rounds, train_cfg=tcfg, seed=spec.seed,
        compression=spec.compression, checkpoint_dir=plain_dir,
        server_checkpoint_dir=plain_dir, device="cpu")
    plain_ledger = ServerControlCheckpointer(plain_dir).read_ledger()
    res = launch_jobs([spec], str(tmp_path / "sched"), obs=False,
                      device="cpu")
    sched = res["jobs"]["solo"]
    assert sched.get("error") is None
    assert sched["history"] == plain_hist
    assert sched["ledger"] == plain_ledger
    assert model_blob(sched["model"]) == model_blob(plain_model)
    # the device accounting reached the job's timer
    assert sched["counters"]["sched_device_acquires"] > 0
    assert sched["phases"].get("sched_device_time", 0) > 0
    assert res["device_time_s"]["solo"] > 0


def test_scheduled_job_matches_jax_launch_jobs(tmp_path):
    """The JAX package's ``launch_jobs`` and the port's on one spec, the
    JAX initialization carried across by the LR converter (full-batch
    local steps, so the two packages' batch orders cannot differ): the
    ledger schedule is equal, history and model agree."""
    obj = dict(id="par", workers=3, rounds=4, seed=7, dim=6, class_num=2,
               n_samples=150, batch_size=256, lr=0.1)
    jres = jax_launch_jobs([jjobs.spec_from_dict(obj)],
                           str(tmp_path / "jax"), obs=False)["jobs"]["par"]
    assert jres.get("error") is None
    jds, jmod, _, _ = jjobs.build_job_fixture(jjobs.spec_from_dict(obj))
    jinit = jmod.init(jax.random.key(obj["seed"]),
                      jnp.asarray(jds.train_data_global[0][:1]),
                      train=False)
    spec = JobSpec(**obj)
    _, module, _, _ = build_job_fixture(spec)
    init = flax_to_state_dict(jax.tree.map(np.asarray, jinit), module)
    res = run_one_job(spec, str(tmp_path / "port"), obs=False,
                      device="cpu", init_variables=init)
    assert ledger_schedule(res["ledger"]) == ledger_schedule(
        jres["ledger"])
    assert [r["reported"] for r in res["ledger"]] == [
        r["reported"] for r in jres["ledger"]]
    want = flax_to_state_dict(jax.tree.map(np.asarray, jres["model"]),
                              module)
    for k in want:
        np.testing.assert_allclose(res["model"][k].numpy(),
                                   want[k].numpy(), **TOL, err_msg=k)
    assert [r["round"] for r in res["history"]] == [
        r["round"] for r in jres["history"]]
    for got, exp in zip(res["history"], jres["history"]):
        np.testing.assert_allclose(got["test_loss"], exp["test_loss"],
                                   **TOL)
        assert got["test_acc"] == pytest.approx(exp["test_acc"], abs=1e-9)


def test_comm_factory_refuses_silently_dropped_transport_knobs():
    """``comm_factory`` supplies prebuilt endpoints: with a knob only
    ``create_comm_manager`` reads, the JAX package's ``ValueError``."""
    spec = JobSpec(id="knobs", workers=2, rounds=2, seed=1)
    ds, module, task, tcfg = build_job_fixture(spec)
    for knob, value in (("fault_plan", "drop:p=0.5"), ("token", b"t"),
                        ("addresses", {0: ("127.0.0.1", 1)}),
                        ("wire_codec", False)):
        with pytest.raises(ValueError, match=knob):
            run_fedavg_cross_silo(
                ds, module, task=task, worker_num=spec.workers,
                comm_round=spec.rounds, train_cfg=tcfg, seed=spec.seed,
                comm_factory=lambda rank: None, device="cpu",
                **{knob: value})


def test_gate_off_leaves_counters_silent(tmp_path):
    """``interleave=False`` runs without a gate: no ``sched_*`` series."""
    spec = JobSpec(id="raw", workers=2, rounds=2, seed=1)
    res = launch_jobs([spec], str(tmp_path / "raw"), obs=False,
                      interleave=False, device="cpu")
    row = res["jobs"]["raw"]
    assert row.get("error") is None
    assert not any(k.startswith("sched_") for k in row["counters"])
    assert not any(k.startswith("sched_") for k in row["phases"])
    assert res["device_time_s"] == {"raw": 0.0}


def test_a_serving_job_is_an_error_row_and_its_cotenant_finishes(tmp_path):
    specs = [JobSpec(id="srv", workers=2, rounds=2, seed=1, serve_port=0),
             JobSpec(id="ok", workers=2, rounds=3, seed=2)]
    res = launch_jobs(specs, str(tmp_path / "m"), obs=False, device="cpu")
    assert "NotImplementedError" in res["jobs"]["srv"]["error"]
    assert "23c" in res["jobs"]["srv"]["error"]
    ok = res["jobs"]["ok"]
    assert ok.get("error") is None
    assert [r["round"] for r in ok["ledger"]] == [0, 1, 2]
    with pytest.raises(NotImplementedError, match="23c"):
        run_one_job(specs[0], str(tmp_path / "one"), device="cpu")


def test_launch_refuses_duplicate_ids(tmp_path):
    with pytest.raises(ValueError, match="duplicate job ids"):
        launch_jobs([JobSpec(id="x"), JobSpec(id="x")], str(tmp_path),
                    device="cpu")


def test_default_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = launch_jobs([JobSpec(id="dev", workers=2, rounds=1)],
                      str(tmp_path), obs=False)
    assert "device='cpu'" in res["jobs"]["dev"]["error"]
