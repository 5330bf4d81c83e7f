"""Multi-job tenancy in the port (``fedml_tpu_torch/sched``): jobs in a
shared leg are bit for bit their solo legs, one shared obs dir reports
each tenant, the CLIs run, and the SIGKILL tenancy failover (the port of
``tests/test_sched.py``'s ``TestMultiJobTenancy`` and
``TestTenancyFailover``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from fedml_tpu_torch.obs.__main__ import main as obs_main
from fedml_tpu_torch.obs.report import summarize
from fedml_tpu_torch.sched import JobSpec, launch_jobs
from fedml_tpu_torch.sched.chaos import model_blob

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent

SPECS = [
    JobSpec(id="a", workers=2, rounds=3, seed=5, batch_size=8, lr=0.2,
            compression="delta_int8"),
    JobSpec(id="b", workers=3, rounds=4, seed=7, dim=6, class_num=2,
            n_samples=150, batch_size=10, lr=0.1,
            compression="topk_ef_int8:0.1", round_deadline_s=2.0,
            heartbeat_s=0.3),
    JobSpec(id="c", workers=2, rounds=3, seed=9, dim=10, class_num=4,
            n_samples=160, share=2.0, lr=0.15),
]


def _solo(specs, root, backend="INPROC"):
    out = {}
    for s in specs:
        res = launch_jobs([s], str(root / f"solo_{s.id}"), obs=False,
                          device="cpu", backend=backend)
        out[s.id] = res["jobs"][s.id]
        assert out[s.id].get("error") is None, out[s.id]
    return out


def _assert_solo_parity(shared, solo, ids):
    for j in ids:
        ten = shared["jobs"][j]
        assert ten.get("error") is None, ten
        assert ten["ledger"] == solo[j]["ledger"]
        assert ten["history"] == solo[j]["history"]
        assert model_blob(ten["model"]) == model_blob(solo[j]["model"])


def test_three_jobs_shared_fabric_solo_parity(tmp_path):
    """Three concurrent jobs (other shapes, rounds, shares and wire
    policies) over one fabric: each is bit for bit its solo run, and the
    one shared obs dir reports each tenant."""
    solo = _solo(SPECS, tmp_path)
    shared = launch_jobs(SPECS, str(tmp_path / "shared"), obs=True,
                         device="cpu")
    _assert_solo_parity(shared, solo, "abc")
    rep = summarize([str(tmp_path / "shared" / "obs")])
    assert set(rep["jobs"]) >= {"a", "b", "c"}
    for job in "abc":
        assert rep["jobs"][job]["rounds"] > 0
    assert all(shared["device_time_s"][j] > 0 for j in "abc")
    assert shared["fairness_ratio_raw"] is not None


def test_two_jobs_over_a_tcp_fabric_equal_their_solo_runs(tmp_path):
    specs = SPECS[:2]
    solo = _solo(specs, tmp_path, backend="TCP")
    shared = launch_jobs(specs, str(tmp_path / "shared"), obs=False,
                         device="cpu", backend="TCP")
    _assert_solo_parity(shared, solo, "ab")
    # and the in-process fabric's bits are the same
    inproc = launch_jobs(specs, str(tmp_path / "inproc"), obs=False,
                         device="cpu")
    _assert_solo_parity(inproc, solo, "ab")


def test_obs_job_filter_on_shared_dir(tmp_path):
    """``obs merge --job`` and ``obs report --job`` inspect one tenant of a
    shared obs dir, and the merge checks that tenant's ledger."""
    specs = [JobSpec(id="x", workers=2, rounds=2, seed=1),
             JobSpec(id="y", workers=2, rounds=2, seed=2)]
    launch_jobs(specs, str(tmp_path / "m"), obs=True, device="cpu")
    obs_root = str(tmp_path / "m" / "obs")
    out = str(tmp_path / "merged.json")
    rc = obs_main(["merge", obs_root, "--job", "x", "--output", out,
                   "--ledger", str(tmp_path / "m" / "job_x" /
                                   "ledger.jsonl")])
    assert rc == 0
    with open(out) as f:
        merged = json.load(f)
    assert merged["job_ids"] == ["x"]
    assert len(merged["rounds"]) == 2
    rc = obs_main(["report", obs_root, "--job", "y",
                   "--output", str(tmp_path / "rep.json")])
    assert rc == 0
    with open(tmp_path / "rep.json") as f:
        rep = json.load(f)
    assert sorted(rep["jobs"]) == ["y"]
    assert obs_main(["tail", obs_root, "--job", "x", "--once"]) == 0


def _cli(args, tmp_path, timeout=120):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-m", "fedml_tpu_torch.sched",
                           *args], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_launch_cli_runs_every_job(tmp_path):
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps({"jobs": [s.to_json() for s in SPECS[:2]]}))
    proc = _cli(["launch", "--jobs", str(jobs), "--base_dir",
                 str(tmp_path / "run"), "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout)
    assert {j: r["rounds_completed"] for j, r in out["jobs"].items()} == {
        "a": 3, "b": 4}
    assert set(out["device_time_s"]) == {"a", "b"}


def test_smoke_cli_kills_a_tenant_server_and_spares_the_other(tmp_path):
    proc = _cli(["smoke", "--device", "cpu", "--root",
                 str(tmp_path / "smoke")], tmp_path, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert out["tenancy_smoke"] == "ok"
    victim = out["jobs"]["jobb"]
    assert victim["cp_restores"] >= 1
    assert victim["killed_at_round"] == 2
    assert victim["rounds_completed"] == 8
    assert len(victim["incarnations"]) == 2
    assert out["jobs"]["joba"]["model_identical_to_solo"]
    assert out["obs_report_jobs"] == ["joba", "jobb"]


@pytest.mark.slow
def test_sigkill_one_tenant_spares_the_rest(tmp_path):
    """The chaos acceptance with the JAX suite's three default jobs: a real
    SIGKILL of one job's server mid-schedule; both other jobs bit for bit
    their solo runs, the killed job restored and complete."""
    from fedml_tpu_torch.sched.chaos import run_tenancy_failover
    res = run_tenancy_failover(str(tmp_path / "chaos"), device="cpu")
    assert res["ok"], json.dumps(res["jobs"], indent=2)
    victim = res["jobs"][res["victim"]]
    assert victim["cp_restores"] >= 1
    assert victim["killed_at_round"] is not None
    survivors = [j for j, row in res["jobs"].items()
                 if row["role"] == "survivor"]
    assert len(survivors) == 2
    for j in survivors:
        assert res["jobs"][j]["ledger_identical_to_solo"]
        assert res["jobs"][j]["model_identical_to_solo"]
