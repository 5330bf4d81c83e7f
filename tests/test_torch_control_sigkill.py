"""The real SIGKILL: the port's cross-silo server runs as a subprocess over
loopback TCP (``python -m fedml_tpu_torch.control.failover_harness --role
server --device cpu``), is killed with SIGKILL once round 2 has closed,
started again with the same flags, restores its newest snapshot and
finishes the schedule; its ledger schedule equals an unkilled run's
(the JAX package's ``TestSigkillChaosAcceptance``,
``tests/test_control_plane.py:813-838``, and its ``--smoke``). The
variant with a third of the fleet flapping on broadcasts is marked
``slow``, as the JAX package's is."""

import pytest

from fedml_tpu_torch.control import failover_harness as fh

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORKERS = fh.DEFAULT_WORKERS


def _reference(tmp_path, rounds):
    _, ledger, _ = fh.run_simulated_failover(
        str(tmp_path / "ref"), rounds=rounds, crash_at_round=10**9,
        backend="TCP", port_base=fh.free_port_base(WORKERS + 1),
        deadline_s=2.0, device="cpu")
    return ledger


def _kill(tmp_path, rounds, **kw):
    return fh.run_failover_scenario(
        str(tmp_path / "kill"), rounds=rounds, kill_after_round=2,
        port_base=fh.free_port_base(WORKERS + 1), deadline_s=2.0,
        device="cpu", timeout_s=120.0, **kw)


def test_sigkill_mid_schedule_restores_and_completes(tmp_path):
    ref = _reference(tmp_path, 6)
    res = _kill(tmp_path, 6)
    summary = res["summary"]
    assert summary["done"] is True and summary["rounds_completed"] == 6
    assert summary["cp_counters"].get("restores", 0) >= 1
    assert res["killed_at_round"] == 2 and res["restart_rc"] == 0
    assert fh.ledger_schedule(res["ledger"]) == fh.ledger_schedule(ref)
    assert summary["error"] is None


@pytest.mark.slow
def test_sigkill_mid_schedule_with_silo_flap(tmp_path):
    ref = _reference(tmp_path, 8)
    res = _kill(tmp_path, 8, silo_fault_plan=(
        "seed=13;disconnect:direction=recv,receiver=3,msg_type=2,p=0.3,"
        "duration_ms=800"))
    assert res["summary"]["done"] is True
    assert res["summary"]["rounds_completed"] == 8
    assert res["summary"]["cp_counters"].get("restores", 0) >= 1
    assert res["killed_at_round"] == 2
    assert fh.ledger_schedule(res["ledger"]) == fh.ledger_schedule(ref)


def test_smoke_cli_recovers(tmp_path, capsys):
    """``--smoke --device cpu``: exit 0 with the recovery's JSON line."""
    import json
    assert fh.main(["--smoke", "--device", "cpu", "--ckpt_dir",
                    str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["server_failover_smoke"] == "ok"
    assert out["cp_restores"] >= 1 and out["ledger_matches_reference"]
