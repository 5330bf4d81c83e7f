"""The WAN world's protocol paths in the port: the total blackout that the
anti-starvation valve must carry through (the JAX package's
``tests/test_wan.py::TestChurnProtocol::test_total_blackout_never_deadlocks``),
the trace-deferred JOIN (BACKPRESSURE from the server, the silo's JOIN
deferred by ``join_retry_s``), and the WAN flags through ``fed_launch``.

The blackout: every device goes dark forever from sim time 120 s (round
2), so the virtual clock freezes with the round that cannot close. The
valve admits a silo after ``max_join_deferrals_per_round`` deferrals of
its JOIN in one round and forces its device online (the server's gates
and its agent), and the schedule completes. One run of 4 rounds at a
1.0 s deadline, shared by the blackout's tests.
"""

import threading
import time

import pytest

from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.wan import WanWorld, parse_wan_trace
from fedml_tpu_torch.wan.__main__ import run_churn_leg

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLACKOUT = "seed=1;peak=1.0;trough=1.0;duty_jitter=0.0;flap=120:100000:1.0"
JOIN_RETRY_S = 0.2
SMOKE_TRACE = ("seed=20;period_s=960;phase0_s=480;peak=0.98;trough=0.45;"
               "duty_jitter=0.05;slot_s=120;flap=60:120:0.5")


@pytest.fixture(scope="module")
def blackout():
    """The blackout run, with every BACKPRESSURE a silo handled (rank,
    retry, when) and every JOIN it sent (rank, when)."""
    backpressured, joins = [], []
    lock = threading.Lock()
    handle, send = (cs.FedAvgClientManager._handle_join_backpressure,
                    cs.FedAvgClientManager._send_join)

    def on_backpressure(self, msg):
        t = time.monotonic()
        handle(self, msg)
        with lock:
            backpressured.append((self.rank, float(msg.get(
                cs.MSG_ARG_KEY_RETRY_AFTER)), t, self._join_backoff_until))

    def on_join(self):
        with lock:
            joins.append((self.rank, time.monotonic()))
        send(self)
    world = WanWorld(trace=parse_wan_trace(BLACKOUT), round_s=60.0,
                     join_retry_s=JOIN_RETRY_S,
                     max_join_deferrals_per_round=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs.FedAvgClientManager, "_handle_join_backpressure",
                   on_backpressure)
        mp.setattr(cs.FedAvgClientManager, "_send_join", on_join)
        leg = run_churn_leg(None, world=world, backend="INPROC",
                            port_base=None, rounds=4, deadline_s=1.0,
                            device="cpu")
    return leg, backpressured, joins


def test_blackout_valve_completes_the_schedule(blackout):
    leg, _, _ = blackout
    c = leg["counters"]
    assert len(leg["history"]) == 4, \
        "the blackout must degrade the schedule, never stall it"
    assert len(leg["ledger"]) == 4
    assert c["ft_evictions"] >= 1
    assert c["ft_deadline_extensions"] >= 1
    assert c["wan_join_deferred"] >= 1
    # the valve forced devices online: a silo reported after the blackout
    assert any(row["reported"] for row in leg["ledger"][2:])


def test_deferred_join_gets_backpressure_and_the_silo_waits(blackout):
    leg, backpressured, joins = blackout
    assert len(backpressured) >= 1
    assert len(backpressured) <= leg["counters"]["wan_join_deferred"]
    for rank, retry, t, until in backpressured:
        assert retry == JOIN_RETRY_S
        assert until == pytest.approx(t + retry, abs=0.05)
        later = [tj for r, tj in joins if r == rank and tj > t]
        # the silo's next JOIN waits out the retry window
        assert not later or min(later) >= until - 1e-3


def test_fed_launch_runs_the_wan_world_on_the_cpu(tmp_path):
    import json
    fed_launch.main([
        "--algo", "fedavg_cross_silo", "--dataset", "blob", "--device",
        "cpu", "--client_num_in_total", "12", "--client_num_per_round",
        "3", "--comm_round", "3", "--batch_size", "16",
        "--round_deadline_s", "1.0", "--heartbeat_s", "0.1",
        "--wan_trace", SMOKE_TRACE, "--wan_profiles",
        "seed=5;compute_median_s=0.02", "--wan_round_s", "60",
        "--fault_plan", "seed=3;drop:p=0.0",
        "--run_dir", str(tmp_path / "run")])
    recs = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    summary = recs[-1]
    assert summary["summary"] == "cross_silo" and summary["rounds"] == 3
    assert 0.0 < summary["gauge_wan_available_frac"] <= 1.0


def test_wan_profiles_without_a_trace_raise():
    from fedml_tpu_torch.data.synthetic import make_blob_federated
    from fedml_tpu_torch.models import create_model
    ds = make_blob_federated(client_num=4, dim=8, class_num=3, seed=2)
    with pytest.raises(ValueError, match="--wan_profiles without "
                                         "--wan_trace"):
        cs.run_fedavg_cross_silo(ds, create_model("lr", 3, input_shape=(8,)),
                                 wan_profiles="compute_median_s=0.1",
                                 device="cpu")
    with pytest.raises(ValueError, match="--wan_profiles without"):
        fed_launch.main(["--algo", "fedavg_cross_silo", "--dataset", "blob",
                         "--device", "cpu", "--wan_profiles", "seed=1"])
