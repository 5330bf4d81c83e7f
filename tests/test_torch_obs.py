"""The port's flight recorder (fedml_tpu_torch/obs) against the JAX
package's (fedml_tpu/obs), with the same inputs.

- Cross-reading, both ways: a log the port writes is the JAX package's
  format byte for byte, and each package's readers (``read_flight_log``,
  ``merge_flight_logs``, ``obs.report.summarize``, the tail) give the same
  rows on the other's log: torn lines, rotation and two epochs included.
- The pure observer: the port's FedAvgAPI on a small CNN runs 3 rounds with
  obs on and off, bit for bit equal; round and perf records as the JAX
  driver writes them, MFU = (round_flops / duration) / peak within rtol
  1e-3 under a pinned ``FEDML_TPU_PEAK_FLOPS``; the FLOP probe draws no
  RNG and writes no state. The cross-silo recorder over INPROC and TCP.
- The cases of ``tests/test_obs.py`` for each ported part (timer
  timeline, recorder, merge with a ledger the test writes, anomaly
  detector, one-shot profiler on the CPU profiler, build_observability,
  the perf oracles, the tail, the CLI's exit codes), each run on both
  packages and compared, and the cases of ``tests/test_trend.py`` that
  do not drive ``bench.py``.
"""

import contextlib
import errno
import io
import json
import os
import re
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import fedml_tpu.obs as J
import fedml_tpu_torch.obs as P
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.obs import __main__ as jcli
from fedml_tpu.obs import registry as jregistry
from fedml_tpu.obs import report as jreport
from fedml_tpu.obs import tail as jtail
from fedml_tpu.obs import trend as jtrend
from fedml_tpu.utils.tracing import RoundTimer as JaxRoundTimer
from fedml_tpu_torch.algorithms import fedavg_cross_silo as cs
from fedml_tpu_torch.algorithms.fedavg import (FLOPS_SOURCE, FedAvgAPI,
                                               FedAvgConfig)
from fedml_tpu_torch.core import sampling
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import CNN_DropOut, create_model
from fedml_tpu_torch.obs import __main__ as pcli
from fedml_tpu_torch.obs import perf as pperf
from fedml_tpu_torch.obs import registry as pregistry
from fedml_tpu_torch.obs import report as preport
from fedml_tpu_torch.obs import tail as ptail
from fedml_tpu_torch.obs import trend as ptrend
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils import flops
from fedml_tpu_torch.utils.tracing import RoundTimer

ROOT = Path(__file__).resolve().parent.parent
PKGS = {"port": P, "jax": J}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())
            if p.is_file()}


# -- cross-reading ----------------------------------------------------------
def _torn(obs, d):
    rec = obs.FlightRecorder(d, job_id="t", rank=0, epoch=3)
    rec.append({"kind": "round", "round": 0, "duration_s": 0.5})
    rec.append({"kind": "round", "round": 1, "duration_s": 0.25})
    rec.close()
    with open(rec.path, "a") as f:
        f.write('{"kind": "round", "round": 2, "trunc')  # a kill mid-write


def _rotated(obs, d):
    rec = obs.FlightRecorder(d, job_id="r", rank=1, epoch=5, rotate_lines=5,
                             keep_last_n=2)
    for r in range(23):
        rec.append({"kind": "round", "round": r, "client_idx": r % 4,
                    "train_s": 0.001 * r})
    rec.close()


def _two_epochs(obs, d):
    """Two server lives on one log, a silo, perf records, numpy values."""
    silo = obs.FlightRecorder(d, job_id="j", rank=1, epoch=70)
    for life, rounds in ((1, range(3)), (2, [2])):
        srv = obs.FlightRecorder(d, job_id="j", rank=0, epoch=life)
        for r in rounds:
            if life == 1:
                silo.append({"kind": "round", "round": r, "train_s": 0.01})
            srv.append({"kind": "silo", "round": r, "silo_rank": 1,
                        "event": "reply", "report_latency_s": 0.02,
                        "digest": {"rounds_completed": np.int64(r)}})
            srv.append({"kind": "round", "round": r,
                        "duration_s": 0.5 + 0.2 * (life - 1),
                        "phases": {"fold": {"s": 0.1, "n": 2}},
                        "counters": {"comm_bytes_up": 1000 // life,
                                     "comm_bytes_down": 3000 // life},
                        "gauges": {}, "cohort": [r], "reported": [0],
                        "partial": life == 2})
            srv.append({"kind": "perf", "round": r, "duration_s": 0.5,
                        "mfu": 0.1 * (r + 1) / life,
                        "wire_bytes_per_sec_up": np.float32(2000.0)})
        srv.close()
    silo.close()


SCENARIOS = {"torn": _torn, "rotated": _rotated, "two_epochs": _two_epochs}


def _pin_clock(monkeypatch):
    """Both recorders stamp ``t_wall`` from ``time.time()``: restarted at
    the same instant for each, their files compare byte for byte."""
    clock = iter(np.arange(1.7e9, 1.7e9 + 1000, 0.25))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_port_log_is_the_jax_format_byte_for_byte(scenario, tmp_path,
                                                  monkeypatch):
    port, ref = tmp_path / "port", tmp_path / "jax"
    _pin_clock(monkeypatch)
    SCENARIOS[scenario](P, str(port))
    _pin_clock(monkeypatch)
    SCENARIOS[scenario](J, str(ref))
    assert _files(port) == _files(ref)
    assert len(_files(port)) >= 1


def _read_all(obs, tools, d):
    """Every reader's view of a directory: per-rank rows, the merge, the
    per-job report and the tail's fold."""
    paths = obs.flight_log_paths(d)
    tailer = tools["tail"].TimelineTailer(d)
    tailer.poll()
    view = {"rows": {os.path.basename(p): obs.read_flight_log(p)
                     for p in paths},
            "merge": obs.merge_flight_logs([d]),
            "report": tools["report"].summarize([d]),
            "tail": tailer.merged()}
    tailer.close()
    return view


TOOLS = {"port": {"tail": ptail, "report": preport},
         "jax": {"tail": jtail, "report": jreport}}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_each_package_reads_the_others_log(writer, scenario, tmp_path):
    SCENARIOS[scenario](PKGS[writer], str(tmp_path))
    port = _read_all(P, TOOLS["port"], str(tmp_path))
    ref = _read_all(J, TOOLS["jax"], str(tmp_path))
    assert port == ref
    rows = [r for v in port["rows"].values() for r in v]
    if scenario == "torn":
        assert [r["round"] for r in rows] == [0, 1]
    if scenario == "rotated":
        got = [r["round"] for r in rows]
        assert got == list(range(got[0], 23)) and len(got) >= 10
    if scenario == "two_epochs":
        srv = port["merge"]["rounds"][2]["server"]
        assert srv["epoch"] == 2 and srv["partial"] is True
        assert port["report"]["jobs"]["j"]["server_epochs"] == [1, 2]
        assert port["report"]["jobs"]["j"]["wire"]["bytes_up"] == 2500


# -- the pure observer: the simulation --------------------------------------
def _image_federation(sizes, seed=0):
    rng = np.random.RandomState(seed)
    train, test = {}, {}
    for c, n in enumerate(sizes):
        x = rng.rand(n, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 62, n).astype(np.int32)
        train[c], test[c] = (x, y), (x[:3], y[:3])
    return FederatedDataset.from_client_arrays(train, test, 62)


def _cnn_api(obs_dir=None):
    # clients of 3, 2 and 1 real steps: each round's cohort bills its own
    return FedAvgAPI(_image_federation([24, 16, 8]),
                     CNN_DropOut(only_digits=False), device="cpu",
                     config=FedAvgConfig(
                         comm_round=3, client_num_per_round=2,
                         frequency_of_the_test=100, obs_dir=obs_dir,
                         job_id="sim" if obs_dir else None,
                         train=TrainConfig(epochs=1, batch_size=8, lr=0.1)))


def test_sim_cnn_is_bit_exact_with_obs_and_records_mfu(tmp_path,
                                                       monkeypatch):
    # a pinned per-device peak, so the CPU run derives MFU (the table
    # lists NVIDIA cards only)
    monkeypatch.setenv("FEDML_TPU_PEAK_FLOPS", "1e12")
    # the observed run first, with the dropout counters' cache empty: the
    # probe runs before any real round has filled it
    monkeypatch.setattr(sampling, "_WEYL", {})
    obs_dir = tmp_path / "obs"
    api = _cnn_api(str(obs_dir))
    rng = torch.get_rng_state()
    # one armed window: the next round is traced on the CPU profiler
    api._obs.note_anomaly("test", 0)
    for r in range(3):
        api.run_round(r)
    assert torch.equal(torch.get_rng_state(), rng)  # the probe drew none
    assert sampling._WEYL and not any(map(flops.is_fake,
                                          sampling._WEYL.values()))
    clean = _cnn_api()
    for r in range(3):
        clean.run_round(r)
    # the full count of each round as the host loop ran it
    want_flops = []
    for r in range(3):
        _, (x, y, mask, w, plan, agg) = clean._prepare_round(r)
        want_flops.append(flops.analytic_flops(
            api._round_fn, api.variables, x, y, mask, w, plan, agg, None))
    assert len(set(want_flops)) > 1  # the cohorts differ in work
    for k in clean.variables:
        assert torch.equal(api.variables[k], clean.variables[k]), k
    rows = P.read_flight_log(str(obs_dir / "flight_rank0.jsonl"))
    rounds = [r for r in rows if r["kind"] == "round"]
    assert [r["round"] for r in rounds] == [0, 1, 2]
    assert all(len(r["cohort"]) == 2 and r["job_id"] == "sim"
               for r in rounds)
    assert all(r["phases"]["dispatch"]["n"] == 1 for r in rounds)
    perfs = [r for r in rows if r["kind"] == "perf"]
    assert [p["round"] for p in perfs] == [0, 1, 2]
    for p in perfs:
        assert p["flops_source"] == FLOPS_SOURCE
        assert p["round_flops"] == want_flops[p["round"]] > 0
        assert p["peak_flops"] == 1e12 and 0 < p["mfu"] < 1
        np.testing.assert_allclose(
            p["mfu"], (p["round_flops"] / p["duration_s"]) / 1e12,
            rtol=1e-3)
    # the anomaly record, and the window it armed over round 0
    assert [r["reason"] for r in rows if r["kind"] == "anomaly"] == [
        "test"]
    trace = obs_dir / "profiles" / "round_000000" / "trace.json"
    assert "aten::convolution" in trace.read_text()
    assert api.timer.counters["obs_profiled_rounds"] == 1


def test_sim_records_have_the_jax_drivers_layout(tmp_path, monkeypatch):
    """The same LR federation through both simulation drivers with obs on:
    the same record kinds and keys, the same cohorts."""
    from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
    from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
    from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
    from fedml_tpu.models.lr import LogisticRegression
    from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
    monkeypatch.setenv("FEDML_TPU_PEAK_FLOPS", "1e12")
    rounds = dict(comm_round=3, client_num_per_round=3)
    ref = JaxFedAvgAPI(jax_blob(client_num=6, seed=1),
                       LogisticRegression(num_classes=3),
                       config=JaxFedAvgConfig(
                           obs_dir=str(tmp_path / "jax"), job_id="j",
                           train=JaxTrainConfig(batch_size=16, lr=0.1),
                           **rounds))
    ds = make_blob_federated(client_num=6, seed=1)
    api = FedAvgAPI(ds, create_model("lr", ds.class_num, input_shape=(20,)),
                    device="cpu", config=FedAvgConfig(
                        obs_dir=str(tmp_path / "port"), job_id="j",
                        train=TrainConfig(batch_size=16, lr=0.1), **rounds))
    for r in range(3):
        ref.run_round(r)
        api.run_round(r)
    got = P.read_flight_log(str(tmp_path / "port" / "flight_rank0.jsonl"))
    want = J.read_flight_log(str(tmp_path / "jax" / "flight_rank0.jsonl"))
    assert [(r["kind"], r["round"]) for r in got] == [
        (r["kind"], r["round"]) for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        if g["kind"] == "round":
            assert g["cohort"] == w["cohort"]
            assert set(g["phases"]) == set(w["phases"])


# -- the cross-silo recorder -------------------------------------------------
def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return {r: ("127.0.0.1", s.getsockname()[1])
                for r, s in enumerate(socks)}
    finally:
        for s in socks:
            s.close()


def _federation(obs_dir=None, backend="INPROC"):
    ds = make_blob_federated(client_num=4, seed=0)
    kw = dict(worker_num=2, comm_round=2, compression="delta_int8",
              train_cfg=TrainConfig(batch_size=16, lr=0.1), device="cpu",
              obs_dir=obs_dir, join_timeout_s=60)
    for attempt in range(3):  # a free port may be taken before its bind
        addresses = _free_ports(3) if backend == "TCP" else None
        try:
            model, _ = cs.run_fedavg_cross_silo(
                ds, create_model("lr", ds.class_num, input_shape=(20,)),
                backend=backend, addresses=addresses, **kw)
            return model
        except OSError as exc:
            if exc.errno != errno.EADDRINUSE or attempt == 2:
                raise


@pytest.mark.parametrize("backend", ["INPROC", "TCP"])
def test_cross_silo_recorder_is_a_pure_observer(backend, tmp_path):
    clean = _federation(backend=backend)
    obs_dir = str(tmp_path / "obs")
    observed = _federation(obs_dir, backend)
    for k in clean:
        assert torch.equal(observed[k], clean[k]), k
    assert sorted(os.listdir(obs_dir)) == [
        "flight_rank0.jsonl", "flight_rank1.jsonl", "flight_rank2.jsonl"]
    merged = P.merge_flight_logs([obs_dir])
    assert merged == J.merge_flight_logs([obs_dir])
    assert len(merged["job_ids"]) == 1 and merged["unmatched"] == []
    assert [r["round"] for r in merged["rounds"]] == [0, 1]
    for row in merged["rounds"]:
        srv = row["server"]
        assert srv["reported"] == [0, 1] and srv["partial"] is False
        assert srv["counters"]["comm_bytes_up"] > 0
        assert row["perf"]["wire_bytes_per_sec_up"] > 0
        assert sorted(row["silo_rounds"]) == [1, 2]
        reports = sorted(row["silo_reports"], key=lambda r: r["silo_rank"])
        assert [r["silo_rank"] for r in reports] == [1, 2]
        for rep in reports:
            assert rep["report_latency_s"] > 0
            assert rep["digest"]["rounds_completed"] == row["round"]
            assert rep["digest"]["bytes_down"] > 0
            assert rep["digest"]["epoch"] > 0
    # the merge tool's CLI over the directory exits clean
    with contextlib.redirect_stdout(io.StringIO()):
        assert pcli.main(["merge", obs_dir]) == 0


# -- tests/test_obs.py, case by case on both packages ------------------------
def _strip(rec):
    """A round record without its wall-clock duration."""
    return {k: v for k, v in rec.items() if k != "duration_s"}


def _timer_scenario(timer_cls, name):
    timer = timer_cls(ring_capacity=8) if name == "ring" else timer_cls()
    if name == "concurrent":
        timer.begin_round(0)

        def worker(tid):
            for i in range(500):
                timer.count("prefetch_hit")
                timer.add("prefetch_wait", 0.001)
                timer.gauge("host_rss_peak_mb", float(tid * 500 + i))
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rec = timer.end_round(0)
        rec["phases"]["prefetch_wait"]["s"] = round(
            rec["phases"]["prefetch_wait"]["s"], 6)
        return [_strip(rec)], dict(timer.counters), dict(timer.gauges)
    if name == "delta":
        out = []
        for r, n in ((0, 3), (1, 2)):
            timer.begin_round(r)
            timer.count("ft_retries", n)
            out.append(_strip(timer.end_round(r)))
        return out, dict(timer.counters), {}
    if name == "ring":
        for r in range(50):
            timer.begin_round(r)
            timer.end_round(r)
        return [_strip(r) for r in timer.round_records()], {}, {}
    # mismatched ends degrade to no record; a superseding begin wins
    got = [timer.end_round(0)]
    timer.begin_round(3)
    got.append(timer.end_round(4))
    timer.begin_round(5)
    timer.begin_round(6)
    got.append(_strip(timer.end_round(6)))
    return got, {}, {}


@pytest.mark.parametrize("name", ["concurrent", "delta", "ring",
                                  "mismatch"])
def test_round_timer_timeline_matches_jax(name):
    got = _timer_scenario(RoundTimer, name)
    assert got == _timer_scenario(JaxRoundTimer, name)
    records = got[0]
    if name == "concurrent":
        assert records[0]["counters"]["prefetch_hit"] == 2000
        assert got[2]["host_rss_peak_mb"] == 1999.0
    if name == "delta":
        assert [r["counters"]["ft_retries"] for r in records] == [3, 2]
    if name == "ring":
        assert [r["round"] for r in records] == list(range(42, 50))
    if name == "mismatch":
        assert records[:2] == [None, None] and records[2]["round"] == 6


def test_round_timer_flight_binding_and_report():
    flushed = []

    class Sink:
        append = flushed.append
    timer = RoundTimer()
    timer.bind_flight(Sink())
    timer.begin_round(0)
    timer.add("pack", 0.002)
    timer.count("prefetch_miss")
    rec = timer.end_round(0)
    assert flushed == [rec]
    timer.bind_flight(None)
    timer.begin_round(1)
    timer.end_round(1)
    assert len(flushed) == 1
    ref = JaxRoundTimer()
    ref.add("pack", 0.002)
    ref.count("prefetch_miss")
    assert timer.report() == ref.report()


def _recorder_case(obs, d, name):
    if name == "stamped":
        rec = obs.FlightRecorder(d, job_id="j1", rank=2, epoch=77)
        rec.append({"kind": "round", "round": 0})
        rec.append({"kind": "anomaly", "round": 1, "reason": "stall"})
        rows = obs.read_flight_log(rec.path)
        assert [r["seq"] for r in rows] == [1, 2]
        assert all(r["job_id"] == "j1" and r["rank"] == 2
                   and r["epoch"] == 77 for r in rows)
    elif name == "rotated_away":
        rec = obs.FlightRecorder(d, rank=0, rotate_lines=2, keep_last_n=4)
        rec.append({"kind": "round", "round": 0})
        rec.append({"kind": "round", "round": 1})  # seals; no live file
        assert not os.path.exists(rec.path)
        assert obs.flight_log_paths(d) == [rec.path]
        rows = obs.read_flight_log(rec.path)
        assert [r["round"] for r in obs.merge_flight_logs([d])[
            "rounds"]] == [0, 1]
    elif name == "restart":
        a = obs.FlightRecorder(d, rank=0, epoch=1)
        a.append({"kind": "round", "round": 0})
        b = obs.FlightRecorder(d, rank=0, epoch=2)
        b.append({"kind": "round", "round": 0})
        rows = obs.read_flight_log(a.path)
        assert [r["epoch"] for r in rows] == [1, 2]
    else:  # append never raises: an unserializable record is dropped
        rec = obs.FlightRecorder(d, rank=0)
        rec.append({"bad": object()})
        rows = obs.read_flight_log(rec.path)
        assert rows == []
    return [{k: v for k, v in r.items() if k != "t_wall"} for r in rows]


@pytest.mark.parametrize("name", ["stamped", "rotated_away", "restart",
                                  "never_raises"])
def test_flight_recorder_matches_jax(name, tmp_path):
    assert _recorder_case(P, str(tmp_path / "p"), name) == _recorder_case(
        J, str(tmp_path / "j"), name)


SCHEDULE = [(0, [0, 1], [0, 1], False),
            (1, [2, 3], [0], True),     # silo 2 missed the deadline
            (2, [4, 5], [0, 1], False)]


def _plant(obs, d, schedule=SCHEDULE):
    """Server + 2 silo flight logs of a KNOWN schedule."""
    srv = obs.FlightRecorder(d, job_id="chaos", rank=0, epoch=9)
    silos = {r: obs.FlightRecorder(d, job_id="chaos", rank=r,
                                   epoch=100 + r) for r in (1, 2)}
    for rnd, cohort, reported, partial in schedule:
        for w in reported:
            srv.append({"kind": "silo", "round": rnd, "silo_rank": w + 1,
                        "event": "reply", "report_latency_s": 0.01,
                        "digest": {"rounds_completed": rnd}})
            silos[w + 1].append({"kind": "round", "round": rnd,
                                 "client_idx": cohort[w], "train_s": 0.02})
        srv.append({"kind": "round", "round": rnd, "duration_s": 0.05,
                    "phases": {}, "counters": {}, "gauges": {},
                    "cohort": cohort, "reported": reported,
                    "partial": partial, "evictions": 0})
    return srv


def _ledger(path, schedule=SCHEDULE):
    """A control-plane ledger as the JAX package writes one (one JSON line
    a round); the port's control plane is ROADMAP item 23."""
    with open(path, "w") as f:
        for rnd, cohort, reported, partial in schedule:
            f.write(json.dumps({"round": rnd, "cohort": cohort,
                                "reported": reported, "partial": partial,
                                "deadline_s": 1.0}) + "\n")
    return path


def test_merge_aligns_a_known_schedule_and_checks_the_ledger(tmp_path):
    _plant(P, str(tmp_path))
    merged = P.merge_flight_logs([str(tmp_path)])
    assert merged == J.merge_flight_logs([str(tmp_path)])
    assert [r["round"] for r in merged["rounds"]] == [0, 1, 2]
    r1 = merged["rounds"][1]
    assert r1["server"]["partial"] is True and len(r1["silo_reports"]) == 1
    assert sorted(r1["silo_rounds"]) == [1]
    ledger = [json.loads(line) for line in open(
        _ledger(tmp_path / "ledger.jsonl"))]
    assert P.check_against_ledger(merged, ledger) == []
    bad = [dict(r) for r in ledger]
    bad[1].update(partial=False, reported=[0, 1])
    problems = P.check_against_ledger(merged, bad)
    assert problems == J.check_against_ledger(merged, bad)
    assert len(problems) == 2


def test_merge_keeps_the_last_reclose(tmp_path):
    srv = _plant(P, str(tmp_path), SCHEDULE[:1])
    srv.append({"kind": "round", "round": 0, "duration_s": 0.07,
                "cohort": [0, 1], "reported": [1], "partial": True,
                "evictions": 1})
    merged = P.merge_flight_logs([str(tmp_path)])
    assert merged["rounds"][0]["server"]["reported"] == [1]
    assert merged == J.merge_flight_logs([str(tmp_path)])


def _cli(cli, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv, rc", [
    (["merge", "{d}", "--ledger", "{d}/ledger.jsonl"], 0),
    (["merge", "{d}", "--ledger", "{d}/bad.jsonl"], 1),
    (["merge", "{d}/empty"], 2),
    (["merge", "{d}", "--format", "csv"], 0),
    (["merge", "{d}", "--format", "json"], 0),
    (["tail", "{d}", "--once"], 0),
    (["tail", "{d}/empty", "--once"], 2),
    (["report", "{d}"], 0),
    (["report", "{d}", "--format", "markdown"], 0),
    (["report", "{d}/empty"], 2),
    (["trend", "{d}/trends.jsonl", "--check-latest", "--require-rows"], 2),
    (["registry"], 0)])
def test_cli_exit_codes_and_output_match_jax(argv, rc, tmp_path):
    d = str(tmp_path)
    _plant(P, d)
    _ledger(tmp_path / "ledger.jsonl")
    _ledger(tmp_path / "bad.jsonl", SCHEDULE + [(9, [1], [0], False)])
    (tmp_path / "empty").mkdir()
    argv = [a.format(d=d) for a in argv]
    got_rc, got = _cli(pcli, argv)
    want_rc, want = _cli(jcli, argv)
    assert got_rc == want_rc == rc
    if argv[0] == "tail":
        # the frame carries a wall-clock age; the rest is the same
        got, want = (re.sub(r"[0-9.]+s ago", "", t) for t in (got, want))
        assert "rounds: 3" in got or rc == 2
    if argv[0] != "registry":
        assert got == want
    else:
        assert "| `mfu` |" in got and "| port |" in got


def test_anomaly_detector_matches_jax():
    for obs in (P, J):
        det = obs.RoundAnomalyDetector(factor=3.0, min_rounds=8)
        got = [det.observe(1.0) for _ in range(10)]
        got += [det.observe(2.9), det.observe(30.0)]
        assert got[:-1] == [None] * 11 and abs(got[-1] - 3.0) < 0.2
        quiet = obs.RoundAnomalyDetector(factor=3.0, min_rounds=8)
        for _ in range(7):
            quiet.observe(0.001)
        assert quiet.observe(100.0) is None


def _profiler_case(obs, d):
    started, stopped = [], []
    prof = obs.AnomalyProfiler(d, cooldown_rounds=5,
                               start_fn=started.append,
                               stop_fn=lambda: stopped.append(True))
    got = [prof.maybe_start(0), prof.arm("slow_round"), prof.arm("stall"),
           prof.maybe_start(1), prof.maybe_start(2), prof.maybe_stop(2),
           prof.maybe_stop(1), prof.arm("slow_round"), prof.maybe_start(3),
           prof.arm("slow_round"), prof.maybe_start(12),
           prof.maybe_stop(12)]
    return got, started, len(stopped), prof.profiled_rounds


def test_profiler_one_shot_arm_and_cooldown_match_jax(tmp_path):
    got = _profiler_case(P, str(tmp_path))
    assert got == _profiler_case(J, str(tmp_path))
    assert got[1] == [str(tmp_path / "round_000001"),
                      str(tmp_path / "round_000012")]


def test_the_one_shot_window_traces_on_the_cpu_profiler(tmp_path):
    prof = P.AnomalyProfiler(str(tmp_path))
    assert prof.arm("slow_round") and prof.maybe_start(4)
    torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof.maybe_stop(4) and prof.profiled_rounds == 1
    assert prof.trace_files == [str(tmp_path / "round_000004" /
                                    "trace.json")]
    assert "aten::mm" in Path(prof.trace_files[0]).read_text()


def _anomaly_records(obs, timer_cls, d):
    rec = obs.FlightRecorder(d, job_id="a", rank=0)
    started = []
    bundle = obs.Observability(
        rec, detector=obs.RoundAnomalyDetector(factor=3.0, min_rounds=4),
        profiler=obs.AnomalyProfiler(os.path.join(d, "prof"),
                                     start_fn=started.append,
                                     stop_fn=lambda: None))
    timer = timer_cls()
    bundle.bind_timer(timer)
    for r in range(6):
        bundle.round_begin(r)
        bundle.round_end(r, 0.01)
    bundle.round_begin(6)
    bundle.round_end(6, 5.0)  # >3x p90: an anomaly, and the arm
    bundle.round_begin(7)     # the window opens here
    bundle.round_end(7, 0.01)
    rows = [{k: v for k, v in r.items() if k != "t_wall"}
            for r in obs.read_flight_log(rec.path)]
    return (rows, dict(timer.counters),
            [os.path.basename(s) for s in started])


def test_observability_anomaly_records_match_jax(tmp_path):
    got = _anomaly_records(P, RoundTimer, str(tmp_path / "p"))
    assert got == _anomaly_records(J, JaxRoundTimer, str(tmp_path / "j"))
    rows, counters, started = got
    assert [(r["kind"], r["reason"], r["round"]) for r in rows] == [
        ("anomaly", "slow_round", 6)]
    assert counters == {"obs_anomalies": 1, "obs_profiled_rounds": 1}
    assert started == ["round_000007"]


def test_build_observability_matches_jax(tmp_path):
    assert P.build_observability(None) is None
    assert P.build_observability("") is None
    for role, rank in (("server", 0), ("silo", 2)):
        got = P.build_observability(str(tmp_path), job_id="j", rank=rank,
                                    role=role)
        want = J.build_observability(str(tmp_path), job_id="j", rank=rank,
                                     role=role)
        for part in ("detector", "profiler", "perf"):
            assert (getattr(got, part) is None) == (
                getattr(want, part) is None) == (role == "silo")
        assert got.recorder.rank == rank and got.recorder.job_id == "j"
    # the default id derivations: stable under a key, unique without one
    assert P.default_job_id("fed", stable_key="ck") == J.default_job_id(
        "fed", stable_key="ck")
    assert P.default_job_id("sim") != P.default_job_id("sim")


PERF_CASES = {
    "mfu": ({"round": 7, "duration_s": 2.0, "phases": {}, "counters": {}},
            dict(round_flops=8e9, flops_source="analytic", peak_flops=1e12)),
    "no_peak": ({"round": 0, "duration_s": 1.0}, dict(round_flops=8e9)),
    "no_flops": ({"round": 0, "duration_s": 1.0}, dict(peak_flops=1e12)),
    "overlap": ({"round": 1, "duration_s": 1.0,
                 "phases": {"pack": {"s": 0.4, "n": 1},
                            "upload": {"s": 0.1, "n": 1},
                            "prefetch_wait": {"s": 0.05, "n": 1}},
                 "counters": {"prefetch_hit": 1}}, {}),
    "serial": ({"round": 1, "duration_s": 1.0,
                "phases": {"pack": {"s": 0.4, "n": 1}}, "counters": {}}, {}),
    "cached": ({"round": 1, "duration_s": 1.0, "phases": {},
                "counters": {}}, {}),
    "wire": ({"round": 2, "duration_s": 2.0, "phases": {},
              "counters": {"comm_bytes_up": 1000, "comm_bytes_down": 500}},
             {}),
    "zero": ({"round": 0, "duration_s": 0.0}, {}),
    "no_duration": ({"round": 0}, {}),
    "memory": ({"round": 0, "duration_s": 1.0},
               dict(memory={"device_mem_peak_mb": 12.5,
                            "device_mem_in_use_mb": 8.0})),
    "tiny_mfu": ({"round": 0, "duration_s": 1.0},
                 dict(round_flops=3e5, peak_flops=1e12)),
}
PERF_ORACLE = {
    "mfu": {"achieved_flops_per_s": 4e9, "mfu": 0.004, "round_flops": 8e9,
            "flops_source": "analytic"},
    "overlap": {"comm_compute_overlap_frac": 0.9},
    "serial": {"comm_compute_overlap_frac": 0.0},
    "wire": {"wire_bytes_per_sec_up": 500.0,
             "wire_bytes_per_sec_down": 250.0},
    "memory": {"device_mem_peak_mb": 12.5},
    "tiny_mfu": {"mfu": 3e-7},
}


@pytest.mark.parametrize("name", sorted(PERF_CASES))
def test_perf_record_hand_oracles_match_jax(name):
    rec, kw = PERF_CASES[name]
    got = P.derive_perf_record(rec, **kw)
    assert got == J.derive_perf_record(rec, **kw)
    if name in ("zero", "no_duration"):
        assert got is None
        return
    for k, v in PERF_ORACLE.get(name, {}).items():
        assert got[k] == v, k
    if name in ("no_peak", "no_flops", "cached"):
        assert "mfu" not in got
    if name == "cached":
        assert "comm_compute_overlap_frac" not in got


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 SXM5 80GB", 989.4e12), ("NVIDIA A100-SXM4-80GB", None),
    ("TPU v5 lite", None)])
def test_peak_table_lists_nvidia_cards_only(name, peak, monkeypatch):
    monkeypatch.delenv("FEDML_TPU_PEAK_FLOPS", raising=False)
    assert pperf.device_peak_flops(name) == peak
    # the CPU has no peak: MFU is omitted there, never guessed
    assert pperf.device_peak_flops("cpu") is None
    assert pperf.device_peak_flops(torch.device("cpu")) is None


def test_peak_override_memory_degrade_scaling_and_latched_probe(
        monkeypatch):
    monkeypatch.setenv("FEDML_TPU_PEAK_FLOPS", "2.5e12")
    assert pperf.device_peak_flops() == 2.5e12
    monkeypatch.setenv("FEDML_TPU_PEAK_FLOPS", "not-a-number")
    assert pperf.device_peak_flops("cpu") is None
    monkeypatch.delenv("FEDML_TPU_PEAK_FLOPS")
    # the CPU build has no allocator stats: gauges omitted, never raised
    assert pperf.device_memory_gauges() is None

    def boom():
        raise RuntimeError("no memory stats")
    for memory_fn in (lambda: None, boom):
        rec = P.PerfAccountant(peak_flops=1e12, memory_fn=memory_fn).derive(
            {"round": 0, "duration_s": 1.0})
        assert rec is not None and "device_mem_peak_mb" not in rec
    acct = P.PerfAccountant(peak_flops=1e12, device_count=8, memory_fn=None)
    assert acct.peak_flops == 8e12
    acct.set_round_flops(16e12, "pinned")
    assert acct.derive({"round": 0, "duration_s": 2.0})["mfu"] == 1.0
    calls = []

    def failing():
        calls.append(1)
        raise RuntimeError("trace failed")
    for cls in (P.PerfAccountant, J.PerfAccountant):
        latched = cls(peak_flops=1e12, memory_fn=None)
        latched.probe_flops_once(failing)
        latched.probe_flops_once(failing)
        rec = latched.derive({"round": 0, "duration_s": 1.0})
        assert rec is not None and "mfu" not in rec
    assert calls == [1, 1]  # once a package: latched
    # the port's per-round probe: each round's own count, until a probe
    # fails; then MFU is omitted and nothing is probed again
    acct = P.PerfAccountant(peak_flops=1e12, memory_fn=None)
    mfu = []
    for thunk in (lambda: 2e12, lambda: 3e12, failing, lambda: 4e12):
        acct.probe_round_flops(thunk, "per-round")
        mfu.append(acct.derive({"round": 0, "duration_s": 1.0}).get("mfu"))
    assert mfu == [2.0, 3.0, None, None] and calls == [1, 1, 1]


def _flush_case(obs, timer_cls, d):
    rec = obs.FlightRecorder(d, job_id="p", rank=0)
    acct = obs.PerfAccountant(peak_flops=1e12,
                              memory_fn=lambda: {"device_mem_peak_mb": 42.0})
    acct.set_round_flops(5e11, "pinned")
    bundle = obs.Observability(rec, perf=acct)
    timer = timer_cls()
    bundle.bind_timer(timer)
    bundle.round_end(0, 0.5, record={"round": 0, "duration_s": 0.5,
                                     "phases": {}, "counters": {}})
    bundle.round_end(1, 0.5)  # no record: no perf record
    rows = [{k: v for k, v in r.items() if k != "t_wall"}
            for r in obs.read_flight_log(rec.path)]
    return rows, dict(timer.gauges)


def test_observability_flushes_perf_record_and_gauge_as_jax(tmp_path):
    got = _flush_case(P, RoundTimer, str(tmp_path / "p"))
    assert got == _flush_case(J, JaxRoundTimer, str(tmp_path / "j"))
    rows, gauges = got
    assert [r["mfu"] for r in rows] == [1.0]
    assert gauges == {"device_mem_peak_mb": 42.0}


def test_follower_torn_line_and_rotation_match_jax(tmp_path):
    for tail in (ptail, jtail):
        path = tmp_path / f"{tail.__name__}.torn" / "flight_rank0.jsonl"
        path.parent.mkdir()
        with open(path, "w") as f:
            f.write('{"kind": "round", "round": 0}\n{"kind": "round", '
                    '"rou')
            f.flush()
            fol = tail.LogFollower(str(path))
            assert [r["round"] for r in fol.poll()] == [0]
            f.write('nd": 1}\n')
            f.flush()
            assert [r["round"] for r in fol.poll()] == [1]
        fol.close()
        d = tmp_path / f"{tail.__name__}.rot"
        rec = P.FlightRecorder(str(d), rank=0, rotate_lines=3,
                               keep_last_n=50)
        fol = tail.LogFollower(rec.path)
        got = []
        for r in range(10):
            rec.append({"kind": "round", "round": r})
            got.extend(fol.poll())
        got.extend(fol.poll())
        rec.close()
        fol.close()
        assert [r["round"] for r in got] == list(range(10))


def test_concurrent_tail_with_rotation_matches_both_merges(tmp_path):
    d = str(tmp_path)

    def writer(rank, rotate, fields):
        rec = P.FlightRecorder(d, job_id="t", rank=rank, epoch=rank + 1,
                               rotate_lines=rotate, keep_last_n=100)
        for r in range(30):
            rec.append({"kind": "round", "round": r, **fields})
            time.sleep(0.001)
        rec.close()
    tailer = ptail.TimelineTailer(d, max_records_per_rank=1000)
    threads = [threading.Thread(target=writer, args=(0, 7, {
                   "duration_s": 0.002, "cohort": [0], "reported": [0],
                   "partial": False})),
               threading.Thread(target=writer, args=(1, 5, {
                   "client_idx": 0, "train_s": 0.001}))]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        tailer.poll()
        time.sleep(0.002)
    for t in threads:
        t.join()
    tailer.poll()
    got = tailer.merged()
    tailer.close()
    assert got == P.merge_flight_logs([d]) == J.merge_flight_logs([d])
    assert [r["round"] for r in got["rounds"]] == list(range(30))
    # the retention cap keeps only the newest window
    capped = ptail.TimelineTailer(d, max_records_per_rank=10)
    capped.poll()
    assert [r["round"] for r in capped.merged()["rounds"]] == list(
        range(20, 30))
    capped.close()


def test_multi_tenant_tail_window_matches_jax(tmp_path):
    for j in ("aa", "bb", "cc"):
        rec = P.FlightRecorder(str(tmp_path / f"job_{j}"), job_id=j, rank=0,
                               epoch=1)
        for r in range(30):
            rec.append({"kind": "round", "round": r, "duration_s": 0.01,
                        "phases": {}, "counters": {}, "gauges": {},
                        "cohort": [0], "reported": [0], "partial": False})
        rec.close()
    merged = P.merge_flight_logs([str(tmp_path)])
    assert merged["job_ids"] == ["aa", "bb", "cc"]
    frame = ptail.render_table(merged, last=6)
    assert frame == jtail.render_table(merged, last=6)
    for j in ("aa", "bb", "cc"):
        assert any(line.lstrip().startswith(f"{j} ")
                   and " 29 " in f" {line} " for line in frame.splitlines())


# -- the metric registry -----------------------------------------------------
_EMIT = re.compile(r"\.(?:count|add|gauge|phase)\(\s*f?\"([a-z_]+)")


def test_registry_keeps_every_jax_row_and_names_what_the_port_emits():
    for name, row in jregistry.METRICS.items():
        assert pregistry.METRICS[name]["kind"] == row["kind"], name
    assert set(pregistry.PENDING) <= set(pregistry.METRICS)
    assert all(v.startswith("Slice D item")
               for v in pregistry.PENDING.values())
    emitted = {m.group(1) for f in (ROOT / "fedml_tpu_torch").rglob("*.py")
               for m in _EMIT.finditer(f.read_text())}
    emitted.discard("ft_")  # the f"ft_{key}" roll-up: retries etc.
    assert emitted, "the scan found no metric"
    assert emitted <= pregistry.metric_names(), sorted(
        emitted - pregistry.metric_names())
    assert not emitted & set(pregistry.PENDING)
    for name in ("ft_retries", "ft_dedup_drops", "ft_conn_errors", "mfu"):
        assert name in pregistry.metric_names()
        assert name not in pregistry.PENDING


# -- tests/test_trend.py ------------------------------------------------------
def _row(mod, stage="s", rps=None, bpr=None, host="h"):
    return mod.make_row(stage, {"rounds_per_sec": rps,
                                "bytes_per_round": bpr}, host_tag=host)


TREND_CASES = {
    # (prior rows, the new row, check_row kwargs, regressions expected)
    "first_row_passes": ([], dict(rps=1.0), {}, 0),
    "planted_2x_rps": ([dict(rps=10.0)] * 5, dict(rps=5.0), {}, 1),
    "bytes_growth": ([dict(bpr=100.0)] * 3, dict(bpr=200.0), {}, 1),
    "tunable_threshold": ([dict(rps=10.0)] * 3, dict(rps=5.0),
                          dict(max_rps_drop=0.6), 0),
    "other_host": ([dict(rps=10.0, host="a")] * 3,
                   dict(rps=1.0, host="b"), {}, 0),
    "other_stage": ([dict(rps=10.0, stage="x")] * 3,
                    dict(rps=1.0, stage="y"), {}, 0),
    "window_bounds_history": ([dict(rps=100.0)] * 10 + [dict(rps=10.0)] * 4,
                              dict(rps=8.0), dict(window=4), 0),
    "median_not_poisoned": ([dict(rps=10.0)] * 4 + [dict(rps=1000.0)],
                            dict(rps=9.0), {}, 0),
}


@pytest.mark.parametrize("name", sorted(TREND_CASES))
def test_trend_check_row_matches_jax(name):
    prior, new, kw, want = TREND_CASES[name]
    got = ptrend.check_row([_row(ptrend, **p) for p in prior],
                           _row(ptrend, **new), **kw)
    ref = jtrend.check_row([_row(jtrend, **p) for p in prior],
                           _row(jtrend, **new), **kw)
    assert got == ref and len(got) == want


def test_trend_ledger_io_matches_jax(tmp_path):
    for mod in (ptrend, jtrend):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        rows = [_row(mod, rps=10.0), _row(mod, rps=10.0),
                _row(mod, stage="b", bpr=5.0), _row(mod, rps=4.0)]
        for r in rows:
            mod.append_row(path, r)
        with open(path, "a") as f:
            f.write('{"stage": "s", "rounds_per')  # a torn final line
        assert mod.load_rows(path) == rows
        # an unwritable ledger is a warning, never an exception
        mod.append_row(str(tmp_path / "nodir" / "x" / "\0bad"), rows[0])
        assert len(mod.check_latest(path)) == 1
        summary = mod.summarize_ledger(path)
        assert [(s["stage"], s["rows"]) for s in summary] == [
            ("b", 1), ("s", 3)]
    strip = [{k: v for k, v in r.items() if k != "latest_t_utc"}
             for r in ptrend.summarize_ledger(path)]
    assert strip == [{k: v for k, v in r.items() if k != "latest_t_utc"}
                     for r in jtrend.summarize_ledger(path)]


@pytest.mark.parametrize("rps_last, code", [(9.5, 0), (3.0, 1)])
def test_trend_cli_gate_matches_jax(rps_last, code, tmp_path):
    path = str(tmp_path / "trends.jsonl")
    for rps in (10.0, 10.0, 10.0, rps_last):
        ptrend.append_row(path, _row(ptrend, rps=rps))
    for argv in (["trend", path, "--check-latest"],
                 ["trend", path, "--check-latest", "--max-rps-drop",
                  "0.9"],
                 ["trend", path]):
        got = _cli(pcli, argv)
        assert got == _cli(jcli, argv)
    assert _cli(pcli, ["trend", path, "--check-latest"])[0] == code
    assert _cli(pcli, ["trend", path, "--check-latest", "--max-rps-drop",
                       "0.9"])[0] == 0
    empty = str(tmp_path / "none.jsonl")
    assert _cli(pcli, ["trend", empty, "--check-latest"])[0] == 0
