"""The port's fed_launch: every ``--algo`` of the JAX launcher runs end to
end on the CPU through ``main`` (LR on blob, a few rounds; split learning,
vertical FL, FedGKT and FedNAS one round each on blob or img_blob;
fedavg_async in tests/test_torch_fedavg_async.py), the control plane's
flags are refused before anything is built, and
``--fused_rounds`` takes the fused driver where the API has one and the
host loop, with a warning, where it has none.
"""

import logging
import pickle

import numpy as np
import pytest

from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.utils.metrics import read_metrics

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = ["--dataset", "blob", "--client_num_in_total", "6",
        "--client_num_per_round", "3", "--comm_round", "3",
        "--frequency_of_the_test", "2", "--batch_size", "16", "--lr", "0.1",
        "--device", "cpu"]

PORTED = {
    "fedavg": [], "fedavg_cross_silo": [],
    "fedopt": ["--server_optimizer", "yogi", "--server_lr", "0.05"],
    "fednova": ["--gmf", "0.5", "--prox_mu", "0.01"],
    "fedavg_robust": ["--defense_type", "median"],
    "hierarchical": ["--group_num", "2", "--group_comm_round", "2"],
    "turboaggregate": ["--frac_bits", "20"],
    "centralized": [],
    "decentralized": ["--mode", "PUSHSUM"],
    "contribution": ["--comm_round", "2", "--client_num_in_total", "4"],
    "fedseg": ["--dataset", "seg_shapes", "--client_num_in_total", "4",
               "--client_num_per_round", "2", "--batch_size", "8",
               "--comm_round", "2", "--frequency_of_the_test", "1",
               "--model", "segnet"],
}


# the algorithms with their own loops (ROADMAP item 27), one round each
SLICE_F = {
    "split_nn": ["--dataset", "blob", "--lr", "0.01"],
    "vertical_fl": ["--dataset", "blob", "--party_num", "3"],
    "fedgkt": ["--dataset", "img_blob", "--client_num_in_total", "2",
               "--batch_size", "16", "--epochs_server", "1"],
    "fednas": ["--dataset", "img_blob", "--client_num_in_total", "2",
               "--batch_size", "16", "--nas_variant", "gdas",
               "--nas_retrain_rounds", "1"],
}


def test_every_algo_is_ported_or_names_its_item():
    ported = set(PORTED) | set(SLICE_F) | {"fedavg_async"}
    assert ported | set(fed_launch.NOT_PORTED) == set(fed_launch.ALGOS)
    assert not ported & set(fed_launch.NOT_PORTED)
    assert fed_launch.NOT_PORTED == {}


@pytest.mark.parametrize("algo", sorted(PORTED))
def test_ported_algo_runs_on_the_cpu(algo, tmp_path):
    run_dir = tmp_path / "run"
    final = fed_launch.main(["--algo", algo, *BASE, *PORTED[algo],
                             "--run_dir", str(run_dir)])
    assert final
    if algo == "decentralized":
        assert np.isfinite(final["regret"]) and final["regret"] > 0
        assert np.isfinite(final["consensus_distance"])
    elif algo == "contribution":
        assert len(final["influence"]) == 4
        assert sorted(final["ranked"]) == [0, 1, 2, 3]
    elif algo == "centralized":
        assert final["test_acc"] > 0.8, final
    else:
        assert np.isfinite(final["test_loss"])
        assert final["test_acc"] > 0.5, final
    assert read_metrics(str(run_dir))


@pytest.mark.parametrize("algo", sorted(SLICE_F))
def test_slice_f_algo_runs_one_round_on_the_cpu(algo, tmp_path):
    run_dir = tmp_path / "run"
    final = fed_launch.main(["--algo", algo, *BASE, *SLICE_F[algo],
                             "--comm_round", "1", "--run_dir",
                             str(run_dir)])
    recs = read_metrics(str(run_dir))
    assert recs
    for rec in recs:
        for k, v in rec.items():
            if isinstance(v, float):
                assert np.isfinite(v), (k, rec)
    if algo == "vertical_fl":
        assert np.isfinite(final["train_loss"])
        assert 0.0 <= final["test_acc"] <= 1.0
    elif algo == "fednas":
        assert final["genotype"].startswith("Genotype(")
        assert np.isfinite(final["retrain_test_loss"])
        assert 0.0 <= final["test_acc"] <= 1.0
    else:
        assert np.isfinite(final["test_loss"])
        assert 0.0 <= final["test_acc"] <= 1.0


@pytest.mark.parametrize("algo, argv, match", [
    ("split_nn", ["--dataset", "img_blob"], "flat features"),
    ("vertical_fl", ["--dataset", "blob", "--party_num", "21"],
     "--party_num 21"),
    ("fedgkt", ["--dataset", "blob"], "NHWC"),
    ("fednas", ["--dataset", "blob"], "NHWC")])
def test_slice_f_refuses_a_wrong_dataset_before_the_sink(algo, argv, match,
                                                         tmp_path):
    with pytest.raises(SystemExit, match=match):
        fed_launch.main(["--algo", algo, *BASE, *argv,
                         "--run_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("algo", ["fedavg_async"])
def test_unported_algo_names_its_item(algo, tmp_path):
    """The last refused algorithm runs now. What it still refuses, its
    control plane (ROADMAP item 23), is no flag of the port's launcher:
    the parser refuses it before anything is built."""
    for flag in (["--server_checkpoint_dir", "ck"], ["--checkpoint_sync"],
                 ["--pace_steering"], ["--join_rate_limit", "2"]):
        with pytest.raises(SystemExit):
            fed_launch.main(["--algo", algo, *BASE, *flag,
                             "--run_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("argv, err, match", [
    (["--algo", "fedavg", "--backend", "spmd"], NotImplementedError,
     "item 26"),
    (["--algo", "fedavg", "--checkpoint_dir", "ck", "--fused_rounds", "2"],
     ValueError, "fused"),
    (["--algo", "fedavg_cross_silo", "--fused_rounds", "2"], ValueError,
     "fused_rounds")])
def test_unported_flags_raise_before_anything_is_built(argv, err, match,
                                                       tmp_path):
    with pytest.raises(err, match=match):
        fed_launch.main([*argv, *BASE, "--run_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_fused_fedopt_equals_its_host_loop(tmp_path):
    argv = ["--algo", "fedopt", *BASE, "--server_optimizer", "adam",
            "--server_lr", "0.05"]
    host = fed_launch.main([*argv, "--run_dir", str(tmp_path / "host")])
    fused = fed_launch.main([*argv, "--fused_rounds", "2",
                             "--run_dir", str(tmp_path / "fused")])
    for k in ("test_acc", "test_loss", "train_loss"):
        assert host[k] == fused[k], k
    assert ([r["round"] for r in read_metrics(str(tmp_path / "fused"))]
            == [0, 2])


def test_fused_rounds_without_a_fused_driver_warns(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        final = fed_launch.main(["--algo", "turboaggregate", *BASE,
                                 "--fused_rounds", "2",
                                 "--run_dir", str(tmp_path / "run")])
    assert "using the host loop" in caplog.text
    assert np.isfinite(final["test_loss"])


def test_robust_with_poisoned_artifacts_reports_backdoor_asr(tmp_path):
    rng = np.random.RandomState(1)
    paths = []
    for name, n in (("train.pkl", 30), ("test.pkl", 12)):
        p = tmp_path / name
        with open(p, "wb") as f:
            pickle.dump(rng.rand(n, 20).astype(np.float32), f)
        paths.append(str(p))
    final = fed_launch.main([
        "--algo", "fedavg_robust", *BASE, "--defense_type", "weak_dp",
        "--poison_pkl", paths[0], "--poison_test_pkl", paths[1],
        "--attacker_client", "1", "--target_label", "3",
        "--poison_num_edge", "10", "--poison_num_clean", "20",
        "--run_dir", str(tmp_path / "run")])
    assert 0.0 <= final["backdoor_asr"] <= 1.0
