"""The port's FedAvg round against the JAX package's, and its own invariants.

Parity runs with shuffle off and no dropout, so no RNG stream enters the
trajectory (the port's seed chain differs from JAX's threefry). Both sides
aggregate with the kernel's arithmetic: the JAX side through
``tree_weighted_mean_pallas(..., interpret=True)``, the port through its
front end (the plain version on the CPU). Tolerances: LR atol=1e-5 (f32
reduction order only); the CNN rtol=1e-4, atol=1e-5 (torch and XLA sum a
convolution's terms in another order).
"""

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.ops import tree_weighted_mean_pallas
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models import CNN_DropOut, create_model
from fedml_tpu_torch.ops.aggregate import tree_weighted_mean_fused
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule,
                                                make_eval, make_local_train)
from fedml_tpu_torch.utils.convert import flax_to_state_dict
from fedml_tpu_torch.utils.metrics import read_metrics


def _jax_kernel_hook(variables, stacked, weights, key):
    return tree_weighted_mean_pallas(stacked, weights, interpret=True)


def _port_kernel_hook(variables, stacked, weights, agg_seed):
    return tree_weighted_mean_fused(stacked, weights)


def _assert_close(port_vars, jax_vars, model, **tol):
    want = flax_to_state_dict(jax.tree.map(np.asarray, jax_vars), model)
    assert list(port_vars) == list(want)
    for k in want:
        np.testing.assert_allclose(port_vars[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("momentum, decay", [(0.0, 1.0), (0.9, 0.5)])
def test_lr_three_round_parity_with_jax_fedavg(momentum, decay):
    kw = dict(epochs=2, batch_size=16, lr=0.1, shuffle=False,
              momentum=momentum, lr_decay_round=decay)
    rounds = dict(comm_round=3, client_num_per_round=3,
                  frequency_of_the_test=100)
    jds = jax_blob(client_num=6, seed=1)
    ref = JaxFedAvgAPI(jds, FlaxLR(num_classes=jds.class_num),
                       config=JaxFedAvgConfig(train=JaxTrainConfig(**kw),
                                              **rounds),
                       aggregate_hook=_jax_kernel_hook)
    ds = make_blob_federated(client_num=6, seed=1)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    api = FedAvgAPI(ds, model, config=FedAvgConfig(train=TrainConfig(**kw),
                                                   **rounds),
                    aggregate_hook=_port_kernel_hook, device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    for r in range(3):
        want_idxs, want_stats = ref.run_round(r)
        idxs, stats = api.run_round(r)
        assert list(idxs) == list(want_idxs)
        _assert_close(api.variables, ref.variables, model, atol=1e-5,
                      rtol=0)
        for k in want_stats:
            np.testing.assert_allclose(float(stats[k]), float(want_stats[k]),
                                       rtol=1e-5)
    got, want = api.evaluate(2), ref.evaluate(2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


class _FlaxCNNNoDropout(nn.Module):
    """CNN_DropOut(only_digits=False) without its dropout layers."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        if x.ndim == 3:
            x = x[..., None]
        x = nn.relu(nn.Conv(32, (3, 3), padding="VALID")(x))
        x = nn.relu(nn.Conv(64, (3, 3), padding="VALID")(x))
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = x.reshape((x.shape[0], -1))
        x = nn.relu(nn.Dense(128)(x))
        return nn.Dense(62)(x)


class _CNNNoDropout(CNN_DropOut):
    """The port's CNN without dropout: its eval-mode graph, always."""

    def forward(self, x, train=False, generator=None):
        return super().forward(x, train=False)


def _image_clients(sizes, seed=0):
    rng = np.random.RandomState(seed)
    train, test = {}, {}
    for c, n in enumerate(sizes):
        x = rng.rand(n, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 62, n).astype(np.int32)
        train[c], test[c] = (x, y), (x[:3], y[:3])
    return train, test


def test_cnn_one_round_parity_with_jax_fedavg():
    train, test = _image_clients([10, 14, 7])
    kw = dict(epochs=1, batch_size=8, lr=0.1, shuffle=False)
    rounds = dict(comm_round=1, client_num_per_round=2,
                  frequency_of_the_test=100)
    ref = JaxFedAvgAPI(
        JaxFederatedDataset.from_client_arrays(train, test, 62),
        _FlaxCNNNoDropout(),
        config=JaxFedAvgConfig(train=JaxTrainConfig(**kw), **rounds),
        aggregate_hook=_jax_kernel_hook)
    model = _CNNNoDropout(only_digits=False)
    api = FedAvgAPI(FederatedDataset.from_client_arrays(train, test, 62),
                    model,
                    config=FedAvgConfig(train=TrainConfig(**kw), **rounds),
                    aggregate_hook=_port_kernel_hook, device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    ref.run_round(0)
    api.run_round(0)
    _assert_close(api.variables, ref.variables, model, rtol=1e-4, atol=1e-5)


def _centralized(ds, model, init, epochs):
    """Centralized training on the pooled data: one client holding the
    whole train union, full batch."""
    xg, yg = ds.train_data_global
    local = make_local_train(model, "classification", TrainConfig(
        epochs=epochs, batch_size=None, lr=0.1, shuffle=False))
    out, _ = local(init, torch.from_numpy(xg), torch.from_numpy(yg),
                   torch.ones(len(xg)), seed=0)
    return out


def _fed_full_batch(ds, model, rounds):
    tc = TrainConfig(epochs=1, batch_size=None, lr=0.1, shuffle=False)
    fed = FedAvgAPI(ds, model, device="cpu", config=FedAvgConfig(
        comm_round=rounds, client_num_per_round=ds.client_num,
        frequency_of_the_test=100, train=tc))
    init = {k: v.clone() for k, v in fed.variables.items()}
    for r in range(rounds):
        fed.run_round(r)
    return fed, init


def test_fedavg_equals_centralized_parameters():
    """Full participation + full batch + 1 local epoch => FedAvg ==
    centralized training (reference CI-script-fedavg.sh:47-51)."""
    ds = make_blob_federated(client_num=5, partition_method="hetero", seed=3)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    fed, init = _fed_full_batch(ds, model, 10)
    cent = _centralized(ds, model, init, 10)
    diff = torch.sqrt(sum(((fed.variables[k] - cent[k]) ** 2).sum()
                          for k in cent))
    scale = torch.sqrt(sum((v ** 2).sum() for v in cent.values()))
    assert float(diff / scale) < 1e-5


def test_accuracy_equivalence_to_three_decimals():
    ds = make_blob_federated(client_num=4, partition_method="homo", seed=1)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    fed, init = _fed_full_batch(ds, model, 10)
    cent = _centralized(ds, model, init, 10)
    xg, yg = ds.train_data_global
    stats = make_eval(model, "classification")(
        cent, torch.from_numpy(xg), torch.from_numpy(yg), torch.ones(len(xg)))
    cent_acc = float(stats["correct_sum"]) / float(stats["count"])
    assert round(fed.evaluate(9)["train_acc"], 3) == round(cent_acc, 3)


def _trajectory(ds, model_fn, pack, rounds, **train_kw):
    api = FedAvgAPI(ds, model_fn(), device="cpu", config=FedAvgConfig(
        comm_round=rounds, client_num_per_round=3, pack=pack,
        frequency_of_the_test=100, train=TrainConfig(**train_kw)))
    out = []
    for r in range(rounds):
        api.run_round(r)
        out.append({k: v.clone() for k, v in api.variables.items()})
    return out


@pytest.mark.parametrize("model_name", ["lr", "cnn"])
def test_trajectory_identical_under_cohort_and_global_packing(model_name):
    if model_name == "lr":
        ds = make_blob_federated(client_num=8, seed=2)
        rounds, kw = 3, dict(epochs=2, batch_size=8, lr=0.1, momentum=0.9)

        def model_fn():
            return create_model("lr", ds.class_num, input_shape=(20,))
    else:  # dropout on: the step seeds must be padding-invariant too
        train, test = _image_clients([6, 30, 9, 12, 4])
        ds = FederatedDataset.from_client_arrays(train, test, 62)
        rounds, kw = 1, dict(epochs=1, batch_size=4, lr=0.05)

        def model_fn():
            return create_model("cnn", 62)
    cohort = _trajectory(ds, model_fn, "cohort", rounds, shuffle=True, **kw)
    glob = _trajectory(ds, model_fn, "global", rounds, shuffle=True, **kw)
    for a, b in zip(cohort, glob):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_batch_schedule_is_padding_invariant():
    mask = np.zeros(40, np.float32)
    mask[:13] = 1.0
    short = make_batch_schedule(16, 3, 4, True, seed=11, mask=mask[:16])
    long = make_batch_schedule(40, 3, 4, True, seed=11, mask=mask)
    for e in range(3):
        a = short.batch_idx[e * 4:(e + 1) * 4].reshape(-1)
        b = long.batch_idx[e * 10:(e + 1) * 10].reshape(-1)
        assert np.array_equal(a[:13], b[:13])  # real rows, same order
        assert sorted(a[:13]) == list(range(13))
        assert short.step_seeds[e * 4:(e + 1) * 4] == \
            long.step_seeds[e * 10:e * 10 + 4]
    assert short.has_real.tolist() == [True] * 4 * 3
    assert long.has_real.tolist() == ([True] * 4 + [False] * 6) * 3


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_padding_only_batches_are_true_noops(momentum):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 4).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.int32)
    model = create_model("lr", 3, input_shape=(4,))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    local = make_local_train(model, "classification", TrainConfig(
        epochs=2, batch_size=4, lr=0.1, momentum=momentum, shuffle=True))
    ref, ref_stats = local(init, torch.from_numpy(x), torch.from_numpy(y),
                           torch.ones(4), seed=3)
    # the same data padded with 10 all-padding batches
    xp = np.concatenate([x, np.full((40, 4), 1e9, np.float32)])
    yp = np.concatenate([y, np.zeros(40, np.int32)])
    mp = np.concatenate([np.ones(4), np.zeros(40)]).astype(np.float32)
    pad, pad_stats = local(init, torch.from_numpy(xp), torch.from_numpy(yp),
                           torch.from_numpy(mp), seed=3)
    for k in ref:
        assert torch.equal(ref[k], pad[k]), k
    for k in ref_stats:
        assert torch.equal(ref_stats[k], pad_stats[k]), k
    assert float(ref_stats["count"]) == 8


def test_client_without_real_rows_keeps_its_params():
    model = create_model("lr", 3, input_shape=(4,))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    local = make_local_train(model, "classification",
                             TrainConfig(batch_size=4, lr=0.1))
    out, stats = local(init, torch.ones(8, 4), torch.zeros(8, dtype=torch.int32),
                       torch.zeros(8), seed=0)
    assert all(torch.equal(out[k], init[k]) for k in init)
    assert float(stats["count"]) == 0 and float(stats["loss_sum"]) == 0


def test_main_runs_two_rounds_on_blob_cpu(tmp_path):
    final = main_fedavg.main([
        "--dataset", "blob", "--client_num_in_total", "6",
        "--client_num_per_round", "3", "--comm_round", "2",
        "--frequency_of_the_test", "1", "--batch_size", "16",
        "--lr", "0.1", "--device", "cpu", "--run_dir", str(tmp_path)])
    recs = read_metrics(str(tmp_path))
    assert [r["round"] for r in recs] == [0, 1]
    assert final["round"] == 1 and 0.0 <= final["test_acc"] <= 1.0
    assert np.isfinite(final["train_loss"])


@pytest.mark.parametrize("flag", [["--backend", "spmd"]])
def test_unported_options_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main_fedavg.main(["--device", "cpu", "--client_num_in_total", "4",
                          "--comm_round", "1", "--batch_size", "10",
                          "--run_dir", str(tmp_path)] + flag)


@pytest.mark.parametrize("flag", [
    ["--fused_rounds", "4"], ["--client_optimizer", "adam"],
    # two epochs: every blob client's real step count is then even
    ["--accum_steps", "2", "--epochs", "2"],
    ["--compute_dtype", "bfloat16"],
    # the flight recorder, ported since the refusal this flag once hit
    ["--obs_dir", "{tmp}/obs", "--job_id", "j"]])
def test_ported_options_run(flag, tmp_path):
    final = main_fedavg.main([
        "--device", "cpu", "--client_num_in_total", "4",
        "--client_num_per_round", "2", "--comm_round", "2",
        "--frequency_of_the_test", "1", "--batch_size", "10",
        "--lr", "0.1", "--run_dir", str(tmp_path)]
        + [f.format(tmp=tmp_path) for f in flag])
    assert [r["round"] for r in read_metrics(str(tmp_path))] == [0, 1]
    assert final["round"] == 1
    assert np.isfinite(final["train_loss"]) and np.isfinite(final["test_loss"])


def test_train_records_eval_cadence():
    ds = make_blob_federated(client_num=4, seed=0)
    api = FedAvgAPI(ds, create_model("lr", ds.class_num, input_shape=(20,)),
                    device="cpu", config=FedAvgConfig(
                        comm_round=4, client_num_per_round=2,
                        frequency_of_the_test=2,
                        train=TrainConfig(batch_size=16, lr=0.1)))
    final = api.train()
    assert [r["round"] for r in api.history] == [0, 2, 3]
    assert final is api.history[-1]
    assert {"train_loss_local", "phase_dispatch_ms", "test_acc"} <= set(final)
    assert api.prefetch_stats()["hits"] >= 1


def test_prefetched_trajectory_identical_to_serial():
    ds = make_blob_federated(client_num=8, seed=4)

    def run(depth):
        api = FedAvgAPI(ds, create_model("lr", ds.class_num,
                                         input_shape=(20,)),
                        device="cpu", config=FedAvgConfig(
                            comm_round=4, client_num_per_round=3,
                            prefetch_depth=depth,
                            train=TrainConfig(batch_size=8, lr=0.1)))
        for r in range(4):
            api.run_round(r)
        return api

    serial, piped = run(0), run(2)
    for k in serial.variables:
        assert torch.equal(serial.variables[k], piped.variables[k]), k
    assert serial.prefetch_stats() is None
    assert piped.prefetch_stats()["hits"] == 3
    recs = piped.timer.round_records()
    assert [r["round"] for r in recs] == [0, 1, 2, 3]
    assert all(len(r["cohort"]) == 3 and "dispatch" in r["phases"]
               for r in recs)


def test_validate_accum_steps_matches_the_reference_guard():
    from fedml_tpu_torch.trainer.functional import validate_accum_steps

    with pytest.raises(ValueError, match="accum_steps"):
        validate_accum_steps(
            TrainConfig(epochs=1, batch_size=None, accum_steps=2), {0: 32})
    with pytest.raises(ValueError, match="accum_steps"):
        validate_accum_steps(
            TrainConfig(epochs=1, batch_size=16, accum_steps=2), {0: 48})
    validate_accum_steps(TrainConfig(epochs=2, batch_size=16, accum_steps=2),
                         {0: 64})
    validate_accum_steps(TrainConfig(batch_size=16), {0: 7})
