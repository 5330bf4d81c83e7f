"""The port's robust aggregation against the JAX package's: the rules
(median at even and odd client counts, trimmed mean, Krum) and the clipping
defense function by function, the robust API round by round, the weak-DP
noise (the port's counter-hash stream, a known divergence) held to its
distribution and to the fused driver bit for bit, and the poisoned-data
loaders on fixtures written here.

Tolerances: the median bit for bit; clipping and Krum's choice rtol 1e-6,
atol 1e-6 (one f32 op order; Krum's Gram product in f32 on both sides);
the trimmed mean 1e-5 (XLA and torch sum the kept values in other orders);
Krum's scores rtol 1e-4 (the Gram identity cancels digits on both sides);
the LR federations atol 1e-5, the existing LR parity tolerance.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg_robust import \
    FedAvgRobustAPI as JaxFedAvgRobustAPI
from fedml_tpu.algorithms.fedavg_robust import \
    FedAvgRobustConfig as JaxFedAvgRobustConfig
from fedml_tpu.algorithms.fedavg_robust import \
    poison_client_labelflip as jax_labelflip
from fedml_tpu.core import robust as jax_robust
from fedml_tpu.data import poisoned as jax_poisoned
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                      FedAvgRobustConfig,
                                                      poison_client_labelflip)
from fedml_tpu_torch.core import robust
from fedml_tpu_torch.core.pytree import tree_map_with_path_filter
from fedml_tpu_torch.data import poisoned
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-6, atol=1e-6)


def _stacked(c, seed=0, outlier=100.0, spread=0.01):
    """``c`` updates near a common point, the first one ``outlier`` off:
    the same arrays as a port state dict and as a JAX tree."""
    rng = np.random.RandomState(seed)
    base = {"w": rng.randn(4, 3), "b": rng.randn(3)}
    arrs = {k: np.stack([v + (outlier if i == 0 else 0.0)
                         + spread * rng.randn(*v.shape) for i in range(c)])
            .astype(np.float32) for k, v in base.items()}
    return ({k: torch.from_numpy(v) for k, v in arrs.items()},
            {k: jnp.asarray(v) for k, v in arrs.items()})


def _close(port, want, **tol):
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **(tol or TOL))


@pytest.mark.parametrize("c", [4, 5, 10, 11])
def test_coordinate_median_matches_jnp_median(c):
    port, ref = _stacked(c, seed=c)
    got = robust.coordinate_median(port)
    want = jax_robust.coordinate_median(ref)
    for k in want:  # the same arithmetic: bit for bit
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    if c % 2 == 0:  # the two middle values averaged, not the lower one
        assert not torch.equal(got["w"], torch.median(port["w"], 0).values)


@pytest.mark.parametrize("c, ratio", [(7, 0.2), (10, 0.1), (6, 0.0)])
def test_trimmed_mean_matches_jax(c, ratio):
    port, ref = _stacked(c, seed=1)
    _close(robust.trimmed_mean(port, ratio),
           jax_robust.trimmed_mean(ref, ratio), rtol=1e-5, atol=1e-5)


def test_trimmed_mean_overtrim_refused():
    port, _ = _stacked(4)
    with pytest.raises(ValueError, match="trim_ratio"):
        robust.trimmed_mean(port, trim_ratio=0.5)


@pytest.mark.parametrize("c, f, m", [(7, 1, 1), (9, 1, 3), (10, 2, 2)])
def test_krum_matches_jax(c, f, m):
    # scores by the Gram identity lose digits to cancellation on both sides
    # (rtol 1e-4 at this spread); the selection and its mean agree at TOL
    port, ref = _stacked(c, seed=2, outlier=3.0, spread=0.3)
    np.testing.assert_allclose(robust.krum_scores(port, f).numpy(),
                               np.asarray(jax_robust.krum_scores(ref, f)),
                               rtol=1e-4)
    _close(robust.krum(port, f, m), jax_robust.krum(ref, f, m))


def test_krum_scores_the_attacker_worst():
    port, _ = _stacked(7)
    assert int(torch.argmax(robust.krum_scores(port, 1))) == 0
    base, _ = _stacked(7, outlier=0.0, spread=0.0)
    got = robust.krum(port, 1)
    assert float((got["w"] - base["w"][0]).abs().max()) < 0.1


def test_krum_ties_pick_the_lower_position():
    """Duplicated updates tie their scores: the stable order picks the
    first of them, as JAX's stable argsort does."""
    port, ref = _stacked(7, seed=3, outlier=0.0)
    for k in port:
        port[k][4] = port[k][2]
        port[k][5] = port[k][2]
        ref[k] = ref[k].at[4].set(ref[k][2]).at[5].set(ref[k][2])
    _close(robust.krum(port, 1, 2), jax_robust.krum(ref, 1, 2))


def test_krum_cardinality_refused():
    port, _ = _stacked(4)
    with pytest.raises(ValueError, match="2f"):
        robust.krum(port, num_byzantine=1)


def _bn_state_dict():
    """A state dict with BN buffers, built here."""
    net = torch.nn.Sequential(torch.nn.Conv2d(1, 2, 3),
                              torch.nn.BatchNorm2d(2),
                              torch.nn.Linear(4, 3))
    return net.state_dict()


def test_is_weight_param_on_dotted_names():
    sd = _bn_state_dict()
    weights = {k for k in sd if robust.is_weight_param(k)}
    assert weights == {"0.weight", "0.bias", "1.weight", "1.bias",
                       "2.weight", "2.bias"}
    # the JAX filter on the same leaves under flax's paths
    assert not jax_robust.is_weight_param("batch_stats/BatchNorm_0/mean")
    assert jax_robust.is_weight_param("params/BatchNorm_0/scale")
    # a name holding a marker inside a part is a weight
    assert robust.is_weight_param("meanfield.weight")
    out = tree_map_with_path_filter(lambda t: t + 1, sd,
                                    robust.is_weight_param)
    assert torch.equal(out["1.running_var"], sd["1.running_var"])
    assert torch.equal(out["2.bias"], sd["2.bias"] + 1)


@pytest.mark.parametrize("bound", [0.05, 1e3])
def test_norm_diff_clipping_matches_jax(bound):
    rng = np.random.RandomState(4)
    c = 3
    kernel = rng.randn(c, 4, 3).astype(np.float32)
    bias = rng.randn(c, 3).astype(np.float32)
    mean = rng.randn(c, 3).astype(np.float32)
    g = [rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32),
         rng.randn(3).astype(np.float32)]
    port = robust.norm_diff_clipping(
        {"fc.weight": torch.from_numpy(kernel),
         "fc.bias": torch.from_numpy(bias),
         "bn.running_mean": torch.from_numpy(mean)},
        {"fc.weight": torch.from_numpy(g[0]), "fc.bias": torch.from_numpy(g[1]),
         "bn.running_mean": torch.from_numpy(g[2])}, bound)

    def tree(k, b, m):
        return {"params": {"fc": {"kernel": k, "bias": b}},
                "batch_stats": {"bn": {"mean": m}}}
    want = jax.vmap(lambda k, b, m: jax_robust.norm_diff_clipping(
        tree(k, b, m), tree(*g), bound))(kernel, bias, mean)
    np.testing.assert_allclose(port["fc.weight"].numpy(),
                               want["params"]["fc"]["kernel"], **TOL)
    np.testing.assert_allclose(port["fc.bias"].numpy(),
                               want["params"]["fc"]["bias"], **TOL)
    # BN statistics pass through untouched
    assert np.array_equal(port["bn.running_mean"].numpy(), mean)
    if bound < 1:
        norms = np.sqrt(((port["fc.weight"].numpy() - g[0]) ** 2).sum((1, 2))
                        + ((port["fc.bias"].numpy() - g[1]) ** 2).sum(1))
        np.testing.assert_allclose(norms, bound, rtol=1e-5)


def _robust_pair(defense, **extra):
    kw = dict(epochs=2, batch_size=16, lr=0.3, shuffle=False)
    rounds = dict(comm_round=3, client_num_per_round=7,
                  frequency_of_the_test=100, defense_type=defense,
                  norm_bound=0.5, trim_ratio=0.15, num_byzantine=1, **extra)
    jds = jax_labelflip(jax_blob(client_num=7, seed=2), 0, 1,
                        trigger_value=50.0)
    ref = JaxFedAvgRobustAPI(jds, FlaxLR(num_classes=jds.class_num),
                             config=JaxFedAvgRobustConfig(
                                 train=JaxTrainConfig(**kw), **rounds))
    ds = poison_client_labelflip(make_blob_federated(client_num=7, seed=2),
                                 0, 1, trigger_value=50.0)
    for c in range(7):
        for a, b in zip(ds.train_data_local_dict[c],
                        jds.train_data_local_dict[c]):
            assert np.array_equal(a, b)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    api = FedAvgRobustAPI(ds, model, device="cpu", config=FedAvgRobustConfig(
        train=TrainConfig(**kw), **rounds))
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    return ref, api, model


@pytest.mark.parametrize("defense", [
    None, "norm_diff_clipping", "median", "trimmed_mean", "krum"])
def test_robust_rounds_match_jax(defense):
    ref, api, model = _robust_pair(defense)
    for r in range(3):
        ref.run_round(r)
        api.run_round(r)
        want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables),
                                  model)
        for k in want:
            np.testing.assert_allclose(api.variables[k].numpy(),
                                       want[k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"{defense} {k} round {r}")


def test_unknown_defense_refused():
    ds = make_blob_federated(client_num=4, seed=0)
    with pytest.raises(ValueError, match="bogus"):
        FedAvgRobustAPI(ds, create_model("lr", ds.class_num,
                                         input_shape=(20,)), device="cpu",
                        config=FedAvgRobustConfig(defense_type="bogus"))


def _weak_dp_api(ds, **cfg):
    return FedAvgRobustAPI(
        ds, create_model("lr", ds.class_num, input_shape=(20,)),
        device="cpu", config=FedAvgRobustConfig(
            comm_round=4, frequency_of_the_test=100, defense_type="weak_dp",
            norm_bound=1.0, stddev=0.05,
            train=TrainConfig(epochs=1, batch_size=16, lr=0.1), **cfg))


@pytest.mark.parametrize("per_round", [3, 6])
def test_weak_dp_fused_block_equals_host_loop(per_round):
    ds = make_blob_federated(client_num=6, seed=5)
    host, fused_api = (_weak_dp_api(ds, client_num_per_round=per_round)
                       for _ in range(2))
    for r in range(4):
        host.run_round(r)
    fused_api.fused_rounds().run_rounds(0, 4)
    for k in host.variables:
        assert torch.equal(host.variables[k], fused_api.variables[k]), k


def test_weak_dp_noise_is_gaussian_and_skips_bn_statistics():
    n, c, stddev = 200_000, 3, 0.5
    stacked = {"fc.weight": torch.zeros(c, n // 1000, 1000),
               "bn.running_var": torch.ones(c, 7)}
    out = robust.add_weak_dp_noise(stacked, stddev, 123456789)
    noise = out["fc.weight"].reshape(c, -1).double()
    # N(0, stddev^2): mean within 5 standard errors, std within 1%, the
    # tails of a normal (4 sigma: ~6e-5 of the draws)
    assert float(noise.mean().abs()) < 5 * stddev / np.sqrt(c * n)
    assert abs(float(noise.std()) / stddev - 1) < 0.01
    tail = float((noise.abs() > 4 * stddev).double().mean())
    assert 1e-5 < tail < 2e-4, tail
    # clients draw independent streams; the same seed draws the same noise
    corr = np.corrcoef(noise.numpy())
    assert np.abs(corr[np.triu_indices(c, 1)]).max() < 0.01
    again = robust.add_weak_dp_noise(stacked, stddev,
                                     torch.tensor(123456789))
    assert torch.equal(again["fc.weight"], out["fc.weight"])
    assert torch.equal(out["bn.running_var"], stacked["bn.running_var"])


def test_weak_dp_adds_noise_to_the_round():
    ds = make_blob_federated(client_num=4, seed=0)
    a = _weak_dp_api(ds, client_num_per_round=4)
    b = FedAvgRobustAPI(ds, create_model("lr", ds.class_num,
                                         input_shape=(20,)), device="cpu",
                        config=FedAvgRobustConfig(
                            comm_round=1, defense_type="norm_diff_clipping",
                            norm_bound=1.0, frequency_of_the_test=100,
                            train=TrainConfig(epochs=1, batch_size=16,
                                              lr=0.1)))
    a.run_round(0)
    b.run_round(0)
    diff = sum(float(((a.variables[k] - b.variables[k]) ** 2).sum())
               for k in a.variables) ** 0.5
    assert diff > 0.01, diff


@pytest.mark.parametrize("defense", ["median", "trimmed_mean", "krum"])
def test_backdoored_client_neutralized(defense):
    ds = poison_client_labelflip(
        make_blob_federated(client_num=7, dim=8, class_num=3, n_samples=350,
                            seed=2, partition_method="homo"),
        client_idx=0, target_label=0, trigger_value=50.0)
    api = FedAvgRobustAPI(ds, create_model("lr", 3, input_shape=(8,)),
                          device="cpu", config=FedAvgRobustConfig(
                              comm_round=6, client_num_per_round=7,
                              frequency_of_the_test=10 ** 9,
                              defense_type=defense, trim_ratio=0.15,
                              num_byzantine=1,
                              train=TrainConfig(epochs=1, batch_size=10,
                                                lr=0.3)))
    for r in range(6):
        api.run_round(r)
    assert api.evaluate(5)["test_acc"] > 0.75


# -- the poisoned loaders ----------------------------------------------------

class _DuckDataset:
    """Module-level so torch.save/load can pickle it (a torchvision-like
    dataset: .data and .targets)."""

    def __init__(self):
        self.data = torch.ones(6, 8, 8, 3, dtype=torch.uint8) * 255
        self.targets = list(range(6))


def _artifact(kind, tmp_path):
    if kind == "southwest_pkl":
        x = (np.random.RandomState(0).rand(40, 32, 32, 3) * 255).astype(
            np.uint8)
        p = tmp_path / "southwest_images_new_train.pkl"
        with open(p, "wb") as f:
            pickle.dump(x, f)
    elif kind == "torch_pair":
        p = tmp_path / "ardis_test_dataset.pt"
        torch.save((torch.zeros(10, 28, 28, dtype=torch.uint8),
                    torch.full((10,), 7)), p)
    else:
        p = tmp_path / "poisoned_dataset_fraction_10.pt"
        torch.save(_DuckDataset(), p)
    return str(p)


@pytest.mark.parametrize("kind", ["southwest_pkl", "torch_pair",
                                  "torch_dataset"])
def test_load_edge_case_artifact_matches_jax(kind, tmp_path):
    path = _artifact(kind, tmp_path)
    x, y = poisoned.load_edge_case_artifact(path, target_label=9)
    wx, wy = jax_poisoned.load_edge_case_artifact(path, target_label=9)
    assert x.dtype == wx.dtype == np.float32 and np.array_equal(x, wx)
    assert y.dtype == wy.dtype == np.int32 and np.array_equal(y, wy)
    assert x.ndim == 4 and float(x.max()) <= 1.0
    if kind == "torch_pair":
        assert (y == 7).all()  # the artifact's targets win


def _image_ds(sizes, seed=0):
    rng = np.random.RandomState(seed)
    train = {c: (rng.rand(n, 16, 16, 3).astype(np.float32),
                 rng.randint(0, 10, n).astype(np.int32))
             for c, n in enumerate(sizes)}
    return FederatedDataset.from_client_arrays(
        train, {c: (x[:3], y[:3]) for c, (x, y) in train.items()}, 10)


def test_mix_edge_case_into_client_matches_reference_counts():
    ds = _image_ds([50, 50, 50, 50])
    x_edge = np.zeros((30, 16, 16, 3), np.float32)
    y_edge = np.full(30, 3, np.int32)
    mixed = poisoned.mix_edge_case_into_client(ds, 1, x_edge, y_edge,
                                               num_edge=10, num_clean=20)
    xa, ya = mixed.train_data_local_dict[1]
    assert len(xa) == 30 and (ya == 3).sum() >= 10
    np.testing.assert_array_equal(mixed.train_data_local_dict[0][0],
                                  ds.train_data_local_dict[0][0])
    with pytest.raises(ValueError, match="shape"):
        poisoned.mix_edge_case_into_client(ds, 0, np.zeros((5, 32, 32, 3)),
                                           np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="out of range"):
        poisoned.mix_edge_case_into_client(ds, 0, x_edge,
                                           np.full(30, 10, np.int32))


def test_poison_dataset_and_labelflip_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(20, 8, 8, 1).astype(np.float32)
    y = rng.randint(0, 5, 20).astype(np.int32)
    for a, b in zip(poisoned.poison_dataset(x, y, 2),
                    jax_poisoned.poison_dataset(x, y, 2)):
        assert np.array_equal(a, b)
    got = poison_client_labelflip(make_blob_federated(client_num=4, seed=3),
                                  1, 2, fraction=0.5)
    want = jax_labelflip(jax_blob(client_num=4, seed=3), 1, 2, fraction=0.5)
    for a, b in zip(got.train_data_local_dict[1],
                    want.train_data_local_dict[1]):
        assert np.array_equal(a, b)
