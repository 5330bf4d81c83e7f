"""Rounds of the cross-device anchors' models against the JAX package:
one FedAvg round of each new model (ResNet-18-GN cut to two stages,
ResNet-56 to one block a stage, the three LSTMs at narrow widths), and
FedOpt, weak DP and FedNova on a small ResNet-56, and the algorithms
that carry the statistics whole since ROADMAP item 17a (hierarchical
FedAvg, TurboAggregate's secure sum, the centralized trainer and
leave-one-out contribution), each from the same converted weights and BN
statistics, shuffle off, no dropout. Params and ``batch_stats`` are
compared, and the JAX statistics must have moved. On the CPU the fused
driver's gated round equals the host loop bit for bit on a BN model.

Tolerances: rtol=1e-4, atol=1e-5 for params and statistics (torch and XLA
sum a convolution's or a product's terms in another order); FedNova's
momentum buffer rtol=1e-4, atol=1e-4 (the cumulative gradient over the
client lr 0.1: ten times the params' error); the plain average of the
statistics under FedOpt and weak DP is exact, bit for bit against the
port's FedAvg; TurboAggregate's statistics lie within the field's
fixed-point round-off (2**-15) of the plain mean, and leave-one-out
influence within atol 1e-5 of JAX's (the contribution tests' bound).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.algorithms.fedavg_robust import \
    FedAvgRobustAPI as JaxFedAvgRobustAPI
from fedml_tpu.algorithms.fedavg_robust import \
    FedAvgRobustConfig as JaxFedAvgRobustConfig
from fedml_tpu.algorithms.fednova import FedNovaAPI as JaxFedNovaAPI
from fedml_tpu.algorithms.fednova import FedNovaConfig as JaxFedNovaConfig
from fedml_tpu.algorithms.fedopt import FedOptAPI as JaxFedOptAPI
from fedml_tpu.algorithms.fedopt import FedOptConfig as JaxFedOptConfig
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as FlaxCifarResNet
from fedml_tpu.models.resnet_gn import ResNetGN as FlaxResNetGN
from fedml_tpu.ops import tree_weighted_mean_pallas
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.fedavg_robust import (FedAvgRobustAPI,
                                                      FedAvgRobustConfig)
from fedml_tpu_torch.algorithms.fednova import FedNovaAPI, FedNovaConfig
from fedml_tpu_torch.algorithms.fedopt import FedOptAPI, FedOptConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.models.resnet_gn import ResNetGN
from fedml_tpu_torch.ops.aggregate import tree_weighted_mean_fused
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import (flax_to_state_dict,
                                           optax_state_to_port)

TOL = dict(rtol=1e-4, atol=1e-5)
SIZES = [10, 14, 7]
TRAIN = dict(epochs=1, batch_size=4, lr=0.1, shuffle=False)
ROUND = dict(comm_round=1, client_num_per_round=2, frequency_of_the_test=100)


def _clients(kind, classes=5, seed=0):
    rng = np.random.RandomState(seed)
    train, test = {}, {}
    for c, n in enumerate(SIZES):
        if kind == "image":
            x = rng.rand(n, 8, 8, 3).astype(np.float32)
            y = rng.randint(0, classes, n).astype(np.int32)
        else:  # tokens [n, 6], 0 is the pad
            x = rng.randint(1, classes, (n, 6)).astype(np.int32)
            y = (rng.randint(1, classes, (n, 6)) if kind == "nwp" else
                 rng.randint(0, classes, n)).astype(np.int32)
        train[c], test[c] = (x, y), (x[:3], y[:3])
    return train, test


def _models(name):
    """(flax model, port model, data kind, task, classes)"""
    if name == "resnet18_gn":  # two stages: 64 and 128 planes
        return (FlaxResNetGN([1, 1], num_classes=5),
                ResNetGN([1, 1], 5), "image", "classification", 5)
    if name == "resnet56":
        return (FlaxCifarResNet([1, 1, 1], num_classes=5),
                CifarResNet([1, 1, 1], 5), "image", "classification", 5)
    narrow = dict(rnn_seq=dict(hidden_size=16, embedding_dim=4),
                  rnn=dict(vocab_size=12, hidden_size=16, embedding_dim=4),
                  rnn_stackoverflow=dict(vocab_size=8, embedding_size=6,
                                         latent_size=10))[name]
    classes = 12
    task = "classification" if name == "rnn" else "nwp"
    return (jax_create_model(name, classes, **narrow),
            create_model(name, classes, **narrow),
            "tokens" if name == "rnn" else "nwp", task, classes)


def _jax_hook(variables, stacked, weights, key):
    return tree_weighted_mean_pallas(stacked, weights, interpret=True)


def _port_hook(variables, stacked, weights, agg_seed):
    return tree_weighted_mean_fused(stacked, weights)


def _convert(jax_vars, model, **kw):
    return flax_to_state_dict(jax.tree.map(np.asarray, jax_vars), model,
                              **kw)


def _assert_close(port_vars, jax_vars, model, start=None, **tol):
    want = _convert(jax_vars, model)
    assert list(port_vars) == list(want)
    for k in want:
        np.testing.assert_allclose(port_vars[k].numpy(), want[k].numpy(),
                                   err_msg=k, **(tol or TOL))
    if start is not None:  # the JAX statistics moved in the round
        stats = [k for k in want if k.endswith("running_var")]
        assert stats and all(not np.allclose(want[k], start[k])
                             for k in stats)


def _pair(jax_api, port_api, name, jax_cfg, port_cfg, **kw):
    flax_model, model, kind, task, classes = _models(name)
    train, test = _clients(kind, classes)
    ref = jax_api(JaxFederatedDataset.from_client_arrays(train, test,
                                                         classes),
                  flax_model, task=task, config=jax_cfg, **kw.get("jax", {}))
    api = port_api(FederatedDataset.from_client_arrays(train, test, classes),
                   model, task=task, config=port_cfg, device="cpu",
                   **kw.get("port", {}))
    api.variables = _convert(ref.variables, model)
    return ref, api, model


@pytest.mark.parametrize("name", ["resnet18_gn", "resnet56", "rnn",
                                  "rnn_seq", "rnn_stackoverflow"])
def test_one_fedavg_round_matches_jax(name):
    ref, api, model = _pair(
        JaxFedAvgAPI, FedAvgAPI, name,
        JaxFedAvgConfig(train=JaxTrainConfig(**TRAIN), **ROUND),
        FedAvgConfig(train=TrainConfig(**TRAIN), **ROUND),
        jax=dict(aggregate_hook=_jax_hook),
        port=dict(aggregate_hook=_port_hook))
    start = {k: v.numpy().copy() for k, v in api.variables.items()}
    want_idxs, want_stats = ref.run_round(0)
    idxs, stats = api.run_round(0)
    assert list(idxs) == list(want_idxs)
    _assert_close(api.variables, ref.variables, model,
                  start if name == "resnet56" else None)
    for k in want_stats:
        np.testing.assert_allclose(float(stats[k]), float(want_stats[k]),
                                   rtol=1e-5)
    got, want = api.evaluate(0), ref.evaluate(0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def _fedavg_port(model_vars):
    """The port's FedAvg from the same weights, for the plain average."""
    _, model, kind, task, classes = _models("resnet56")
    train, test = _clients(kind, classes)
    api = FedAvgAPI(FederatedDataset.from_client_arrays(train, test, classes),
                    model, task=task, device="cpu", config=FedAvgConfig(
                        train=TrainConfig(**TRAIN), **ROUND))
    api.variables = dict(model_vars)
    return api


def _stats(variables):
    return {k: v for k, v in variables.items() if "running_" in k}


@pytest.mark.parametrize("opt", [
    dict(server_optimizer="sgd", server_lr=0.5, server_momentum=0.9),
    dict(server_optimizer="adam", server_lr=0.05)], ids=["sgdm", "adam"])
def test_fedopt_steps_params_and_keeps_the_stats_mean(opt):
    ref, api, model = _pair(
        JaxFedOptAPI, FedOptAPI, "resnet56",
        JaxFedOptConfig(train=JaxTrainConfig(**TRAIN), **ROUND, **opt),
        FedOptConfig(train=TrainConfig(**TRAIN), **ROUND, **opt))
    api.server_opt_state = optax_state_to_port(ref.server_opt_state, model)
    start = {k: v.numpy().copy() for k, v in api.variables.items()}
    fedavg = _fedavg_port(api.variables)
    ref.run_round(0)
    api.run_round(0)
    fedavg.run_round(0)
    if opt["server_optimizer"] == "sgd":
        _assert_close(api.variables, ref.variables, model, start)
        want = optax_state_to_port(ref.server_opt_state, model)
        for k, v in want.items():
            assert len(v) == len(list(model.parameters()))
            for a, b in zip(api.server_opt_state[k], v):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    else:
        # Adam's first step is lr * sign(g) where the pseudo-gradient is
        # within round-off of 0, so only the statistics are held to JAX
        want = _convert(ref.variables, model)
        for k, v in _stats(want).items():
            np.testing.assert_allclose(api.variables[k].numpy(), v.numpy(),
                                       err_msg=k, **TOL)
            assert not np.allclose(v.numpy(), start[k]), k
    # the buffers keep the plain mean; the server stepped the params
    for k, v in _stats(fedavg.variables).items():
        assert torch.equal(api.variables[k], v), k
    assert not torch.equal(api.variables["fc.weight"],
                           fedavg.variables["fc.weight"])


def test_weak_dp_leaves_the_stats_untouched():
    dp = dict(defense_type="weak_dp", norm_bound=5.0, stddev=0.01)
    ref, api, model = _pair(
        JaxFedAvgRobustAPI, FedAvgRobustAPI, "resnet56",
        JaxFedAvgRobustConfig(train=JaxTrainConfig(**TRAIN), **ROUND, **dp),
        FedAvgRobustConfig(train=TrainConfig(**TRAIN), **ROUND, **dp))
    start = {k: v.numpy().copy() for k, v in api.variables.items()}
    fedavg = _fedavg_port(api.variables)
    ref.run_round(0)
    api.run_round(0)
    fedavg.run_round(0)
    # the noise streams differ (ROADMAP Queue 3); the statistics take none
    want = _convert(ref.variables, model)
    for k, v in _stats(want).items():
        np.testing.assert_allclose(api.variables[k].numpy(), v.numpy(),
                                   err_msg=k, **TOL)
        assert not np.allclose(v.numpy(), start[k]), k
        assert torch.equal(api.variables[k], fedavg.variables[k]), k
    # the weights, BN scale and bias among them, took noise
    for k in ("blocks.0.bn1.weight", "fc.weight"):
        d = (api.variables[k] - fedavg.variables[k]).abs().max()
        assert float(d) > 1e-4, k


def test_fednova_threads_the_stats_and_matches_jax():
    train = dict(TRAIN, momentum=0.9)
    nova = dict(mu=0.01, gmf=0.5)
    ref, api, model = _pair(
        JaxFedNovaAPI, FedNovaAPI, "resnet56",
        JaxFedNovaConfig(train=JaxTrainConfig(**train), **ROUND, **nova),
        FedNovaConfig(train=TrainConfig(**train), **ROUND, **nova))
    start = {k: v.numpy().copy() for k, v in api.variables.items()}
    want_idxs, want_stats = ref.run_round(0)
    idxs, stats = api.run_round(0)
    assert list(idxs) == list(want_idxs)
    _assert_close(api.variables, ref.variables, model, start)
    buf = _convert({"params": ref.momentum_buf}, model, params_only=True)
    assert set(buf) == set(api.momentum_buf)
    for k in buf:
        np.testing.assert_allclose(api.momentum_buf[k].numpy(),
                                   buf[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("per_round", [2, 3])
def test_fused_block_equals_host_loop_on_a_bn_model(per_round):
    _, _, kind, task, classes = _models("resnet56")
    train, test = _clients(kind, classes, seed=4)
    ds = FederatedDataset.from_client_arrays(train, test, classes)
    cfg = FedAvgConfig(comm_round=3, client_num_per_round=per_round,
                       frequency_of_the_test=100, train=TrainConfig(
                           epochs=2, batch_size=4, lr=0.1, momentum=0.9))
    host, fused_api = (FedAvgAPI(ds, CifarResNet([1, 1, 1], classes),
                                 task=task, config=cfg, device="cpu")
                       for _ in range(2))
    start = {k: v.clone() for k, v in host.variables.items()}
    host_stats = [host.run_round(r)[1] for r in range(3)]
    stats = fused_api.fused_rounds().run_rounds(0, 3)
    for k in host.variables:
        assert torch.equal(host.variables[k], fused_api.variables[k]), k
    for k in _stats(start):
        assert not torch.equal(host.variables[k], start[k]), k
    for k in stats:
        assert torch.equal(stats[k], torch.stack([s[k] for s in host_stats]))


def _fast_init(flax_cls, start):
    """flax's ``init`` of ``flax_cls`` returning fresh arrays of ``start``:
    the JAX APIs init their models eagerly, seconds a model here, and
    every run of a comparison starts from ``start`` anyway."""
    return mock.patch.object(flax_cls, "init", lambda *a, **k: jax.tree.map(
        jnp.asarray, start))


def _bn_start(seed=5):
    """A small ResNet-56's flax variables in float64 (one bottleneck block
    a stage), the flax model and the port model. The item-17a comparisons
    run several BN rounds at batch 4, where f32 round-off grows past the
    tolerances on both sides alike, so they run in float64."""
    flax_model, model, kind, _, classes = _models("resnet56")
    x = _clients(kind, classes)[0][0][0][:1]
    start = jax.jit(flax_model.init)(jax.random.key(seed), jnp.asarray(x))
    return flax_model, model, jax.tree.map(
        lambda a: np.asarray(a, np.float64), start)


def _f64_clients():
    train, test = _clients("image")
    return tuple({c: (x.astype(np.float64), y) for c, (x, y) in d.items()}
                 for d in (train, test))


def _f64(state):
    return {k: v.double() for k, v in state.items()}


def test_hierarchical_carries_the_stats_and_matches_jax():
    from fedml_tpu.algorithms.hierarchical import \
        HierarchicalConfig as JaxHierarchicalConfig
    from fedml_tpu.algorithms.hierarchical import \
        HierarchicalFedAvgAPI as JaxHierarchicalFedAvgAPI
    from fedml_tpu_torch.algorithms.hierarchical import (
        HierarchicalConfig, HierarchicalFedAvgAPI)
    flax_model, model, start = _bn_start()
    train, test = _f64_clients()
    cfg = dict(global_comm_round=2, group_num=2, group_comm_round=2,
               client_num_per_round=3, frequency_of_the_test=1, seed=1)
    with jax.enable_x64(True), _fast_init(FlaxCifarResNet, start):
        ref = JaxHierarchicalFedAvgAPI(
            JaxFederatedDataset.from_client_arrays(train, test, 5),
            flax_model, config=JaxHierarchicalConfig(
                train=JaxTrainConfig(**TRAIN), **cfg))
        ref.train()
    api = HierarchicalFedAvgAPI(
        FederatedDataset.from_client_arrays(train, test, 5), model,
        device="cpu", config=HierarchicalConfig(
            train=TrainConfig(**TRAIN), **cfg))
    assert np.array_equal(api.group_indexes, ref.group_indexes)
    assert len(set(api.group_indexes)) == 2
    api.variables = _f64(_convert(start, model))
    begin = {k: v.numpy().copy() for k, v in api.variables.items()}
    api.train()
    _assert_close(api.variables, ref.variables, model, begin)
    for got, want in zip(api.history, ref.history):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)


def test_turboaggregate_carries_the_stats_and_matches_jax():
    from fedml_tpu.algorithms.turboaggregate import \
        SecureFedAvgAPI as JaxSecureFedAvgAPI
    from fedml_tpu_torch.algorithms.turboaggregate import SecureFedAvgAPI
    flax_model, model, start = _bn_start()
    train, test = _f64_clients()
    rounds = dict(comm_round=2, client_num_per_round=2,
                  frequency_of_the_test=100)
    with jax.enable_x64(True), _fast_init(FlaxCifarResNet, start):
        ref = JaxSecureFedAvgAPI(
            JaxFederatedDataset.from_client_arrays(train, test, 5),
            flax_model, config=JaxFedAvgConfig(
                train=JaxTrainConfig(**TRAIN), **rounds))
        for r in range(2):
            ref.run_round(r)
    ds = FederatedDataset.from_client_arrays(train, test, 5)
    cfg = FedAvgConfig(train=TrainConfig(**TRAIN), **rounds)
    api = SecureFedAvgAPI(ds, model, config=cfg, device="cpu")
    plain = FedAvgAPI(ds, CifarResNet([1, 1, 1], 5), config=cfg,
                      device="cpu")
    api.variables = _f64(_convert(start, model))
    plain.variables = dict(api.variables)
    begin = {k: v.numpy().copy() for k, v in api.variables.items()}
    api.run_round(0)
    plain.run_round(0)
    # the running statistics survive the field's fixed point: the round's
    # secure mean lies within its round-off of the plain one
    for k, v in _stats(plain.variables).items():
        np.testing.assert_allclose(api.variables[k].numpy(), v.numpy(),
                                   rtol=0, atol=2.0 ** -15, err_msg=k)
    api.run_round(1)
    _assert_close(api.variables, ref.variables, model, begin)


def test_secure_sum_range_is_the_jax_packages():
    """The field holds sums of ``n_i * v`` below 2**14 at frac_bits 16 (p =
    2**31 - 1): a BN variance inside it comes back within round-off, one
    past it wraps, in the port exactly as in the JAX package."""
    from fedml_tpu.algorithms.turboaggregate import \
        SecureAggregator as JaxSecureAggregator
    from fedml_tpu_torch.algorithms.turboaggregate import SecureAggregator
    weights = np.asarray([80.0, 60.0], np.float32)
    for var, inside in ((100.0, True), (150.0, False)):  # x 140 samples
        stacked = np.full((2, 4), var, np.float32)
        got = SecureAggregator().aggregate(
            {"running_var": torch.from_numpy(stacked)},
            torch.from_numpy(weights))["running_var"].numpy()
        want = np.asarray(JaxSecureAggregator().aggregate(
            {"running_var": jnp.asarray(stacked)}, weights)["running_var"])
        assert np.array_equal(got, want)
        assert np.allclose(got, var, atol=2.0 ** -15) == inside


def test_centralized_carries_the_stats_and_matches_jax():
    from fedml_tpu.algorithms.centralized import \
        CentralizedTrainer as JaxCentralizedTrainer
    from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
    flax_model, model, start = _bn_start()
    train, test = _f64_clients()
    tc = dict(epochs=1, batch_size=8, lr=0.05, shuffle=False)
    with jax.enable_x64(True), _fast_init(FlaxCifarResNet, start):
        ref = JaxCentralizedTrainer(
            JaxFederatedDataset.from_client_arrays(train, test, 5),
            flax_model, cfg=JaxTrainConfig(**tc))
        for _ in range(2):
            ref.train()
        want = ref.evaluate()
    cent = CentralizedTrainer(
        FederatedDataset.from_client_arrays(train, test, 5), model,
        cfg=TrainConfig(**tc), device="cpu")
    cent.trainer.set_model_params(_f64(_convert(start, model)))
    begin = {k: v.numpy().copy() for k, v in cent.variables.items()}
    for _ in range(2):
        cent.train()
    _assert_close(cent.variables, ref.variables, model, begin)
    got = cent.evaluate()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_leave_one_out_on_a_bn_model_matches_jax(monkeypatch):
    from fedml_tpu.contribution import LeaveOneOutMeasure as JaxLOO
    from fedml_tpu_torch.contribution import LeaveOneOutMeasure, loo
    flax_model, _, start = _bn_start()
    train, test = ({c: d[c] for c in (0, 1)} for d in _f64_clients())
    rounds = dict(comm_round=1, client_num_per_round=2,
                  frequency_of_the_test=100)
    with jax.enable_x64(True), _fast_init(FlaxCifarResNet, start):
        want = JaxLOO(JaxFederatedDataset.from_client_arrays(train, test, 5),
                      lambda: flax_model, JaxFedAvgConfig(
                          train=JaxTrainConfig(**TRAIN), **rounds)
                      ).compute_influence()
    sd = _f64(_convert(start, CifarResNet([1, 1, 1], 5)))

    class FromJaxInit(FedAvgAPI):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.variables = {n: t.clone() for n, t in sd.items()}
    monkeypatch.setattr(loo, "FedAvgAPI", FromJaxInit)
    got = LeaveOneOutMeasure(
        FederatedDataset.from_client_arrays(train, test, 5),
        lambda: CifarResNet([1, 1, 1], 5),
        FedAvgConfig(train=TrainConfig(**TRAIN), **rounds),
        device="cpu").compute_influence()
    assert len(got) == 2 and max(want) > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
