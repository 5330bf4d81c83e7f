"""bf16 compute with f32 masters (``TrainConfig.compute_dtype``) against
the JAX package's, and against the port's own f32 run.

The casts are explicit on the autograd path on both sides, so the same ops
run in bf16, but the two frameworks round at other places. Measured on one
CNN round: XLA reduces a convolution's bias gradient in bf16 over the
batch and every position, torch in f32, so JAX's bf16 conv1 bias lies
4.3e-2 from its f32 run where the port's lies 6e-4 from its own (conv2's
bias: 4.8e-3 and 8e-4); every other leaf differs by about a bf16 ulp times
the learning rate a step. So the CNN's conv biases are held to JAX's bf16
at the JAX test's own bf16 tolerance widened to atol 0.05
(tests/test_mixed_precision.py: rtol 0.05, atol 0.02), its other leaves
at atol 2.5e-3 (measured at most 1.3e-3, on fc1's weight, whose bf16 and
f32 rounds lie 4.9e-3 apart: the test checks that the port's f32 round
falls outside this tolerance), and every leaf to be no farther from JAX's
f32 run than JAX's bf16 run is (1.5x, plus 1e-4). The LM, whose layers
reduce in f32 on both sides, is held at rtol 1e-2, atol 1e-3 (measured
1.4e-4). The port's bf16 run against its f32 run uses the JAX test's
tolerance.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.data.synthetic import make_token_federated as jax_tokens
from fedml_tpu.models.transformer import TransformerLM as FlaxLM
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.data.synthetic import (make_blob_federated,
                                            make_token_federated)
from fedml_tpu_torch.models import CNN_DropOut, create_model
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_local_train,
                                                make_train_step)
from fedml_tpu_torch.utils.convert import flax_to_state_dict

JAX_F32_TOL = dict(rtol=0.05, atol=0.02)
PORT_JAX_TOL = {"cnn": dict(rtol=0.0, atol=2.5e-3),
                "lm": dict(rtol=1e-2, atol=1e-3)}
CONV_BIAS_TOL = dict(rtol=0.05, atol=0.05)


def _port_jax_tol(name, leaf):
    if name == "cnn" and leaf.startswith("conv") and leaf.endswith(".bias"):
        return CONV_BIAS_TOL
    return PORT_JAX_TOL[name]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch CPU thread for these tests: the suite runs in parallel
    workers, and many-threaded CPU convolutions in each oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _max_rel(a, b):
    return float(np.max(np.abs(a - b)) / max(1e-12, np.max(np.abs(b))))


def _cnn_round(dtype):
    train, test = _image_clients([10, 14, 7])
    kw = dict(epochs=1, batch_size=8, lr=0.1, shuffle=False,
              compute_dtype=dtype)
    rounds = dict(comm_round=1, client_num_per_round=2,
                  frequency_of_the_test=100)
    ref = JaxFedAvgAPI(
        JaxFederatedDataset.from_client_arrays(train, test, 62),
        _FlaxCNNNoDropout(),
        config=JaxFedAvgConfig(train=JaxTrainConfig(**kw), **rounds))
    model = _CNNNoDropout(only_digits=False)
    api = FedAvgAPI(FederatedDataset.from_client_arrays(train, test, 62),
                    model,
                    config=FedAvgConfig(train=TrainConfig(**kw), **rounds),
                    device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    ref.run_round(0)
    api.run_round(0)
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables), model)
    return ({k: v.numpy() for k, v in api.variables.items()},
            {k: v.numpy() for k, v in want.items()})


TOKENS = dict(client_num=4, vocab_size=40, seq_len=16,
              sequences_per_client=8, seed=3)
LM = dict(vocab_size=40, width=32, depth=2, num_heads=2, max_len=16)


class _NumpyInitLM:
    """The flax LM with variables drawn from numpy (tree from eval_shape)."""

    def __init__(self, seed=0, **cfg):
        self.module, self.seed = FlaxLM(**cfg), seed

    def init(self, key, x, train=False):
        shapes = jax.eval_shape(functools.partial(self.module.init,
                                                  train=train), key, x)
        rng = np.random.RandomState(self.seed)
        return jax.tree.map(
            lambda sd: jnp.asarray(0.3 * rng.randn(*sd.shape), jnp.float32),
            shapes)

    def apply(self, *args, **kw):
        return self.module.apply(*args, **kw)


def _lm_round(dtype):
    kw = dict(epochs=1, batch_size=4, lr=0.1, shuffle=False,
              compute_dtype=dtype)
    rounds = dict(comm_round=1, client_num_per_round=3,
                  frequency_of_the_test=100)
    ref = JaxFedAvgAPI(jax_tokens(**TOKENS), _NumpyInitLM(**LM), task="nwp",
                       config=JaxFedAvgConfig(train=JaxTrainConfig(**kw),
                                              **rounds))
    model = TransformerLM(**LM)
    api = FedAvgAPI(make_token_federated(**TOKENS), model, task="nwp",
                    config=FedAvgConfig(train=TrainConfig(**kw), **rounds),
                    device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    ref.run_round(0)
    api.run_round(0)
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables), model)
    return ({k: v.numpy() for k, v in api.variables.items()},
            {k: v.numpy() for k, v in want.items()})


ROUNDS = {"cnn": _cnn_round, "lm": _lm_round}


@pytest.mark.parametrize("name", ["cnn", "lm"])
def test_bf16_round_matches_jax_bf16(name):
    got16, want16 = ROUNDS[name]("bfloat16")
    got32, want32 = ROUNDS[name](None)
    for k in want16:
        assert got16[k].dtype == np.float32
        np.testing.assert_allclose(got16[k], want16[k], err_msg=k,
                                   **_port_jax_tol(name, k))
        # no farther from the f32 trajectory than JAX's own bf16 run
        jax_err = np.abs(want16[k] - want32[k]).max()
        assert np.abs(got16[k] - want32[k]).max() <= 1.5 * jax_err + 1e-4, k
    if name == "cnn":
        # the tolerance tells a bf16 round from an f32 one: a round that
        # ignored compute_dtype would fail it
        assert not all(np.allclose(got32[k], want16[k],
                                   **_port_jax_tol(name, k))
                       for k in want16)


@pytest.mark.parametrize("name", ["cnn", "lm"])
def test_bf16_round_close_to_f32_round(name):
    got16, _ = ROUNDS[name]("bfloat16")
    got32, _ = ROUNDS[name](None)
    for k in got32:
        np.testing.assert_allclose(got16[k], got32[k], err_msg=k,
                                   **JAX_F32_TOL)
    assert any(not np.array_equal(got16[k], got32[k]) for k in got32)


@pytest.mark.parametrize("opt", [dict(), dict(client_optimizer="adam",
                                              wd=1e-4)])
def test_masters_and_optimizer_state_stay_f32(opt):
    model = create_model("cnn", 62)
    cfg = TrainConfig(batch_size=4, lr=0.05, compute_dtype="bfloat16",
                      momentum=0.9, **opt)
    init, step = make_train_step(model, "classification", cfg)
    names = list(model.state_dict())
    params = [v.detach().clone() for v in model.state_dict().values()]
    state = init(params)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 28, 28, 1).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 62, 4).astype(np.int32))
    params, _, state, stats = step(names, params, {}, state, x, y,
                                   torch.ones(4), torch.tensor(7))
    leaves = [params, state["trace"] if "trace" in state else state["mu"]]
    assert all(t.dtype == torch.float32 for group in leaves for t in group)
    assert all(v.dtype == torch.float32 for v in stats.values())
    out, _ = make_local_train(model, "classification", cfg)(
        dict(zip(names, params)), x, y, torch.ones(4), seed=1)
    assert all(v.dtype == torch.float32 for v in out.values())


def test_bf16_federation_learns():
    ds = make_blob_federated(client_num=4, dim=16, class_num=4,
                             n_samples=400, seed=5)
    api = FedAvgAPI(
        ds, create_model("lr", ds.class_num, input_shape=(16,)),
        device="cpu", config=FedAvgConfig(
            comm_round=15, client_num_per_round=4, frequency_of_the_test=100,
            train=TrainConfig(epochs=1, batch_size=32, lr=0.2,
                              compute_dtype="bfloat16")))
    api.train()
    assert api.evaluate(15)["test_acc"] > 0.8
