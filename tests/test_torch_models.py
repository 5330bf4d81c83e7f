"""Converted-weight parity of the port's models against the flax models.

Eval-mode forward to atol=1e-5 and the gradient of the masked CE loss to
rtol=1e-4: the CNN's convolutions sum in another order in torch than in
XLA, which moves the last bits of f32 results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.cnn import CNN_DropOut as FlaxCNN
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.tasks import classification_head as jax_head
from fedml_tpu_torch.core.sampling import make_generator
from fedml_tpu_torch.models import CNN_DropOut, create_model
from fedml_tpu_torch.models.common import dropout, init_params
from fedml_tpu_torch.trainer.functional import make_forward
from fedml_tpu_torch.trainer.tasks import classification_head
from fedml_tpu_torch.utils.convert import flax_to_state_dict


def _case(name):
    rng = np.random.RandomState(0)
    if name == "lr":
        x = rng.randn(9, 12).astype(np.float32)
        flax_model = FlaxLR(num_classes=5)
        model = create_model("lr", 5, input_shape=(12,))
        classes = 5
    else:
        x = rng.rand(6, 28, 28, 1).astype(np.float32)
        flax_model = FlaxCNN(only_digits=False)
        model = create_model("cnn", 62)
        classes = 62
    y = rng.randint(0, classes, len(x)).astype(np.int32)
    mask = np.ones(len(x), np.float32)
    mask[-2:] = 0.0  # padding rows
    variables = flax_model.init(jax.random.key(1), jnp.asarray(x))
    return flax_model, model, variables, x, y, mask


def _np_params(variables):
    return jax.tree.map(np.asarray, variables)


@pytest.mark.parametrize("name", ["lr", "cnn"])
def test_eval_forward_matches_flax(name):
    flax_model, model, variables, x, _, _ = _case(name)
    state = flax_to_state_dict(_np_params(variables), model)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x)))
    got = make_forward(model)(state, torch.from_numpy(x), False)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)


def test_cnn_accepts_rank3_and_rank4_nhwc():
    _, model, variables, x, _, _ = _case("cnn")
    state = flax_to_state_dict(_np_params(variables), model)
    fwd = make_forward(model)
    a = fwd(state, torch.from_numpy(x), False)
    b = fwd(state, torch.from_numpy(x[..., 0]), False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["lr", "cnn"])
def test_masked_ce_gradient_matches_flax(name):
    flax_model, model, variables, x, y, mask = _case(name)

    def loss(v):
        stats = jax_head(flax_model.apply(v, jnp.asarray(x)),
                         jnp.asarray(y), jnp.asarray(mask))
        return stats["loss_sum"] / jnp.maximum(stats["count"], 1.0)

    want = flax_to_state_dict(_np_params(jax.grad(loss)(variables)), model)
    state = flax_to_state_dict(_np_params(variables), model)
    leaves = {k: v.requires_grad_(True) for k, v in state.items()}
    out = make_forward(model)(leaves, torch.from_numpy(x), False)
    stats = classification_head(out, torch.from_numpy(y),
                                torch.from_numpy(mask))
    got = torch.autograd.grad(stats["loss_sum"] / stats["count"].clamp(min=1),
                              list(leaves.values()))
    for k, g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_classification_head_matches_jax_sums():
    rng = np.random.RandomState(3)
    logits = rng.randn(10, 7).astype(np.float32)
    y = rng.randint(0, 7, 10).astype(np.int32)
    mask = (rng.rand(10) > 0.3).astype(np.float32)
    got = classification_head(torch.from_numpy(logits), torch.from_numpy(y),
                               torch.from_numpy(mask))
    want = jax_head(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_cnn_has_the_published_parameter_count():
    model = CNN_DropOut(only_digits=False)
    assert sum(p.numel() for p in model.parameters()) == 1_206_590
    assert sum(p.numel() for p in CNN_DropOut().parameters()) == 1_199_882


def test_converter_rejects_wrong_shape():
    _, model, variables, _, _, _ = _case("cnn")
    params = _np_params(variables)
    params["params"]["Dense_0"]["kernel"] = \
        params["params"]["Dense_0"]["kernel"][:-1]
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        flax_to_state_dict(params, model)


@pytest.mark.parametrize("drop", ["module", "leaf"])
def test_converter_rejects_missing_key(drop):
    _, model, variables, _, _, _ = _case("lr")
    params = _np_params(variables)
    if drop == "module":
        del params["params"]["Dense_0"]
    else:
        del params["params"]["Dense_0"]["bias"]
    with pytest.raises(KeyError):
        flax_to_state_dict(params, model)


@pytest.mark.parametrize("where", ["collection", "module", "leaf"])
def test_converter_rejects_unknown_key(where):
    _, model, variables, _, _, _ = _case("lr")
    params = _np_params(variables)
    if where == "collection":
        params["batch_stats"] = {}
    elif where == "module":
        params["params"]["Dense_1"] = params["params"]["Dense_0"]
    else:
        params["params"]["Dense_0"]["scale"] = np.ones(5, np.float32)
    with pytest.raises(ValueError, match="unknown"):
        flax_to_state_dict(params, model)


def test_init_matches_flax_lecun_normal_statistics():
    model = init_params(CNN_DropOut(only_digits=False), make_generator(0))
    w = model.fc1.weight.detach().numpy()
    # truncated at 2 std of the untruncated normal; variance 1 / fan_in
    assert abs(w.std() * np.sqrt(9216) - 1.0) < 0.01
    assert np.abs(w).max() <= 2 * np.sqrt(1 / 9216) / 0.87962566103423978
    assert not model.fc1.bias.detach().any()
    again = init_params(CNN_DropOut(only_digits=False), make_generator(0))
    assert torch.equal(model.conv1.weight, again.conv1.weight)


def test_dropout_draws_from_the_given_generator_only():
    x = torch.ones(1000)
    a = dropout(x, 0.25, True, make_generator(7))
    b = dropout(x, 0.25, True, make_generator(7))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert 0.65 < kept.float().mean() < 0.85
    assert torch.equal(dropout(x, 0.25, False, None), x)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.25, True, None)
