"""Converted-weight parity of the cross-device anchors' models against the
flax models: eval-mode forward of ResNet-18-GN (both stems, one block a
stage on 8x8 inputs), the CIFAR ResNets at reduced depth (``kd`` too, with
BN running statistics away from their init) and the three LSTMs at narrow
widths, plus the converter's layouts and refusals, the flax-default
initialization, the published sizes and the tag-prediction head.

Tolerances: the forward atol=1e-5 (torch and XLA sum a convolution's and
an LSTM product's terms in another order); the head's sums rtol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as FlaxCifarResNet
from fedml_tpu.models.resnet_gn import ResNetGN as FlaxResNetGN
from fedml_tpu.trainer.tasks import tag_prediction_head as jax_tag_head
from fedml_tpu_torch.core.sampling import make_generator
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.common import LSTM, BatchNorm, init_params
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.models.resnet_gn import ResNetGN
from fedml_tpu_torch.trainer.functional import make_forward
from fedml_tpu_torch.trainer.tasks import tag_prediction_head
from fedml_tpu_torch.utils.convert import flax_to_state_dict

NARROW = {"rnn": dict(vocab_size=20, embedding_dim=4, hidden_size=12),
          "rnn_seq": dict(embedding_dim=4, hidden_size=12),
          "rnn_stackoverflow": dict(vocab_size=16, embedding_size=6,
                                    latent_size=10, num_layers=2)}


def _case(name):
    rng = np.random.RandomState(0)
    if name.startswith("resnet18_gn"):
        small = name.endswith("small")
        x = rng.rand(3, 8 if small else 16, 8 if small else 16,
                     3).astype(np.float32)
        return (FlaxResNetGN([1, 1, 1, 1], num_classes=7,
                             small_images=small),
                ResNetGN([1, 1, 1, 1], 7, small_images=small), x)
    if name.startswith("cifar_resnet"):
        stages, kd = ([1, 1, 1], False) if name.endswith("56") else \
            ([2, 1, 1], True)
        x = rng.rand(3, 8, 8, 3).astype(np.float32)
        return (FlaxCifarResNet(stages, num_classes=6, kd=kd),
                CifarResNet(stages, 6, kd=kd), x)
    x = rng.randint(0, 16, (3, 7)).astype(np.int32)
    return (jax_create_model(name, 20, **NARROW[name]),
            create_model(name, 20, **NARROW[name]), x)


def _variables(flax_model, x, seed=1):
    v = jax.tree.map(np.asarray, flax_model.init(jax.random.key(seed),
                                                  jnp.asarray(x)))
    if "batch_stats" in v:
        rng = np.random.RandomState(seed)
        v["batch_stats"] = jax.tree.map(
            lambda a: (a + rng.rand(*a.shape)).astype(np.float32),
            v["batch_stats"])
    return v


@pytest.mark.parametrize("name", [
    "resnet18_gn_small", "resnet18_gn_imagenet_stem", "cifar_resnet56",
    "cifar_resnet110_kd", "rnn", "rnn_seq", "rnn_stackoverflow"])
def test_eval_forward_matches_flax(name):
    flax_model, model, x = _case(name)
    v = _variables(flax_model, x)
    want = flax_model.apply(v, jnp.asarray(x))
    got = make_forward(model)(flax_to_state_dict(v, model),
                              torch.from_numpy(x), False)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=0)


def test_lstm_layout_follows_the_gate_order():
    flax_model, model, x = _case("rnn_seq")
    v = _variables(flax_model, x)
    sd = flax_to_state_dict(v, model)
    cell = v["params"]["OptimizedLSTMCell_0"]
    h = model.lstm1.hidden_size
    for k, g in enumerate("ifgo"):
        rows = slice(k * h, (k + 1) * h)
        assert np.array_equal(sd["lstm1.weight_ih"][rows].numpy(),
                              cell[f"i{g}"]["kernel"].T)
        assert np.array_equal(sd["lstm1.weight_hh"][rows].numpy(),
                              cell[f"h{g}"]["kernel"].T)
        assert np.array_equal(sd["lstm1.bias"][rows].numpy(),
                              cell[f"h{g}"]["bias"])


@pytest.mark.parametrize("fault", ["missing_gate", "gate_bias", "shape"])
def test_converter_refuses_a_bad_lstm_cell(fault):
    flax_model, model, x = _case("rnn")
    v = _variables(flax_model, x)
    cell = v["params"]["OptimizedLSTMCell_1"]
    if fault == "missing_gate":
        del cell["hg"]
        err = KeyError
    elif fault == "gate_bias":
        cell["if"]["bias"] = np.zeros(12, np.float32)
        err = ValueError
    else:
        cell["ho"]["kernel"] = cell["ho"]["kernel"][:, :-1]
        err = ValueError
    with pytest.raises(err, match="OptimizedLSTMCell_1"):
        flax_to_state_dict(v, model)


@pytest.mark.parametrize("fault", ["missing", "unknown_module",
                                   "unknown_leaf"])
def test_converter_refuses_bad_batch_stats(fault):
    flax_model, model, x = _case("cifar_resnet56")
    v = _variables(flax_model, x)
    bs = v["batch_stats"]
    if fault == "missing":
        del bs["BottleneckBlock_1"]["BatchNorm_2"]
        err, match = KeyError, "BottleneckBlock_1/BatchNorm_2"
    elif fault == "unknown_module":
        bs["BatchNorm_9"] = bs["BatchNorm_0"]
        err, match = ValueError, "unknown"
    else:
        bs["BatchNorm_0"]["count"] = np.zeros(16, np.float32)
        err, match = ValueError, "BatchNorm_0"
    with pytest.raises(err, match=match):
        flax_to_state_dict(v, model)
    # a params-shaped tree converts without the statistics
    params = flax_to_state_dict({"params": v["params"]}, model,
                                params_only=True)
    assert set(params) == {n for n, _ in model.named_parameters()}


def test_init_follows_the_flax_defaults():
    model = init_params(create_model("rnn_seq", 90), make_generator(0))
    w_hh = model.lstm2.weight_hh.detach().double()
    for gate in w_hh.chunk(4, 0):  # each gate's block is orthogonal
        np.testing.assert_allclose((gate @ gate.T).numpy(), np.eye(256),
                                   atol=1e-5)
    w_ih = model.lstm2.weight_ih.detach().numpy()
    assert abs(w_ih.std() * np.sqrt(256) - 1.0) < 0.02
    assert not model.lstm2.bias.detach().any()
    net = init_params(CifarResNet([1, 1, 1], 10), make_generator(0))
    for m in net.modules():
        if isinstance(m, BatchNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any() and not m.running_mean.any()
            assert torch.equal(m.running_var, torch.ones_like(m.weight))
    gn = init_params(ResNetGN([1, 1, 1, 1], 10), make_generator(0))
    assert gn.stem_norm.eps == 1e-6 and gn.stem_norm.num_groups == 2
    assert gn.blocks[3].norm1.num_groups == 16


def test_published_sizes_and_buffers():
    def count(m):
        return sum(p.numel() for p in m.parameters())
    assert count(create_model("resnet18_gn", 100)) == 11_220_132
    assert count(create_model("rnn_stackoverflow", 5)) == 4_050_748
    assert count(create_model("rnn_seq", 90)) == 820_522
    r56 = create_model("resnet56", 10)
    assert count(r56) == 591_322
    assert sum(b.numel() for b in r56.buffers()) == 8_992
    assert all(b.dtype == torch.float32 for b in r56.buffers())
    assert not any("num_batches_tracked" in k for k in r56.state_dict())
    assert len(create_model("resnet110", 10).blocks) == 36
    assert not list(create_model("resnet18_gn", 100).buffers())
    assert sum(isinstance(m, LSTM) for m in
               create_model("rnn", 90).modules()) == 2


def test_tag_prediction_head_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(9, 6).astype(np.float32) * 3
    targets = (rng.rand(9, 6) > 0.6).astype(np.float32)
    targets[0] = 0.0  # no true tag: recall's 1e-13 term
    logits[1] = -5.0  # no predicted tag: precision's 1e-13 term
    mask = (rng.rand(9) > 0.2).astype(np.float32)
    got = tag_prediction_head(torch.from_numpy(logits),
                              torch.from_numpy(targets),
                              torch.from_numpy(mask))
    want = jax_tag_head(jnp.asarray(logits), jnp.asarray(targets),
                        jnp.asarray(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)
