"""Converted-weight parity of the rest of the CV zoo against the flax
models: MobileNet (width 0.25), MobileNetV3 LARGE and SMALL (multiplier
0.25, LARGE with dropout 0.2), VGG-11 with and without BatchNorm at 64x64
(the flatten order shows only past a 1x1 map), EfficientNet-b0 at 32x32
and SegNet at width 8 on 32x32 and on a non-square 48x40. Each holds its
parameter count, the eval forward, the train forward's new BN statistics
and one SGD step's gradients to the JAX model. Every dropout and
drop-connect mask is forced to keep-all on both sides by patching the mask
draw here (``jax.random.bernoulli``, ``DropoutKey.bits``); the
drop-connect mask's keep rate is held on its own. Also: flax's ``"SAME"``
padding, the bilinear upsample against ``jax.image.resize``, the factory's
names and the EfficientNet variants (b0's and b7's sizes against flax's
abstract init), and one FedAvg round of MobileNet-0.25 against the JAX API.

The train step (its output, new statistics and gradients) and the FedAvg
round run in float64 on both sides: at batch 2 to 4 on 1x1 and 2x2 maps a
BN train step is ill-conditioned, and in f32 its round-off grows past
these tolerances on both sides alike; the eval forward runs in f32.

Tolerances: forwards and gradients rtol 1e-4, atol 1e-5 (gradients: 1e-4
of the model's largest); BN statistics atol 1e-5.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.efficientnet import efficientnet as flax_efficientnet
from fedml_tpu.models.mobilenet import MobileNet as FlaxMobileNet
from fedml_tpu.models.mobilenet_v3 import MobileNetV3 as FlaxMobileNetV3
from fedml_tpu.models.segnet import SegNet as FlaxSegNet
from fedml_tpu.models.vgg import VGG as FlaxVGG
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu.trainer.tasks import TASK_HEADS as JAX_HEADS
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.common import (DropoutKey, SameConv2d,
                                           drop_connect)
from fedml_tpu_torch.models.efficientnet import (BASE_STAGES, PARAMS,
                                                 efficientnet, round_filters,
                                                 round_repeats)
from fedml_tpu_torch.models.mobilenet import MobileNet
from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3
from fedml_tpu_torch.models.segnet import SegNet
from fedml_tpu_torch.models.vgg import VGG
from fedml_tpu_torch.trainer.functional import (TrainConfig, make_forward,
                                                make_train_forward,
                                                param_names)
from fedml_tpu_torch.trainer.tasks import TASK_HEADS
from fedml_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-5)
STATS_ATOL = 1e-5
TRAIN_OUT_TOL = 1e-4
GRAD_RTOL = 1e-4
CLASSES = 7


def _cases():
    """name -> (flax model, port model, input shape, task)"""
    cls = "classification"
    return {
        "mobilenet": (FlaxMobileNet(num_classes=CLASSES,
                                    width_multiplier=0.25),
                      MobileNet(CLASSES, 0.25), (2, 32, 32, 3), cls),
        "mobilenet_v3_large": (
            FlaxMobileNetV3(num_classes=CLASSES, model_mode="LARGE",
                            multiplier=0.25, dropout_rate=0.2),
            MobileNetV3(CLASSES, "LARGE", 0.25, dropout_rate=0.2),
            (2, 32, 32, 3), cls),
        "mobilenet_v3_small": (
            FlaxMobileNetV3(num_classes=CLASSES, model_mode="SMALL",
                            multiplier=0.25),
            MobileNetV3(CLASSES, "SMALL", 0.25), (2, 32, 32, 3), cls),
        "vgg11": (FlaxVGG("vgg11", CLASSES),
                  VGG("vgg11", CLASSES, image_size=(64, 64)),
                  (2, 64, 64, 3), cls),
        "vgg11_bn": (FlaxVGG("vgg11", CLASSES, batch_norm=True),
                     VGG("vgg11", CLASSES, True, image_size=(64, 64)),
                     (2, 64, 64, 3), cls),
        "efficientnet_b0": (flax_efficientnet("efficientnet-b0", CLASSES),
                            efficientnet("efficientnet-b0", CLASSES),
                            (2, 32, 32, 3), cls),
        "segnet": (FlaxSegNet(num_classes=3, width=8), SegNet(3, 8),
                   (2, 32, 32, 3), "segmentation"),
        "segnet_48x40": (FlaxSegNet(num_classes=3, width=8), SegNet(3, 8),
                         (2, 48, 40, 3), "segmentation"),
    }


NAMES = list(_cases())


def _random_variables(flax_model, x, rng):
    """Variables of ``flax_model`` drawn with numpy from its abstract init
    (flax's own ``init`` runs eagerly, and takes seconds a model here):
    kernels of variance 1/fan_in, norm scales near 1, biases and BN means
    near 0, BN variances in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.key(0), jnp.asarray(x), train=False))

    def draw(path, a):
        leaf, col = path[-1].key, path[0].key
        if leaf == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            w = rng.randn(*a.shape) / np.sqrt(fan_in)
        elif leaf in ("scale", "var"):
            w = 1.0 + (rng.rand(*a.shape) - 0.5) * (
                1.0 if col == "batch_stats" else 0.2)
        else:  # bias, mean
            w = 0.1 * rng.randn(*a.shape)
        return w.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The flax model's variables, the same weights as the port model's
    state dict, and an input batch with labels."""
    flax_model, model, shape, task = _cases()[name]
    rng = np.random.RandomState(NAMES.index(name))
    x = rng.rand(*shape).astype(np.float32)
    y = (rng.randint(0, 3, shape[:3]) if task == "segmentation"
         else rng.randint(0, CLASSES, shape[0])).astype(np.int32)
    v = _random_variables(flax_model, x, rng)
    return flax_model, model, v, flax_to_state_dict(v, model), x, y, task


@contextlib.contextmanager
def keep_all_masks():
    """Every dropout and drop-connect mask keeps everything, on both sides;
    yields the port's mask draws, by shape."""
    draws = []

    def jax_bernoulli(key, p=0.5, shape=None):
        return jnp.ones(shape, bool)

    def port_bits(self, shape, device):
        draws.append(tuple(shape))
        return torch.full(shape, 2 ** 32 - 1, dtype=torch.int64,
                          device=device)
    with mock.patch.object(jax.random, "bernoulli", jax_bernoulli), \
            mock.patch.object(DropoutKey, "bits", port_bits):
        yield draws


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=err_msg, **(tol or TOL))


@pytest.mark.parametrize("name", NAMES)
def test_param_count_and_eval_forward(name):
    flax_model, model, v, sd, x, _, _ = _setup(name)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    want = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        v, jnp.asarray(x))
    got = make_forward(model)(sd, torch.from_numpy(x), False)
    assert got.shape == want.shape
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _train_step(name):
    """One train step's loss gradients, output and new BN statistics on
    each side (float64, masks keep-all), and the port's mask draws."""
    flax_model, model, v, sd, x, y, task = _setup(name)
    head = JAX_HEADS[task]

    def loss(params):
        out, upd = flax_model.apply(
            {**v, "params": params}, jnp.asarray(x), train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.key(2)})
        stats = head(out, jnp.asarray(y), jnp.ones(len(x), jnp.float32))
        return stats["loss_sum"] / stats["count"], (out, upd)

    names = param_names(model)
    leaves = {k: t.double().requires_grad_(k in names)
              for k, t in sd.items()}
    x = x.astype(np.float64)
    v = jax.tree.map(lambda a: a.astype(np.float64), v)
    with jax.enable_x64(True), keep_all_masks() as draws:
        grads, (out, upd) = jax.jit(jax.grad(loss, has_aux=True))(
            v["params"])
        port_out, colls = make_train_forward(model)(
            leaves, torch.from_numpy(x), DropoutKey(0))
    stats = TASK_HEADS[task](port_out, torch.from_numpy(y),
                             torch.ones(len(x)))
    keys = [k for k in leaves if k in names]
    port_grads = torch.autograd.grad(stats["loss_sum"] / stats["count"],
                                     [leaves[k] for k in keys])
    want_grads = flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, grads)}, model, params_only=True)
    want_stats = (flax_to_state_dict({**v, "batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])}, model) if upd else {})
    return {"out": (port_out.detach(), np.asarray(out)),
            "grads": (dict(zip(keys, port_grads)), want_grads),
            "stats": ({k: t.detach() for k, t in colls.items()},
                      {k: t for k, t in want_stats.items()
                       if "running_" in k}),
            "draws": draws}


@pytest.mark.parametrize("name", NAMES)
def test_train_forward_batch_stats(name):
    _, model, _, sd, _, _, _ = _setup(name)
    step = _train_step(name)
    got, want = step["stats"]
    assert set(got) == set(want)
    assert bool(got) == any("running_" in k for k in sd)
    for k in want:
        _close(got[k], want[k], err_msg=k, rtol=0, atol=STATS_ATOL)
        assert not np.allclose(want[k].numpy(), sd[k].numpy()), k
    _close(*step["out"], rtol=TRAIN_OUT_TOL, atol=TRAIN_OUT_TOL)
    # the masks were drawn where the model has them: MobileNetV3's and
    # VGG's dropouts, EfficientNet's drop-connects and head dropout
    expect = {"mobilenet_v3_large": 1, "vgg11": 2, "vgg11_bn": 2}.get(
        name, 0)
    if name == "efficientnet_b0":
        expect = 1 + sum(b.residual and b.drop_rate > 0
                         for b in model.blocks)
    assert len(step["draws"]) == expect


@pytest.mark.parametrize("name", NAMES)
def test_sgd_step_gradients(name):
    got, want = _train_step(name)["grads"]
    assert set(got) == set(want)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k in want:
        # atol relative to the largest gradient of the model
        _close(got[k], want[k], err_msg=k, rtol=GRAD_RTOL,
               atol=GRAD_RTOL * scale)


def test_drop_connect_keeps_whole_examples_at_its_rate():
    p, n = 0.3, 20_000
    x = torch.ones(n, 2, 3, 3)
    out = drop_connect(x, p, True, DropoutKey(11))
    kept = out[:, 0, 0, 0] > 0
    # whole examples kept or dropped, kept ones scaled by 1 / (1 - p)
    assert torch.equal(out, kept[:, None, None, None] * (1 / (1 - p)) * x)
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - p)) < 5 * sigma
    assert torch.equal(drop_connect(x, p, False, None), x)
    assert torch.equal(drop_connect(x, 0.0, True, None), x)
    # a captured round replays it: the same key gives the same mask
    assert torch.equal(out, drop_connect(x, p, True, DropoutKey(11)))
    assert not torch.equal(out, drop_connect(x, p, True, DropoutKey(12)))


@pytest.mark.parametrize("size, kernel, stride, dilation", [
    ((32, 32), 3, 2, 1), ((16, 16), 5, 2, 1), ((31, 30), 3, 2, 1),
    ((15, 17), 5, 2, 1), ((12, 10), 3, 1, 2), ((12, 10), 3, 1, 4),
    ((9, 8), 5, 1, 1), ((7, 7), 1, 2, 1)])
def test_same_conv_matches_flax_padding(size, kernel, stride, dilation):
    import flax.linen as fnn
    rng = np.random.RandomState(kernel * 10 + stride)
    x = rng.rand(2, *size, 3).astype(np.float32)
    flax_conv = fnn.Conv(4, (kernel, kernel), strides=stride,
                         kernel_dilation=dilation, use_bias=False)
    v = flax_conv.init(jax.random.key(0), jnp.asarray(x))
    want = flax_conv.apply(v, jnp.asarray(x))
    conv = SameConv2d(3, 4, kernel, stride, dilation)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("src, dst", [
    ((8, 8), (32, 32)), ((12, 10), (48, 40)), ((8, 7), (30, 27)),
    ((5, 5), (5, 5)), ((1, 1), (16, 16))])
def test_bilinear_upsample_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(5).randn(2, *src, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 3), "bilinear")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
        align_corners=False, antialias=False).permute(0, 2, 3, 1)
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_vgg_refuses_inputs_under_32():
    with pytest.raises(ValueError, match="32x32"):
        VGG("vgg11", 10, image_size=(28, 28))
    with pytest.raises(ValueError, match="32x32"):
        VGG("vgg11", 10)(torch.zeros(1, 16, 32, 3))
    model = create_model("vgg13", 10, input_shape=(64, 64, 3))
    assert model.fc1.in_features == 512 * 2 * 2


@pytest.mark.parametrize("variant", sorted(PARAMS))
def test_efficientnet_variants_build(variant):
    width, depth, _, rate = PARAMS[variant]
    with torch.device("meta"):
        model = create_model(variant, 100)
    assert len(model.blocks) == sum(round_repeats(r, depth)
                                    for _, _, r, _, _ in BASE_STAGES)
    assert model.fc.in_features == round_filters(1280, width)
    assert model.dropout_rate == rate
    if variant not in ("efficientnet-b0", "efficientnet-b7"):
        return
    # the smallest and the largest against flax's abstract init
    shapes = jax.eval_shape(
        lambda: jax_create_model(variant, 100).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))

    def count(col):
        return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            shapes[col]))
    assert sum(p.numel() for p in model.parameters()) == count("params")
    assert sum(b.numel() for b in model.buffers()) == count("batch_stats")


def test_factory_names_and_sizes():
    def sizes(name, classes, **kw):
        with torch.device("meta"):
            m = create_model(name, classes, **kw)
        params = sum(p.numel() for p in m.parameters())
        return params, sum(b.numel() for b in m.buffers())
    # the published sizes at full width (the aggregation's D on the card)
    assert sizes("mobilenet", 100) == (3_309_476, 21_888)
    assert sizes("mobilenet_v3", 100) == (4_328_586, 24_432)
    assert sizes("vgg11", 10) == (28_144_010, 0)
    assert sizes("vgg11", 100) == (28_512_740, 0)
    assert sizes("efficientnet-b0", 100) == (4_135_648, 42_016)
    assert sizes("segnet", 3, width=32) == (196_067, 0)
    for arch in ("vgg13", "vgg16", "vgg19"):
        with torch.device("meta"):
            assert create_model(arch, 10).fc3.out_features == 10
    # FedGKT's and FedNAS's models at the JAX factory's sizes
    for name, kw in (("resnet8_gkt", {}), ("resnet56_gkt_server", {}),
                     ("darts", {}), ("darts", dict(C=8, layers=2))):
        with torch.device("meta"):
            model = create_model(name, 10, **kw)
        flax_model = jax_create_model(name, 10, **kw)
        x = jnp.zeros((1, 32, 32, 3))
        if name == "darts":
            w = jnp.zeros((flax_model.num_edges(flax_model.steps), 8))
            args = (x, w, w)
        elif name == "resnet56_gkt_server":
            args = (jnp.zeros((1, 32, 32, 64)),)
        else:
            args = (x,)
        shapes = jax.eval_shape(lambda: flax_model.init(
            jax.random.key(0), *args, train=False))
        for col, tensors in (("params", model.parameters()),
                             ("batch_stats", model.buffers())):
            assert sum(t.numel() for t in tensors) == sum(
                int(np.prod(a.shape))
                for a in jax.tree.leaves(shapes.get(col, {}))), (name, col)


def test_mobilenet_fedavg_round_matches_jax():
    """One FedAvg round of MobileNet-0.25 from the same weights, shuffle
    off, in float64 on both sides (in f32 the round's BN and ReLU steps at
    batch 4 turn round-off into O(1) differences): params and BN
    statistics, which moved."""
    rng = np.random.RandomState(7)
    train, test = {}, {}
    for c, n in enumerate((6, 9, 4)):
        x = rng.rand(n, 32, 32, 3)
        y = rng.randint(0, 5, n).astype(np.int32)
        train[c], test[c] = (x, y), (x[:2], y[:2])
    kw = dict(epochs=1, batch_size=4, lr=0.1, shuffle=False)
    rounds = dict(comm_round=1, client_num_per_round=2,
                  frequency_of_the_test=100)
    flax_model = FlaxMobileNet(num_classes=5, width_multiplier=0.25)
    start = jax.tree.map(lambda a: a.astype(np.float64), _random_variables(
        flax_model, train[0][0][:1], rng))
    model = MobileNet(5, 0.25)
    with jax.enable_x64(True), mock.patch.object(
            FlaxMobileNet, "init", lambda *a, **k: start):
        ref = JaxFedAvgAPI(
            JaxFederatedDataset.from_client_arrays(train, test, 5),
            flax_model, config=JaxFedAvgConfig(
                train=JaxTrainConfig(**kw), **rounds))
        want_idxs, _ = ref.run_round(0)
        want = jax.tree.map(np.asarray, ref.variables)
    api = FedAvgAPI(FederatedDataset.from_client_arrays(train, test, 5),
                    model, device="cpu", config=FedAvgConfig(
                        train=TrainConfig(**kw), **rounds))
    api.variables = {k: v.double() for k, v in
                     flax_to_state_dict(start, model).items()}
    idxs, _ = api.run_round(0)
    assert list(idxs) == list(want_idxs)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        assert w.dtype == np.float64, path
    want = {k: v.double() for k, v in flax_to_state_dict(want,
                                                         model).items()}
    start = flax_to_state_dict(start, model)
    for k in want:
        _close(api.variables[k], want[k], err_msg=k)
        if "running_var" in k:
            assert not torch.equal(want[k].float(), start[k]), k
