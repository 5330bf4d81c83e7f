"""The port's DARTS models against the flax ones: ``DartsNetwork``'s eval
forward under the soft mixture and under GDAS's one-hot weights,
``GenotypeNetwork``'s with and without its auxiliary head (and the head's
train-mode logits), every stride-2 primitive's flax ``"SAME"`` padding on
even and odd sizes, the max pool's -inf padding, GDAS's straight-through
sample from the same uniforms, ``init_alphas``, ``gdas_tau`` and
``parse_genotype`` exactly, and the genotype's DOT text exactly. Also the
affine-free BatchNorm of the search cells against flax's (no parameters,
the same train step), and the default BatchNorm's keys and bits unchanged.

Weights are drawn with numpy from the flax model's abstract init and
carried with ``utils/convert.py``. Tolerances: f32 forwards rtol 1e-4,
atol 1e-5; the auxiliary head's train-mode logits (BatchNorm at batch 2)
in float64 on both sides at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.models import darts as fdarts
from fedml_tpu.models import darts_visualize as fvis
from fedml_tpu.models.darts_eval import GenotypeNetwork as FlaxGenotypeNet
from fedml_tpu_torch.models import darts, darts_visualize
from fedml_tpu_torch.models.common import BatchNorm, collect_batch_stats
from fedml_tpu_torch.models.darts import DartsNetwork
from fedml_tpu_torch.models.darts_eval import GenotypeNetwork
from fedml_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(C=4, num_classes=3, layers=3, steps=2, multiplier=2,
            stem_multiplier=1)


def _random_variables(shapes, rng, dtype=np.float32):
    """Variables drawn with numpy over a flax abstract init: kernels of
    variance 1/fan_in, norm scales and variances near 1, the rest near
    0."""
    def draw(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            w = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf in ("scale", "var"):
            w = 1.0 + 0.3 * (rng.rand(*a.shape) - 0.5)
        else:
            w = 0.1 * rng.randn(*a.shape)
        return w.astype(dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(
        got) else got), np.asarray(want), **(tol or TOL))


def _genotype(rng, steps=2):
    k = DartsNetwork.num_edges(steps)
    an, ar = (rng.randn(k, len(darts.PRIMITIVES)) for _ in range(2))
    return darts.parse_genotype(an, ar, steps=steps, multiplier=steps)


@pytest.mark.parametrize("weights", ["soft", "onehot"])
def test_darts_network_eval_forward(weights):
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    an, ar = darts.init_alphas(2, rng)
    if weights == "soft":
        w, wr = (np.asarray(jax.nn.softmax(a * 500.0, -1)) for a in (an, ar))
    else:
        w, wr = (np.eye(len(darts.PRIMITIVES), dtype=np.float32)[
            rng.randint(0, len(darts.PRIMITIVES), len(a))] for a in (an, ar))
    flax_model = fdarts.DartsNetwork(**TINY)
    v = _random_variables(jax.eval_shape(lambda: flax_model.init(
        jax.random.key(0), jnp.asarray(x), w, wr, train=False)), rng)
    model = DartsNetwork(**TINY)
    model.load_state_dict(flax_to_state_dict(v, model))
    want = flax_model.apply(v, jnp.asarray(x), w, wr, train=False)
    got = model(torch.tensor(x), torch.tensor(w), torch.tensor(wr))
    _close(got, want)
    # the search cells' norms hold running statistics alone
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert sum(b.numel() for b in model.buffers()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(v["batch_stats"]))
    assert n_bn > 2


@pytest.mark.parametrize("auxiliary", [False, True])
def test_genotype_network_forward(auxiliary):
    rng = np.random.RandomState(1)
    g = _genotype(rng)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    kw = dict(C=4, num_classes=3, layers=3, stem_multiplier=1,
              auxiliary=auxiliary)
    flax_model = FlaxGenotypeNet(genotype=g, **kw)
    v = _random_variables(jax.eval_shape(lambda: flax_model.init(
        jax.random.key(0), jnp.asarray(x), train=False)), rng)
    model = GenotypeNetwork(g, **kw)
    model.load_state_dict(flax_to_state_dict(v, model))
    _close(model(torch.tensor(x)),
           flax_model.apply(v, jnp.asarray(x), train=False))
    if not auxiliary:
        return
    # the head's train-mode logits (BatchNorm on the batch: float64)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        (want, want_aux), _ = flax_model.apply(
            v64, jnp.asarray(x, jnp.float64), train=True,
            mutable=["batch_stats"])
    model = model.double()
    model.load_state_dict(flax_to_state_dict(v, model))
    with collect_batch_stats():
        got, got_aux = model(torch.tensor(x, dtype=torch.float64),
                             train=True)
    _close(got, want)
    _close(got_aux, want_aux)


def _stride2_cases():
    """(primitive, size): every stride-2 primitive at an even and an odd
    size, but the factorized reduce, which needs an even one in both
    packages."""
    prims = ["max_pool_3x3", "avg_pool_3x3", "skip_connect", "sep_conv_3x3",
             "sep_conv_5x5", "dil_conv_3x3", "dil_conv_5x5"]
    return [(p, s) for p in prims for s in (8, 7)
            if not (p == "skip_connect" and s % 2)]


def _flax_and_port_op(prim):
    k = 3 if prim.endswith("3x3") else 5
    if prim.startswith("sep"):
        return fdarts.SepConv(4, k, 2), darts.SepConv(4, 4, k, 2)
    if prim.startswith("dil"):
        return fdarts.DilConv(4, k, 2), darts.DilConv(4, 4, k, 2)
    return fdarts.FactorizedReduce(4), darts.FactorizedReduce(4, 4)


@pytest.mark.parametrize("prim, size", _stride2_cases())
def test_stride2_primitive_pads_as_flax_same(prim, size):
    """Each stride-2 primitive of a reduction edge against flax's: flax's
    "SAME" padding is asymmetric at stride 2 on an even size."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    if prim.endswith("pool_3x3"):
        want = fdarts._pool(jnp.asarray(x), prim[:3], 2)
        got = darts.pool(xt, prim[:3], 2)
    else:
        flax_op, op = _flax_and_port_op(prim)
        v = _random_variables(jax.eval_shape(lambda: flax_op.init(
            jax.random.key(0), jnp.asarray(x), train=False)), rng)
        op.load_state_dict(flax_to_state_dict(v, op))
        want = flax_op.apply(v, jnp.asarray(x), train=False)
        got = op(xt, False)
    assert tuple(got.shape[2:]) == (-(-size // 2),) * 2
    _close(got.permute(0, 2, 3, 1), want)


def test_reduction_mixed_op_matches_flax():
    """A stride-2 MixedOp, every primitive at once under random weights
    (its zero "none" op at C channels and half the size)."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = rng.rand(len(darts.PRIMITIVES)).astype(np.float32)
    flax_op = fdarts.MixedOp(C=4, stride=2)
    v = _random_variables(jax.eval_shape(lambda: flax_op.init(
        jax.random.key(0), jnp.asarray(x), w, train=False)), rng)
    op = darts.MixedOp(4, 2)
    op.load_state_dict(flax_to_state_dict(v, op))
    got = op(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w), False)
    _close(got.permute(0, 2, 3, 1),
           flax_op.apply(v, jnp.asarray(x), w, train=False))


@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_pads_with_minus_inf(stride):
    """On an all-negative map a zero pad would win every border window:
    the pool pads with -inf, as flax's does."""
    rng = np.random.RandomState(3)
    x = -1.0 - rng.rand(1, 6, 6, 2).astype(np.float32)
    want = fdarts._pool(jnp.asarray(x), "max", stride)
    got = darts.pool(torch.tensor(x).permute(0, 3, 1, 2), "max", stride)
    assert float(got.max()) < -1.0
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    avg = darts.pool(torch.tensor(x).permute(0, 3, 1, 2), "avg", stride)
    _close(avg.permute(0, 2, 3, 1), fdarts._pool(jnp.asarray(x), "avg",
                                                 stride))


@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_sample_from_the_same_uniforms(hard):
    """GDAS's sample from uniforms JAX drew: the forward (the one-hot, or
    the soft sample) and the straight-through gradient, the soft
    sample's."""
    alphas = np.random.RandomState(4).randn(5, len(darts.PRIMITIVES)) \
        .astype(np.float32)
    key = jax.random.key(7)
    u = np.asarray(jax.random.uniform(key, alphas.shape, minval=1e-20,
                                      maxval=1.0))
    probe = np.random.RandomState(5).randn(*alphas.shape).astype(np.float32)

    def jax_loss(a):
        return jnp.sum(fdarts.gumbel_softmax_weights(key, a, 0.7, hard)
                       * probe)
    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(alphas))
    a = torch.tensor(alphas, requires_grad=True)
    got = (darts.gumbel_softmax_weights(a, torch.tensor(u), 0.7, hard)
           * torch.tensor(probe)).sum()
    (got_grad,) = torch.autograd.grad(got, a)
    _close(got, want)
    _close(got_grad, want_grad)


def test_alphas_tau_and_genotype_exact():
    for seed in range(3):
        want = fdarts.init_alphas(4, np.random.RandomState(seed))
        got = darts.init_alphas(4, np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for epoch in range(6):
        assert darts.gdas_tau(epoch, 5) == fdarts.gdas_tau(epoch, 5)
    assert darts.gdas_tau(0, 1) == fdarts.gdas_tau(0, 1)
    rng = np.random.RandomState(6)
    for steps, mult in ((4, 4), (2, 2), (3, 2)):
        k = DartsNetwork.num_edges(steps)
        an, ar = (rng.randn(k, len(darts.PRIMITIVES)) for _ in range(2))
        assert darts.parse_genotype(an, ar, steps, mult) == \
            fdarts.parse_genotype(an, ar, steps, mult)
    assert darts.PRIMITIVES == fdarts.PRIMITIVES


def test_dot_text_exact(tmp_path):
    g = _genotype(np.random.RandomState(8), steps=4)
    for gene, name in ((g.normal, "normal"), (g.reduce, "reduction")):
        assert darts_visualize.genotype_to_dot(gene, name) == \
            fvis.genotype_to_dot(gene, name)
    assert darts_visualize.format_genotype(g) == fvis.format_genotype(g)
    got = darts_visualize.plot(g, str(tmp_path / "port"), "r0_")
    want = fvis.plot(g, str(tmp_path / "jax"), "r0_")
    assert [p.rsplit("/", 1)[1] for p in got] == \
        [p.rsplit("/", 1)[1] for p in want]
    for a, b in zip(got, want):
        assert open(a).read() == open(b).read()
    with pytest.raises(ValueError, match="odd"):
        darts_visualize.genotype_to_dot(g.normal[:3])


def test_affine_free_batchnorm_matches_flax():
    """``BatchNorm(affine=False)``: no parameters, the running statistics
    alone in the state dict, and flax's ``use_scale=False,
    use_bias=False`` train step and eval forward."""
    import flax.linen as nn
    bn = BatchNorm(3, affine=False)
    assert list(bn.parameters()) == []
    assert list(bn.state_dict()) == ["running_mean", "running_var"]
    rng = np.random.RandomState(9)
    x = rng.randn(4, 5, 5, 3).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, use_scale=False,
                           use_bias=False, momentum=0.9, epsilon=1e-5)
    v = flax_bn.init(jax.random.key(0), jnp.asarray(x))
    assert "params" not in v
    want, upd = flax_bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    with collect_batch_stats() as sink:
        got = bn(xt, train=True)
    _close(got.permute(0, 2, 3, 1), want)
    mean, var = sink[bn]
    _close(mean, upd["batch_stats"]["mean"])
    _close(var, upd["batch_stats"]["var"])
    bn.load_state_dict({"running_mean": mean, "running_var": var})
    eval_want = nn.BatchNorm(use_running_average=True, use_scale=False,
                             use_bias=False).apply(upd, jnp.asarray(x))
    _close(bn(xt).permute(0, 2, 3, 1), eval_want)


def test_default_batchnorm_keeps_its_keys_and_bits():
    """A default ``BatchNorm`` is what it was before the affine switch: the
    same state-dict keys and the same bits as the formula it computed."""
    bn = BatchNorm(6)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean",
                                     "running_var"]
    gen = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for t in bn.state_dict().values():
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    x = torch.randn(3, 6, 4, 4, generator=gen)
    shape = (1, -1, 1, 1)

    def formula(mean, var):
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean.view(shape)) * mul.view(shape) + \
            bn.bias.view(shape)
    assert torch.equal(bn(x), formula(bn.running_mean, bn.running_var))
    with collect_batch_stats() as sink:
        y = bn(x, train=True)
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    assert torch.equal(y, formula(mean, var))
    assert torch.equal(sink[bn][0], 0.9 * bn.running_mean + 0.1 * mean)
    assert torch.equal(sink[bn][1], 0.9 * bn.running_var + 0.1 * var)
