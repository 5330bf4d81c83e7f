"""The port's analytic FLOP counter (fedml_tpu_torch/utils/flops.py)
against hand formulas and against the JAX package's jaxpr count.

The counter bills the ATen ops a function dispatches, on fake tensors; the
JAX package bills the primitives of its jaxpr (``fedml_tpu/utils/flops.py
::_eqn_flops``). Matmuls and convolutions are exact on both sides, so the
matmul/conv part of a CNN round must be EQUAL; the elementwise and
reduction part follows each package's own decomposition, so the totals
agree within 2% (measured: 2,434.9 M against 2,440.9 M on the round
below, 0.25%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.core.pytree import tree_weighted_mean as jax_tree_mean
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.models.cnn import CNN_DropOut as FlaxCNN
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu.utils import flops as jflops
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.core import sampling
from fedml_tpu_torch.core.pytree import tree_weighted_mean
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models import CNN_DropOut
from fedml_tpu_torch.ops import aggregate
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils import flops


def _jax_dot_conv_flops(jaxpr) -> float:
    """The JAX package's bill of a jaxpr restricted to ``dot_general`` and
    ``conv_general_dilated``, with its own ``_eqn_flops`` (a walk like its
    ``_jaxpr_flops``: scan bodies times their length, sub-jaxprs
    recursed)."""
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            total += float(eqn.params["length"]) * _jax_dot_conv_flops(
                eqn.params["jaxpr"].jaxpr)
        elif name in ("dot_general", "conv_general_dilated"):
            total += jflops._eqn_flops(eqn)
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if key in eqn.params:
                    inner = eqn.params[key]
                    total += _jax_dot_conv_flops(getattr(inner, "jaxpr",
                                                         inner))
                    break
    return total


@pytest.mark.parametrize("op, shapes, want", [
    ("mm", [(3, 4), (4, 5)], 2 * 3 * 4 * 5),
    ("bmm", [(2, 3, 4), (2, 4, 5)], 2 * 2 * 3 * 4 * 5),
    ("mv", [(6, 7), (7,)], 2 * 6 * 7),
    # the bias of a linear layer adds one FLOP an output element
    ("linear", [(3, 4), (5, 4), (5,)], 2 * 3 * 4 * 5 + 3 * 5)])
def test_a_matmul_is_billed_exactly(op, shapes, want):
    args = [torch.randn(s) for s in shapes]
    fn = {"mm": torch.mm, "bmm": torch.bmm, "mv": torch.mv,
          "linear": F.linear}[op]
    assert flops.analytic_flops(fn, *args) == want
    # the JAX package bills the same product the same way
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jfn = {"mm": jnp.matmul, "bmm": jnp.matmul, "mv": jnp.matmul,
           "linear": lambda x, w, b: x @ w.T + b}[op]
    assert jflops.analytic_flops(jfn, *jargs) == want


# (input NCHW, weight OIHW, groups, stride)
CONVS = {"plain": ((2, 3, 9, 9), (6, 3, 3, 3), 1, 1),
         "grouped": ((2, 4, 8, 8), (6, 2, 3, 3), 2, 1),
         "depthwise": ((2, 5, 8, 8), (5, 1, 3, 3), 5, 1),
         "strided": ((1, 3, 11, 11), (4, 3, 5, 5), 1, 2)}


def _jax_conv(x, w, groups, stride):
    return jax.lax.conv_general_dilated(
        x, w, (stride, stride), "VALID", feature_group_count=groups,
        dimension_numbers=("NCHW", "OIHW", "NCHW"))


@pytest.mark.parametrize("name", sorted(CONVS))
def test_convs_match_the_hand_formula(name):
    xs, ws, groups, stride = CONVS[name]
    x, w = torch.randn(xs), torch.randn(ws)
    out = F.conv2d(x, w, groups=groups, stride=stride)
    want = 2 * out.numel() * (xs[1] // groups) * ws[2] * ws[3]
    c = flops.count(lambda x, w: F.conv2d(x, w, groups=groups,
                                          stride=stride), x, w)
    assert c.flops == want == c.by_class[flops.MATMUL_CONV]
    assert jflops.analytic_flops(
        lambda x, w: _jax_conv(x, w, groups, stride),
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy())) == want


@pytest.mark.parametrize("name", sorted(CONVS))
def test_backward_convs_are_billed_as_the_jax_transpose(name):
    """The weight gradient at the forward's count, the input gradient at
    the INPUT's size times C_out/groups; both packages agree."""
    xs, ws, groups, stride = CONVS[name]
    x = torch.randn(xs, requires_grad=True)
    w = torch.randn(ws, requires_grad=True)

    def grads(x, w):
        y = F.conv2d(x, w, groups=groups, stride=stride)
        return torch.autograd.grad((y * y).sum(), (x, w))

    c = flops.count(grads, x, w)
    out = F.conv2d(x, w, groups=groups, stride=stride)
    k = ws[2] * ws[3]
    fwd = 2 * out.numel() * (xs[1] // groups) * k
    grad_in = 2 * x.numel() * (ws[0] // groups) * k
    assert c.by_op["convolution"] == fwd
    assert c.by_op["convolution_backward"] == fwd + grad_in

    def jgrads(x, w):
        return jax.grad(lambda x, w: jnp.sum(_jax_conv(x, w, groups,
                                                       stride) ** 2),
                        argnums=(0, 1))(x, w)
    closed = jax.make_jaxpr(jgrads)(jnp.asarray(x.detach().numpy()),
                                    jnp.asarray(w.detach().numpy()))
    assert _jax_dot_conv_flops(closed.jaxpr) == c.by_class[
        flops.MATMUL_CONV] == 2 * fwd + grad_in


def test_a_loops_steps_multiply():
    a, b = torch.randn(8, 8), torch.randn(8, 8)

    def steps(a, b, n):
        for _ in range(n):
            a = torch.tanh(a @ b)
        return a

    one = flops.analytic_flops(steps, a, b, 1)
    assert one == 2 * 8 ** 3 + 8 * 8
    assert flops.analytic_flops(steps, a, b, 5) == 5 * one


def _clients(sizes, seed=0):
    rng = np.random.RandomState(seed)
    train, test = {}, {}
    for c, n in enumerate(sizes):
        x = rng.rand(n, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 62, n).astype(np.int32)
        train[c], test[c] = (x, y), (x[:3], y[:3])
    return train, test


ROUND = dict(comm_round=1, client_num_per_round=2, frequency_of_the_test=100)
TRAIN = dict(epochs=1, batch_size=8, lr=0.1)


def _port_api(sizes, **kw):
    train, test = _clients(sizes)
    return FedAvgAPI(FederatedDataset.from_client_arrays(train, test, 62),
                     CNN_DropOut(only_digits=False), device="cpu",
                     config=FedAvgConfig(**{"train": TrainConfig(**TRAIN),
                                            **ROUND, **kw}))


def _host_round_count(api, round_idx=0):
    idxs, (x, y, mask, w, plan, agg) = api._prepare_round(round_idx)
    return flops.count(api._round_fn, api.variables, x, y, mask, w, plan,
                       agg, None)


def test_cnn_round_matches_jax_analytic_flops():
    """The FEMNIST CNN with its dropout, 2 clients x 16 rows, batch 8: no
    padding-only step, so both packages' rounds do the same work. The
    matmul/conv part is equal to the JAX package's dot_general and
    conv_general_dilated bill (input-gradient convs at the input's size
    included); the totals agree within 2%."""
    train, test = _clients([16, 16])
    ref = JaxFedAvgAPI(JaxFederatedDataset.from_client_arrays(train, test,
                                                              62),
                       FlaxCNN(only_digits=False),
                       config=JaxFedAvgConfig(train=JaxTrainConfig(**TRAIN),
                                              **ROUND))
    _, (x, y, mask, keys, weights, agg_key) = ref._host_round_inputs(0)
    args = (ref.variables, x, y, mask, keys, weights, agg_key,
            jnp.uint32(0))
    closed = jax.make_jaxpr(ref._round_fn_py)(*args)
    jax_dot_conv = _jax_dot_conv_flops(closed.jaxpr)
    jax_total = jflops.analytic_flops(ref._round_fn_py, *args)

    c = _host_round_count(_port_api([16, 16]))
    assert c.by_class[flops.MATMUL_CONV] == jax_dot_conv
    # the hand count: 32 sample-steps of 75,291,648 FLOPs (forward, weight
    # gradients, and the input gradients of conv2, fc1 and fc2)
    assert jax_dot_conv == 32 * 75_291_648
    assert abs(c.flops - jax_total) <= 0.02 * jax_total
    # the rest is the elementwise and reduction share, ~1% on both sides
    assert 0 < c.flops - c.by_class[flops.MATMUL_CONV] < 0.02 * c.flops


def test_counting_launches_nothing_and_writes_nothing(monkeypatch):
    """The probe runs the round on fake tensors: the variables, the
    global torch generator and the dropout counters' cache are as they
    were, and the round then runs as it would have."""
    monkeypatch.setattr(sampling, "_WEYL", {})
    api = _port_api([16, 16])
    before = {k: v.clone() for k, v in api.variables.items()}
    state = torch.get_rng_state()
    _host_round_count(api)
    assert torch.equal(torch.get_rng_state(), state)
    assert all(torch.equal(api.variables[k], before[k]) for k in before)
    assert sampling._WEYL == {}
    api.run_round(0)
    clean = _port_api([16, 16])
    clean.run_round(0)
    assert all(torch.equal(api.variables[k], clean.variables[k])
               for k in before)


@pytest.mark.parametrize("sizes, kw, idle", [
    ([8, 16, 24, 40], {}, False), ([16, 40], {}, True),
    ([16, 32], dict(accum_steps=2), False)])
def test_host_round_count_is_the_round_as_it_runs(sizes, kw, idle):
    """The perf record's count (``_round_flops``: a round shape's parts
    and each client's real steps) equals a full count of the same round,
    for clients of 1 to 5 real steps, one with none (``idle``), and under
    gradient accumulation; a second round of the same shapes bills from
    the parts alone."""
    api = _port_api(sizes, client_num_per_round=len(sizes), pack="global",
                    train=TrainConfig(**{**TRAIN, **kw}))
    _, (x, y, mask, w, plan, agg) = api._prepare_round(0)
    if idle:
        plan = plan._replace(has_real=plan.has_real & (
            np.arange(len(sizes)) != 0)[:, None])
    want = flops.analytic_flops(api._round_fn, api.variables, x, y, mask,
                                w, plan, agg, None)
    got = api._round_flops(api.variables, x, y, mask, w, plan, agg, None)
    assert got == want > 0
    one = plan._replace(has_real=plan.has_real & (
        np.arange(plan.has_real.shape[1]) == 0))
    assert api._round_flops(api.variables, x, y, mask, w, one, agg,
                            None) == flops.analytic_flops(
        api._round_fn, api.variables, x, y, mask, w, one, agg, None) < want
    assert len(api._flops_parts) == 1


@pytest.mark.parametrize("sizes, padded", [([16, 16], False),
                                           ([4, 16], True)])
def test_fused_block_counts_at_least_the_host_round(sizes, padded):
    """The fused block bills every gated step; the host round skips the
    padding-only ones. Without them the matmul/conv FLOPs are equal (the
    totals differ by the gates' selects); with them the block bills
    more."""
    api = _port_api(sizes, pack="global")
    host = _host_round_count(api)
    fused = api.fused_rounds().cost_analysis(0, 1)
    mm = fused["flops_by_class"][flops.MATMUL_CONV]
    assert fused["flops"] >= host.flops
    if padded:
        assert mm > host.by_class[flops.MATMUL_CONV]
    else:
        assert mm == host.by_class[flops.MATMUL_CONV]
    # a block replays one round's capture: its count is the round's times
    # the rounds (pack="global": both blocks pad alike)
    two = api.fused_rounds().cost_analysis(0, 2)
    assert two["flops"] == 2 * fused["flops"]
    loop = flops.count(lambda block: api.fused_rounds()._run_loop(block, 2),
                       api.fused_rounds()._block_inputs(0, 2))
    assert loop.flops == two["flops"]


@pytest.mark.parametrize("c, shapes", [
    (3, [(5, 4), (4,)]), (10, [(32, 1, 3, 3), (32,), (62, 128)])])
def test_aggregation_front_end_formula_equals_its_plain_count(c, shapes):
    gen = torch.Generator().manual_seed(c)
    stacked = {f"l{i}": torch.randn((c,) + s, generator=gen)
               for i, s in enumerate(shapes)}
    weights = torch.rand(c, generator=gen) + 0.5
    d = sum(int(np.prod(s)) for s in shapes)
    plain = flops.count(tree_weighted_mean, stacked, weights)
    assert plain.flops == aggregate.tree_weighted_mean_flops(c, d)
    # the front end bills its formula under the counter, launching
    # nothing, and gives the plain version's shapes
    front = flops.count(aggregate.tree_weighted_mean_fused, stacked,
                        weights)
    assert front.flops == plain.flops
    assert dict(front.by_class) == {flops.KERNEL: plain.flops}
    # the JAX package's per-leaf mean bills the same
    jstacked = {k: jnp.asarray(v.numpy()) for k, v in stacked.items()}
    assert jflops.analytic_flops(jax_tree_mean, jstacked, jnp.asarray(
        weights.numpy())) == plain.flops
    # the flat kernel's own front end, against its plain version
    flat = torch.randn(c, d, generator=gen)
    assert flops.analytic_flops(aggregate.weighted_mean_flat_reference,
                                flat, weights) == \
        aggregate.weighted_mean_flat_flops(c, d) == \
        flops.analytic_flops(aggregate.weighted_mean_flat, flat, weights)


def test_params_and_model_complexity_match_jax():
    model = CNN_DropOut(only_digits=False)
    fmodel = FlaxCNN(only_digits=False)
    variables = fmodel.init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))
    assert flops.count_params(model) == jflops.count_params(variables) \
        == 1_206_590
    assert flops.param_bytes(model.state_dict()) == 4 * 1_206_590
    rep = flops.model_complexity(model, (1, 28, 28, 1))
    # one sample's forward: the four layers' products
    assert rep["params"] == 1_206_590
    assert flops.count(lambda x: model(x), torch.zeros(1, 28, 28, 1)
                       ).by_class[flops.MATMUL_CONV] == 23_998_208
    assert rep["flops"] > 23_998_208 and rep["bytes_accessed"] > 0
