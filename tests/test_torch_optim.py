"""The port's client optimizers against optax, as the JAX package builds
them (``fedml_tpu.trainer.functional.make_optimizer``): amsgrad after
``add_decayed_weights``, and ``MultiSteps`` gradient accumulation with the
JAX package's gating of padding-only steps.

Tolerances: the optimizers alone rtol 1e-6 (one f32 op order; XLA's
``pow`` and torch's round ``b**count`` an ulp apart now and then); the
three-round LR federations atol 1e-5, the existing LR parity tolerance
(f32 reduction order of the forward and backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu.trainer.functional import make_optimizer as jax_optimizer
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import (TrainConfig, accum_flags,
                                                make_local_train,
                                                make_optimizer, tree_where)
from fedml_tpu_torch.utils.convert import flax_to_state_dict

SHAPES = [(5, 3), (7,), (2, 4, 3)]


def _grads(steps, seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES]
            for _ in range(steps)]


def _run_both(cfg_kw, grads, has_real):
    """Apply the same gradients through optax (JAX's optimizer, gated as
    JAX's local_train gates) and the port's optimizer (gated as its step
    gates); returns both parameter lists."""
    rng = np.random.RandomState(1)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = jax_optimizer(JaxTrainConfig(**cfg_kw))
    jp = [jnp.asarray(a) for a in init]
    js = tx.init(jp)

    @jax.jit
    def jax_step(p, s, g, real):
        u, ns = tx.update(g, s, p)
        np_ = jax.tree.map(lambda a, b: a + b, p, u)
        sel = lambda new, old: jax.tree.map(  # noqa: E731
            lambda a, b: jnp.where(real, a, b), new, old)
        return sel(np_, p), sel(ns, s)

    opt = make_optimizer(TrainConfig(**cfg_kw))
    tp = [torch.from_numpy(a.copy()) for a in init]
    ts = opt.init(tp)
    emit, acc_div = accum_flags(has_real, cfg_kw.get("accum_steps", 1))
    for g, real, e, d in zip(grads, has_real, emit, acc_div):
        jp, js = jax_step(jp, js, [jnp.asarray(a) for a in g], bool(real))
        gate = torch.tensor(bool(real))
        u, ns = opt.update([torch.from_numpy(a) for a in g], ts, tp,
                           torch.tensor(bool(e)), torch.tensor(d))
        tp = tree_where(gate, torch._foreach_add(tp, u), tp)
        ts = tree_where(gate, ns, ts)
    return [np.asarray(a) for a in jp], [t.numpy() for t in tp]


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_amsgrad_matches_optax(wd):
    grads = _grads(25)
    want, got = _run_both(dict(client_optimizer="adam", lr=0.01, wd=wd),
                          grads, np.ones(25, bool))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_amsgrad_takes_the_max_after_bias_correction():
    """Two steps whose bias-corrected second moment falls: optax keeps the
    larger corrected value, torch.optim.Adam(amsgrad=True) the larger raw
    one, and the port follows optax."""
    grads = [[np.full(s, v, np.float32) for s in SHAPES] for v in (1.0, 0.1)]
    want, got = _run_both(dict(client_optimizer="adam", lr=0.1), grads,
                          np.ones(2, bool))
    p = torch.nn.Parameter(torch.zeros(3))
    adam = torch.optim.Adam([p], lr=0.1, amsgrad=True)
    for v in (1.0, 0.1):
        p.grad = torch.full((3,), v)
        adam.step()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    start = np.random.RandomState(1).randn(*SHAPES[0]).astype(np.float32)
    port_delta = float(got[0][0, 0] - start[0, 0])
    assert abs(float(p.detach()[0]) - port_delta) > 1e-4


# real steps with padding-only steps in the middle and at the end
HAS_REAL = np.array([1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 1, 0], bool)


@pytest.mark.parametrize("opt", [
    dict(client_optimizer="sgd", lr=0.1),
    dict(client_optimizer="sgd", lr=0.1, momentum=0.9),
    dict(client_optimizer="adam", lr=0.01, wd=1e-4)])
@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(opt, k):
    grads = _grads(len(HAS_REAL), seed=2)
    want, got = _run_both(dict(opt, accum_steps=k), grads, HAS_REAL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_accum_flags_advance_only_on_real_steps():
    emit, acc_div = accum_flags(HAS_REAL, 3)
    assert np.flatnonzero(emit).tolist() == [3, 8, 12]
    assert acc_div.tolist() == [1, 2, 1, 3, 1, 1, 1, 2, 3, 1, 1, 2, 3, 1]
    emit1, div1 = accum_flags(HAS_REAL, 1)
    assert emit1.tolist() == HAS_REAL.tolist() and set(div1) == {1.0}


def _hook(variables, stacked, weights, key):
    from fedml_tpu.ops import tree_weighted_mean_pallas
    return tree_weighted_mean_pallas(stacked, weights, interpret=True)


@pytest.mark.parametrize("train_kw", [
    dict(client_optimizer="adam", lr=0.05, wd=1e-4),
    dict(accum_steps=2, lr=0.1, momentum=0.9)])
def test_lr_three_round_parity_with_jax_fedavg(train_kw):
    """Three LR FedAvg rounds against JAX's FedAvgAPI; cohort packing pads
    3-of-6 cohorts to a power-of-2 batch count, so padding-only batches
    run (and are gated) on both sides."""
    kw = dict(epochs=2, batch_size=16, shuffle=False, **train_kw)
    rounds = dict(comm_round=3, client_num_per_round=3,
                  frequency_of_the_test=100)
    jds = jax_blob(client_num=6, seed=1)
    ref = JaxFedAvgAPI(jds, FlaxLR(num_classes=jds.class_num),
                       config=JaxFedAvgConfig(train=JaxTrainConfig(**kw),
                                              **rounds),
                       aggregate_hook=_hook)
    ds = make_blob_federated(client_num=6, seed=1)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    api = FedAvgAPI(ds, model, config=FedAvgConfig(train=TrainConfig(**kw),
                                                   **rounds), device="cpu")
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    padded = False
    for r in range(3):
        ref.run_round(r)
        idxs, _ = api.run_round(r)
        n_pad = ds.cohort_padded_len(idxs, 16)
        padded |= any(-(-ds.train_data_local_num_dict[int(c)] // 16)
                      < n_pad // 16 for c in idxs)
        want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables),
                                  model)
        for k in want:
            np.testing.assert_allclose(api.variables[k].numpy(),
                                       want[k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=k)
    assert padded  # the rounds did run padding-only batches


def test_accum_2_matches_double_batch():
    """accum_steps=2 at batch B == one step at batch 2B (mean of means ==
    mean over the union for equal micro-batches, shuffle off); the JAX
    package's tests/test_fedavg.py pins the same."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 12).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, 64).astype(np.int32))
    model = create_model("lr", 4, input_shape=(12,))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run(bsz, accum):
        lt = make_local_train(model, "classification", TrainConfig(
            epochs=2, batch_size=bsz, lr=0.1, shuffle=False,
            accum_steps=accum))
        return lt(init, x, y, torch.ones(64), seed=1)[0]

    small, big = run(16, 2), run(32, 1)
    for k in big:
        np.testing.assert_allclose(small[k].numpy(), big[k].numpy(),
                                   rtol=1e-5, atol=1e-6)
