"""The port's FedNova against the JAX package's: rounds under momentum,
nesterov, dampening, weight decay, the proximal term and server momentum
(params and the server momentum buffer, carried across by the converter),
the normalizer's recurrence, and the identities the JAX tests pin.

Parity runs with shuffle off and no dropout (the seed chains differ).
Tolerance: atol 1e-5, the existing LR parity tolerance (f32 reduction
order of the forward, the backward and the server's weighted sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fednova import FedNovaAPI as JaxFedNovaAPI
from fedml_tpu.algorithms.fednova import FedNovaConfig as JaxFedNovaConfig
from fedml_tpu.algorithms.fednova import \
    make_fednova_local_train as jax_local_train
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.fednova import (FedNovaAPI, FedNovaConfig,
                                                make_fednova_local_train)
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule)
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = {
    "plain": dict(train={}, nova={}),
    "momentum-prox-gmf": dict(train=dict(momentum=0.9),
                              nova=dict(mu=0.01, gmf=0.9)),
    "nesterov-dampening-wd": dict(train=dict(momentum=0.8, wd=1e-3),
                                  nova=dict(nesterov=True, dampening=0.1)),
    "prox-only": dict(train={}, nova=dict(mu=0.05)),
}


def _convert(tree, model):
    return flax_to_state_dict({"params": jax.tree.map(np.asarray, tree)},
                              model)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_match_jax_fednova(case):
    train = dict(epochs=2, batch_size=16, lr=0.05, shuffle=False,
                 **CASES[case]["train"])
    rounds = dict(comm_round=3, client_num_per_round=4,
                  frequency_of_the_test=100, **CASES[case]["nova"])
    jds = jax_blob(client_num=6, seed=2)
    ref = JaxFedNovaAPI(jds, FlaxLR(num_classes=jds.class_num),
                        config=JaxFedNovaConfig(
                            train=JaxTrainConfig(**train), **rounds))
    ds = make_blob_federated(client_num=6, seed=2)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    api = FedNovaAPI(ds, model, device="cpu", config=FedNovaConfig(
        train=TrainConfig(**train), **rounds))
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    for r in range(3):
        want_idxs, want_stats = ref.run_round(r)
        idxs, stats = api.run_round(r)
        assert list(idxs) == list(want_idxs)
        want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables),
                                  model)
        for k in want:
            np.testing.assert_allclose(api.variables[k].numpy(),
                                       want[k].numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"{k} round {r}")
        for k in want_stats:
            # the loss is a sum of ~2,500 near-zero cross entropies once
            # the blobs are fit, each with ~1e-7 of absolute round-off
            # (the log-softmax of a probability near 1): rtol 1e-5, with
            # 1e-3 of absolute room; the counts are exact
            np.testing.assert_allclose(float(stats[k]),
                                       float(want_stats[k]), rtol=1e-5,
                                       atol=1e-3 if k == "loss_sum" else 0)
    want_buf = _convert(ref.momentum_buf, model)
    for k in want_buf:
        np.testing.assert_allclose(api.momentum_buf[k].numpy(),
                                   want_buf[k].numpy(), atol=1e-5, rtol=0)
    got, want = api.evaluate(2), {"round": 2}
    xt, yt = jds.test_data_global
    from fedml_tpu.algorithms.fedavg import _normalized
    want.update(_normalized(ref._eval_fn(
        ref.variables, jnp.asarray(xt), jnp.asarray(yt),
        jnp.ones(len(xt), jnp.float32)), "test"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("momentum, mu", [(0.9, 0.0), (0.0, 0.1),
                                          (0.5, 0.1), (0.0, 0.0)])
def test_normalizer_matches_jax_and_the_recurrence(momentum, mu):
    """a_i over a client of 3 real batches padded to 5: padding-only steps
    count for nothing."""
    ds = make_blob_federated(client_num=2, partition_method="homo",
                             n_samples=96, seed=0)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    tc = dict(epochs=1, batch_size=16, lr=0.1, momentum=momentum,
              shuffle=False)
    local = make_fednova_local_train(model, "classification", FedNovaConfig(
        train=TrainConfig(**tc), mu=mu))
    x, y, mask = ds.pack_clients([0], 16, n_pad=80)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    sched = make_batch_schedule(80, 1, 16, False, 0, mask[0])
    _, a_i, steps, _, _ = local(params, {}, torch.from_numpy(x[0]),
                                torch.from_numpy(y[0]),
                                torch.from_numpy(mask[0]), sched)
    assert steps == 3
    jl = jax_local_train(FlaxLR(num_classes=ds.class_num), "classification",
                         JaxFedNovaConfig(train=JaxTrainConfig(**tc), mu=mu))
    flax = FlaxLR(num_classes=ds.class_num).init(
        jax.random.key(0), jnp.asarray(x[0, :1]))
    _, want, want_steps, _, _ = jl(flax, jnp.asarray(x[0]), jnp.asarray(y[0]),
                                   jnp.asarray(mask[0]), jax.random.key(1))
    assert int(want_steps) == 3
    assert a_i.dtype == np.float32 and a_i == np.float32(want)
    if not mu:
        counter, expect = 0.0, 0.0
        for _ in range(3):
            counter = counter * momentum + 1
            expect += counter if momentum else 1
        assert a_i == pytest.approx(expect, rel=1e-6)


def test_plain_sgd_equal_steps_equals_fedavg():
    ds = make_blob_federated(client_num=4, partition_method="homo",
                             n_samples=4 * 64, seed=0)
    tc = TrainConfig(epochs=2, batch_size=16, lr=0.05, shuffle=False)
    shared = dict(comm_round=3, client_num_per_round=4,
                  frequency_of_the_test=100)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    nova = FedNovaAPI(ds, model, device="cpu",
                      config=FedNovaConfig(train=tc, **shared))
    avg = FedAvgAPI(ds, model, device="cpu",
                    config=FedAvgConfig(train=tc, **shared))
    for r in range(3):
        nova.run_round(r)
        avg.run_round(r)
    for k in avg.variables:
        np.testing.assert_allclose(nova.variables[k].numpy(),
                                   avg.variables[k].numpy(), atol=1e-5)


def test_heterogeneous_steps_learns():
    ds = make_blob_federated(client_num=8, partition_method="hetero", seed=2)
    nova = FedNovaAPI(ds, create_model("lr", ds.class_num, input_shape=(20,)),
                      device="cpu", config=FedNovaConfig(
                          comm_round=15, client_num_per_round=8,
                          frequency_of_the_test=14, gmf=0.9, mu=0.001,
                          train=TrainConfig(epochs=2, batch_size=16,
                                            lr=0.05, momentum=0.9)))
    final = nova.train()
    assert final["test_acc"] > 0.85, final
    assert [r["round"] for r in nova.history] == [0, 14]


def test_lr_decay_round_refused():
    ds = make_blob_federated(client_num=4, seed=0)
    with pytest.raises(NotImplementedError, match="lr_decay_round"):
        FedNovaAPI(ds, create_model("lr", ds.class_num, input_shape=(20,)),
                   device="cpu", config=FedNovaConfig(
                       train=TrainConfig(lr_decay_round=0.9)))
