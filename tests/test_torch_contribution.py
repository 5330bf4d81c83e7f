"""The port's contribution measurement against the JAX package's: the
copied kernel SHAP gives JAX's values on the same model, and leave-one-out
influence from the same initial weights (carried across by the converter)
agrees with JAX's at atol 1e-5 (the LR rounds' parity tolerance, through
a softmax); the unique client ranks first.
"""

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxFedAvgConfig
from fedml_tpu.contribution import LeaveOneOutMeasure as JaxLOO
from fedml_tpu.contribution import shap as jax_shap
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.contribution import (LeaveOneOutMeasure, kernel_shap,
                                          kernel_shap_federated,
                                          kernel_shap_federated_with_step,
                                          loo, shapley_kernel_weight)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _f(V):
    return np.sin(V).sum(axis=1) + (V ** 2).sum(axis=1) + V[:, 0] * V[:, 2]


@pytest.mark.parametrize("fn, extra", [
    ("kernel_shap", ()), ("kernel_shap_federated", (3,)),
    ("kernel_shap_federated_with_step", (2, 2))])
def test_shap_copy_matches_jax(fn, extra):
    rng = np.random.RandomState(1)
    M = 6
    x, r = rng.randn(M), rng.randn(M)
    port = {"kernel_shap": kernel_shap,
            "kernel_shap_federated": kernel_shap_federated,
            "kernel_shap_federated_with_step":
                kernel_shap_federated_with_step}[fn]
    got = port(_f, x, r, M, *extra)
    assert np.array_equal(got, getattr(jax_shap, fn)(_f, x, r, M, *extra))


def test_shap_identities():
    assert shapley_kernel_weight(5, 0) == shapley_kernel_weight(5, 5) == 1e4
    rng = np.random.RandomState(0)
    M = 5
    w, x, r = rng.randn(M), rng.randn(M), rng.randn(M)
    phi = kernel_shap(lambda V: V @ w + 0.7, x, r, M)
    np.testing.assert_allclose(phi[:M], w * (x - r), atol=1e-4)
    np.testing.assert_allclose(phi[M], r @ w + 0.7, atol=1e-4)
    fed = kernel_shap_federated(lambda V: V @ w, x, np.zeros(M), M, 3)
    full = kernel_shap(lambda V: V @ w, x, np.zeros(M), M)
    np.testing.assert_allclose(fed[3], full[3:M].sum(), atol=1e-4)


def _clients():
    rng = np.random.RandomState(4)
    centers = rng.randn(3, 8) * 3.0

    def blob(cls, n):
        y = np.full(n, cls, np.int32)
        return (centers[y] + 0.5 * rng.randn(n, 8)).astype(np.float32), y

    # clients 0 and 1: the same class-0 data; client 2: unique class 2
    shared = blob(0, 40)
    train = {0: shared, 1: shared, 2: blob(2, 40)}
    test = {c: blob(c % 3, 12) for c in range(3)}
    return train, test


def test_influence_matches_jax_from_the_same_weights(monkeypatch):
    train, test = _clients()
    kw = dict(epochs=2, batch_size=8, lr=0.2, shuffle=False)
    rounds = dict(comm_round=3, client_num_per_round=2,
                  frequency_of_the_test=100)
    ref = JaxLOO(JaxFederatedDataset.from_client_arrays(train, test, 3),
                 lambda: FlaxLR(num_classes=3),
                 JaxFedAvgConfig(train=JaxTrainConfig(**kw), **rounds))
    want = ref.compute_influence()
    # every JAX run starts from the seed-0 init of its FedAvgAPI
    flax_init = FlaxLR(num_classes=3).init(
        jax.random.key(0), train[0][0][:1], train=False)
    model = create_model("lr", 3, input_shape=(8,))
    start = flax_to_state_dict(jax.tree.map(np.asarray, flax_init), model)

    class FromJaxInit(FedAvgAPI):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.variables = {n: t.clone() for n, t in start.items()}
    monkeypatch.setattr(loo, "FedAvgAPI", FromJaxInit)
    measure = LeaveOneOutMeasure(
        FederatedDataset.from_client_arrays(train, test, 3), lambda: model,
        FedAvgConfig(train=TrainConfig(**kw), **rounds), device="cpu")
    got = measure.compute_influence()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_unique_client_more_influential_than_duplicate():
    train, test = _clients()
    measure = LeaveOneOutMeasure(
        FederatedDataset.from_client_arrays(train, test, 3),
        lambda: create_model("lr", 3, input_shape=(8,)),
        FedAvgConfig(comm_round=4, client_num_per_round=3,
                     frequency_of_the_test=100,
                     train=TrainConfig(epochs=2, batch_size=8, lr=0.2)),
        device="cpu")
    with pytest.raises(RuntimeError, match="compute_influence"):
        measure.ranked()
    influence = measure.compute_influence()
    assert all(v >= 0 for v in influence)
    assert influence[2] > influence[0], influence
    assert measure.ranked()[0] == 2
