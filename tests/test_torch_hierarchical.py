"""The port's hierarchical FedAvg against the JAX package's: the group map
(the same seeded global-RNG draw), global rounds of grouped FedAvg
(the JAX side pads each group to a power-of-two bucket with zero-weight
clients, the port trains the real clients alone: the same numbers), and the
identity with FedAvg at one group and one group round.

Parity runs with shuffle off and no dropout (the seed chains differ).
Tolerance: atol 1e-5, the existing LR parity tolerance.
"""

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms.hierarchical import \
    HierarchicalConfig as JaxHierarchicalConfig
from fedml_tpu.algorithms.hierarchical import \
    HierarchicalFedAvgAPI as JaxHierarchicalFedAvgAPI
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.hierarchical import (HierarchicalConfig,
                                                     HierarchicalFedAvgAPI)
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("groups, group_rounds, per_round", [
    (2, 2, 5), (3, 1, 8)])
def test_global_rounds_match_jax(groups, group_rounds, per_round):
    train = dict(epochs=1, batch_size=16, lr=0.1, shuffle=False,
                 momentum=0.5)
    cfg = dict(global_comm_round=3, group_num=groups,
               group_comm_round=group_rounds, client_num_per_round=per_round,
               frequency_of_the_test=2, seed=3)
    jds = jax_blob(client_num=8, seed=4)
    ref = JaxHierarchicalFedAvgAPI(
        jds, FlaxLR(num_classes=jds.class_num),
        config=JaxHierarchicalConfig(train=JaxTrainConfig(**train), **cfg))
    ds = make_blob_federated(client_num=8, seed=4)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    api = HierarchicalFedAvgAPI(ds, model, device="cpu",
                                config=HierarchicalConfig(
                                    train=TrainConfig(**train), **cfg))
    assert np.array_equal(api.group_indexes, ref.group_indexes)
    api.variables = flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model)
    ref.train()
    api.train()
    want = flax_to_state_dict(jax.tree.map(np.asarray, ref.variables), model)
    for k in want:
        np.testing.assert_allclose(api.variables[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert [r["round"] for r in api.history] == [
        r["round"] for r in ref.history] == [0, 2]
    for got, exp in zip(api.history, ref.history):
        assert set(got) == set(exp)
        for k in exp:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-5, atol=1e-6)


def test_one_group_one_round_equals_fedavg():
    ds = make_blob_federated(client_num=6, seed=0)
    tc = TrainConfig(epochs=1, batch_size=16, lr=0.1, shuffle=False)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    hier = HierarchicalFedAvgAPI(ds, model, device="cpu",
                                 config=HierarchicalConfig(
                                     global_comm_round=3, group_num=1,
                                     group_comm_round=1,
                                     client_num_per_round=6, train=tc))
    avg = FedAvgAPI(ds, model, device="cpu", config=FedAvgConfig(
        comm_round=3, client_num_per_round=6, train=tc))
    for r in range(3):
        hier.run_global_round(r)
        avg.run_round(r)
    for k in avg.variables:
        np.testing.assert_allclose(hier.variables[k].numpy(),
                                   avg.variables[k].numpy(), atol=1e-5)


def test_grouped_training_learns():
    ds = make_blob_federated(client_num=12, seed=1)
    hier = HierarchicalFedAvgAPI(
        ds, create_model("lr", ds.class_num, input_shape=(20,)),
        device="cpu", config=HierarchicalConfig(
            global_comm_round=6, group_num=3, group_comm_round=2,
            client_num_per_round=8, frequency_of_the_test=5,
            train=TrainConfig(epochs=1, batch_size=32, lr=0.1)))
    final = hier.train()
    assert final["test_acc"] > 0.85, final


@pytest.mark.parametrize("kw, err", [
    (dict(group_method="kmeans"), ValueError),
    (dict(train=TrainConfig(lr_decay_round=0.9)), NotImplementedError)])
def test_refusals(kw, err):
    ds = make_blob_federated(client_num=4, seed=0)
    with pytest.raises(err):
        HierarchicalFedAvgAPI(ds, create_model("lr", ds.class_num,
                                               input_shape=(20,)),
                              device="cpu", config=HierarchicalConfig(**kw))
