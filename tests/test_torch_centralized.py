"""The port's trainer protocol and centralized baseline against the JAX
package's: ``TorchModelTrainer`` against ``FlaxModelTrainer`` and
``CentralizedTrainer`` against JAX's from the same initial weights (shuffle
off, the seed chains differ), and the CI equivalence invariant of
hierarchical FL against centralized training.

Tolerances: atol 1e-5 for params (the LR parity tolerance); metrics
rtol 1e-5, and for loss sums 1e-3 of absolute room: once the blobs are fit
they sum thousands of near-zero cross entropies, each with ~1e-7 of
absolute round-off (the log-softmax of a probability near 1).
"""

import jax
import numpy as np
import pytest

from fedml_tpu.algorithms.centralized import \
    CentralizedTrainer as JaxCentralizedTrainer
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu.models.lr import LogisticRegression as FlaxLR
from fedml_tpu.trainer.flax_trainer import FlaxModelTrainer
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.hierarchical import (HierarchicalConfig,
                                                     HierarchicalFedAvgAPI)
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.trainer.model_trainer import ModelTrainer
from fedml_tpu_torch.trainer.torch_trainer import TorchModelTrainer
from fedml_tpu_torch.utils.convert import flax_to_state_dict

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-3 if "loss" in k else 0, err_msg=k)


def _close(port_vars, jax_vars, model):
    want = flax_to_state_dict(jax.tree.map(np.asarray, jax_vars), model)
    for k in want:
        np.testing.assert_allclose(port_vars[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(epochs=2, batch_size=16, lr=0.1),
    dict(epochs=1, batch_size=None, lr=0.3, momentum=0.9),
    dict(epochs=2, batch_size=24, lr=0.01, client_optimizer="adam",
         wd=1e-4)], ids=["sgd", "full-batch-momentum", "adam"])
def test_trainer_matches_flax_trainer(kw):
    ds = make_blob_federated(client_num=4, seed=5)
    x, y = ds.train_data_local_dict[1]  # 1 client, not a batch multiple
    ref = FlaxModelTrainer(FlaxLR(num_classes=ds.class_num),
                           cfg=JaxTrainConfig(shuffle=False, **kw))
    ref.init(x[:1])
    model = create_model("lr", ds.class_num, input_shape=(20,))
    tr = TorchModelTrainer(model, cfg=TrainConfig(shuffle=False, **kw),
                           device="cpu")
    tr.init()
    tr.set_model_params(flax_to_state_dict(
        jax.tree.map(np.asarray, ref.get_model_params()), model))
    for _ in range(2):
        _metrics_close(tr.train((x, y)), ref.train((x, y)))
    _close(tr.get_model_params(), ref.get_model_params(), model)
    xt, yt = ds.test_data_global
    _metrics_close(tr.test((xt, yt)), ref.test((xt, yt)))


def test_centralized_matches_jax():
    tc = dict(epochs=2, batch_size=32, lr=0.1, shuffle=False)
    jds = jax_blob(client_num=5, seed=6)
    ref = JaxCentralizedTrainer(jds, FlaxLR(num_classes=jds.class_num),
                                cfg=JaxTrainConfig(**tc))
    ds = make_blob_federated(client_num=5, seed=6)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    cent = CentralizedTrainer(ds, model, cfg=TrainConfig(**tc), device="cpu")
    cent.trainer.set_model_params(flax_to_state_dict(
        jax.tree.map(np.asarray, ref.variables), model))
    for _ in range(2):
        ref.train()
        cent.train()
    _close(cent.variables, ref.variables, model)
    _metrics_close(cent.evaluate(), ref.evaluate())


def test_hierarchical_matches_centralized_at_full_participation():
    """CI invariant (CI-script-fedavg.sh:55-62): full participation, full
    batch, E=1 and a small lr: hierarchical FL matches centralized
    training's accuracy to ~3 decimals under a fixed round product."""
    ds = make_blob_federated(client_num=6, partition_method="homo", seed=0)
    tc = TrainConfig(epochs=1, batch_size=None, lr=0.03, shuffle=False)
    hier = HierarchicalFedAvgAPI(
        ds, create_model("lr", ds.class_num, input_shape=(20,)),
        device="cpu", config=HierarchicalConfig(
            global_comm_round=5, group_num=2, group_comm_round=2,
            client_num_per_round=6, frequency_of_the_test=100, train=tc))
    hier.train()
    cent = CentralizedTrainer(
        ds, create_model("lr", ds.class_num, input_shape=(20,)),
        cfg=TrainConfig(epochs=10, batch_size=None, lr=0.03, shuffle=False),
        device="cpu")
    cent.train()
    assert abs(hier.history[-1]["train_acc"]
               - cent.evaluate()["train_acc"]) < 5e-3


def test_trainer_protocol_and_refusal():
    with pytest.raises(TypeError):
        ModelTrainer(None)  # abstract
    model = create_model("lr", 3, input_shape=(4,))
    tr = TorchModelTrainer(model, device="cpu")
    assert tr.test_on_the_server({}, {}) is False
    tr.set_id(7)
    assert tr.id == 7
    with pytest.raises(NotImplementedError, match="lr_decay_round"):
        TorchModelTrainer(model, cfg=TrainConfig(lr_decay_round=0.5),
                          device="cpu")
