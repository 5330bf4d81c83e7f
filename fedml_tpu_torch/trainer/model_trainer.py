"""The framework-agnostic trainer protocol.

Parity target: ``fedml_core/trainer/model_trainer.py:4-41`` — the reference's
ABC is explicitly the seam where non-torch trainers plug in ("PyTorch,
TensorFlow, Keras, MXNET"; model_trainer.py:5-10). The port's copy of
``fedml_tpu/trainer/model_trainer.py``; its PyTorch implementation lives in
:mod:`fedml_tpu_torch.trainer.torch_trainer`; algorithms are
written against this protocol so alternative backends (e.g. a pure-numpy
oracle trainer used in tests) slot in.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional


class ModelTrainer(abc.ABC):
    """Abstract operator for local training/eval on one client.

    Unlike the reference (whose trainer mutates an internal torch module),
    implementations here are *functional*: model state travels as an explicit
    pytree through ``get/set_model_params`` and the train/test methods, so the
    same trainer object can serve thousands of simulated clients.
    """

    def __init__(self, model: Any, args: Optional[Any] = None):
        self.model = model
        self.id = 0
        self.args = args

    def set_id(self, trainer_id: int):
        self.id = trainer_id

    @abc.abstractmethod
    def get_model_params(self):
        """Return the current model state pytree (reference: cpu state_dict)."""

    @abc.abstractmethod
    def set_model_params(self, model_parameters):
        """Install a model state pytree."""

    @abc.abstractmethod
    def train(self, train_data, device=None, args=None):
        """Run local training on this client's data."""

    @abc.abstractmethod
    def test(self, test_data, device=None, args=None) -> Dict[str, float]:
        """Evaluate; returns the reference metrics dict
        (test_correct/test_loss/test_total[/test_precision/test_recall])."""

    def test_on_the_server(self, train_data_local_dict, test_data_local_dict,
                           device=None, args=None) -> bool:
        """Optional whole-federation eval hook; False = not implemented
        (reference model_trainer.py:36-41)."""
        return False
