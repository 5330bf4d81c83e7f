"""Centralized (non-federated) baseline trainer.

The counterpart of ``fedml_tpu/algorithms/centralized.py``. Parity
target: fedml_api/centralized/centralized_trainer.py:9, which trains the
same models on the pooled federated data. It is also the oracle of the CI
equivalence invariant (CI-script-fedavg.sh: FedAvg with full participation,
full batch and one local epoch matches centralized training): the
sample-weighted mean of one full-batch SGD step a client is one full-batch
step on the pooled data.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.trainer.functional import TrainConfig
from fedml_tpu_torch.trainer.torch_trainer import TorchModelTrainer


class CentralizedTrainer:
    """``device`` defaults to CUDA and raises when no GPU is present."""

    def __init__(self, dataset: FederatedDataset, module: torch.nn.Module,
                 task: str = "classification",
                 cfg: Optional[TrainConfig] = None, seed: int = 0,
                 device="cuda"):
        self.dataset = dataset
        self.trainer = TorchModelTrainer(module, task, cfg or TrainConfig(),
                                         seed=seed, device=device)
        self.trainer.init(seed=seed)

    @property
    def variables(self):
        return self.trainer.get_model_params()

    def train(self) -> Dict[str, float]:
        """One call = cfg.epochs passes over the pooled training data."""
        return self.trainer.train(self.dataset.train_data_global)

    def evaluate(self) -> Dict[str, float]:
        rec = self.trainer.test(self.dataset.test_data_global)
        rec["test_acc"] = rec["test_correct"] / max(1.0, rec["test_total"])
        train = self.trainer.test(self.dataset.train_data_global)
        rec["train_acc"] = train["test_correct"] / max(1.0,
                                                       train["test_total"])
        rec["train_loss"] = train["test_loss"] / max(1.0, train["test_total"])
        return rec
