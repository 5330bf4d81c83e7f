"""Leave-one-out client influence for horizontal FL.

The counterpart of ``fedml_tpu/contribution/loo.py``. Reference:
fedml_api/contribution/horizontal/: ``train_with_delete`` (fedavg_api.py:
250-295) retrains the federation with one client excluded from every
round's sampling pool, and ``DeleteMeasure.compute_influence``
(delete_measure.py:15-37) scores client k as the mean absolute difference
of the predicted class probabilities of the base model f and the retrained
f_{-k} on the test set.

Retraining reuses FedAvgAPI: ``delete_client`` threads into the seeded
sampler (core/sampling.py), so the base run and every leave-one-out run
share one round body and differ only in the sampled cohorts.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.trainer.functional import make_forward


class LeaveOneOutMeasure:
    def __init__(self, dataset: FederatedDataset, module_factory: Callable,
                 config: Optional[FedAvgConfig] = None,
                 task: str = "classification", device="cuda"):
        """``module_factory()`` gives the model; every run initializes it
        from the config's seed, so each retrain starts from the same
        weights, as the reference's fresh model per measurement run."""
        self.ds = dataset
        self.module_factory = module_factory
        self.config = config or FedAvgConfig()
        self.task = task
        self.device = device
        self.influence: List[Optional[float]] = [None] * dataset.client_num

    def _train(self, delete_client: Optional[int]) -> FedAvgAPI:
        api = FedAvgAPI(self.ds, self.module_factory(), task=self.task,
                        config=self.config, delete_client=delete_client,
                        device=self.device)
        for r in range(self.config.comm_round):
            api.run_round(r)
        return api

    @torch.no_grad()
    def _predict_probs(self, api: FedAvgAPI) -> torch.Tensor:
        xt, _ = self.ds.test_data_global
        logits = make_forward(api.module)(
            api.variables, torch.from_numpy(np.ascontiguousarray(xt)).to(
                api.device), False)
        return torch.softmax(logits, dim=-1)

    def compute_influence(self) -> List[float]:
        """Train the base federation and one leave-one-out run a client;
        influence_k = the mean over test examples of sum over classes of
        |p_f(x) - p_{f_-k}(x)| (reference DeleteMeasure semantics)."""
        base_probs = self._predict_probs(self._train(delete_client=None))
        for k in range(self.ds.client_num):
            probs = self._predict_probs(self._train(delete_client=k))
            self.influence[k] = float(
                (base_probs - probs).abs().sum(dim=-1).mean())
        return list(self.influence)

    def ranked(self) -> List[int]:
        """Client indices by descending influence."""
        if any(v is None for v in self.influence):
            raise RuntimeError("run compute_influence() first")
        return [int(i) for i in np.argsort(self.influence)[::-1]]
