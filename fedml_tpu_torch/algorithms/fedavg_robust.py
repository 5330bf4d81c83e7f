"""Robust FedAvg: defenses against Byzantine and backdoor clients.

The counterpart of ``fedml_tpu/algorithms/fedavg_robust.py``. Reference:
fedml_api/distributed/fedavg_robust/, whose FedAvgRobustAggregator applies
norm-diff clipping and/or weak-DP gaussian noise to each client update
before the weighted mean (FedAvgRobustAggregator.py:166-220, kernels in
fedml_core/robustness/robust_aggregation.py), with the flags
``--defense_type {norm_diff_clipping,weak_dp} --norm_bound --stddev``
(main_fedavg_robust.py:56-63). The Byzantine-robust rules (median, trimmed
mean, Krum) replace the mean itself.

The defense is FedAvg's aggregation hook on the shared round body, so
sampling, packing and local training are FedAvgAPI's, and the API keeps
FedAvg's fused driver: every defense is capturable (core/robust.py). After
a per-update defense the weighted mean is FedAvg's (the aggregation kernel
on a CUDA device); the rules are plain torch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.core.robust import (DEFENSES, ROBUST_AGGREGATORS,
                                         apply_defense)
from fedml_tpu_torch.data.base import FederatedDataset


@dataclasses.dataclass(frozen=True)
class FedAvgRobustConfig(FedAvgConfig):
    defense_type: Optional[str] = "norm_diff_clipping"
    norm_bound: float = 5.0
    stddev: float = 0.025
    # Byzantine-robust aggregation rules (beyond the reference's pair):
    # defense_type = median | trimmed_mean | krum
    trim_ratio: float = 0.1       # trimmed_mean
    num_byzantine: int = 1        # krum: assumed attacker count f
    multi_m: int = 1              # krum: average the m best (multi-Krum)


class FedAvgRobustAPI(FedAvgAPI):
    """FedAvg with a defended aggregation rule, as an aggregate hook on the
    shared round body (incl. leave-one-out)."""

    def __init__(self, dataset: FederatedDataset, module,
                 task: str = "classification",
                 config: Optional[FedAvgRobustConfig] = None,
                 delete_client: Optional[int] = None, device="cuda"):
        config = config or FedAvgRobustConfig()
        defense_type = config.defense_type
        if defense_type in ROBUST_AGGREGATORS:
            # aggregation-rule defenses replace the weighted mean; sample
            # counts are ignored on purpose (a Byzantine client can lie
            # about n_i)
            rule = functools.partial(ROBUST_AGGREGATORS[defense_type], **{
                "trimmed_mean": {"trim_ratio": config.trim_ratio},
                "krum": {"num_byzantine": config.num_byzantine,
                         "multi_m": config.multi_m},
            }.get(defense_type, {}))

            def defended_mean(variables, stacked, weights, agg_seed):
                return rule(stacked)
        elif defense_type is None or defense_type in DEFENSES:
            # per-update defenses (the reference's pair): move each client
            # update toward the global model, then FedAvg's weighted mean
            def defended_mean(variables, stacked, weights, agg_seed):
                defended = apply_defense(stacked, variables, defense_type,
                                         config.norm_bound, config.stddev,
                                         agg_seed)
                return self._mean(defended, weights)
        else:
            raise ValueError(f"unknown defense_type: {defense_type!r}")
        super().__init__(dataset, module, task, config,
                         delete_client=delete_client,
                         aggregate_hook=defended_mean, device=device)


def poison_client_labelflip(dataset: FederatedDataset, client_idx: int,
                            target_label: int, trigger_value: float = 2.0,
                            fraction: float = 1.0,
                            seed: int = 0) -> FederatedDataset:
    """Backdoor a client in place of the reference's poisoned loaders:
    stamp a trigger patch into a fraction of the client's inputs and flip
    their labels to ``target_label``. Returns a new FederatedDataset."""
    rng = np.random.RandomState(seed)
    train_local = dict(dataset.train_data_local_dict)
    x, y = train_local[client_idx]
    x, y = x.copy(), y.copy()
    n = len(x)
    chosen = rng.choice(n, max(1, int(n * fraction)), replace=False)
    xv = x.reshape(n, -1)
    xv[chosen, : max(1, xv.shape[1] // 16)] = trigger_value
    y[chosen] = target_label
    train_local[client_idx] = (xv.reshape(x.shape), y)
    return FederatedDataset.from_client_arrays(
        train_local, dataset.test_data_local_dict, dataset.class_num)
