"""Hierarchical (cloud-edge-client) FedAvg, as a standalone simulation.

The counterpart of ``fedml_tpu/algorithms/hierarchical.py``. Reference:
fedml_api/standalone/hierarchical_fl/{trainer,group,client}.py: clients
are assigned to groups at random (trainer.py:10-30); each global round
samples clients (seeded by the global round index) and routes them to
their groups, each group runs ``group_comm_round`` FedAvg rounds among its
sampled clients, and the global model is the mean of the group models
weighted by the groups' sample counts (trainer.py:43-69, group.py:94).

A group round is FedAvg's round body: local training for every client of
the group, then FedAvg's weighted mean (the aggregation kernel on a CUDA
device); the global mean of the groups goes through the same mean. The
JAX package pads each group's clients to a power-of-two bucket with
zero-weight copies, only to bound how many shapes XLA compiles
(``hierarchical.py:47-52, 103-129``); a zero-weight client changes no
number of the weighted mean, so the port trains each group's real clients
alone. The means take the whole state dict, a model's BatchNorm
statistics with its params, as the JAX package's take its variables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (_normalized,
                                               device_weighted_mean)
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.sampling import (derive_seed,
                                           locked_global_numpy_rng,
                                           make_generator, round_keys,
                                           sample_clients)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule,
                                                make_eval, make_local_train,
                                                stack_schedules,
                                                validate_accum_steps)
from fedml_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HierarchicalConfig:
    global_comm_round: int = 5
    group_comm_round: int = 2
    group_num: int = 2
    group_method: str = "random"
    client_num_per_round: int = 10
    frequency_of_the_test: int = 5
    seed: int = 0
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class HierarchicalFedAvgAPI:
    """``device`` defaults to CUDA and raises when no GPU is present."""

    def __init__(self, dataset: FederatedDataset, module: torch.nn.Module,
                 task: str = "classification",
                 config: Optional[HierarchicalConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.module = module
        self.config = config or HierarchicalConfig()
        cfg = self.config
        if cfg.group_method != "random":
            raise ValueError(f"unknown group_method {cfg.group_method!r}")
        if cfg.train.lr_decay_round != 1.0:
            raise NotImplementedError(
                "lr_decay_round is not defined for the 2-tier loop (which "
                "round index decays — group or global?); use the flat "
                "FedAvg drivers for the schedule")
        # reference parity (GroupHierarchicalFL seeds the global stream):
        # the same draw as the JAX package's, under the same lock
        with locked_global_numpy_rng(cfg.seed) as grng:
            self.group_indexes = grng.randint(0, cfg.group_num,
                                              dataset.client_num)
        validate_accum_steps(cfg.train, dataset.train_data_local_num_dict)
        self._local_train = make_local_train(module, task, cfg.train)
        self._eval_fn = make_eval(module, task)
        self._mean = device_weighted_mean(self.device)
        init_params(module.cpu(), make_generator(cfg.seed))
        self.variables = {k: v.detach().clone().to(self.device)
                          for k, v in module.state_dict().items()}
        module.to(self.device)
        self.history: List[Dict] = []

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _group_clients(self, global_round_idx: int) -> Dict[int, List[int]]:
        sampled = sample_clients(global_round_idx, self.dataset.client_num,
                                 self.config.client_num_per_round)
        groups: Dict[int, List[int]] = {}
        for c in np.asarray(sampled):
            groups.setdefault(int(self.group_indexes[int(c)]), []).append(
                int(c))
        return groups

    def _train_group(self, variables, global_round_idx: int,
                     client_idxs: List[int]):
        """``group_comm_round`` FedAvg rounds among this group's sampled
        clients; returns the group model and its sample count."""
        cfg, tc, ds = self.config, self.config.train, self.dataset
        # each group's rounds pad to its sampled clients' bucket
        n_pad = ds.cohort_padded_len(client_idxs, tc.batch_size)
        x, y, mask_host = ds.pack_clients(client_idxs, tc.batch_size,
                                          n_pad=n_pad)
        counts = ds.client_weights(client_idxs)
        x, y, mask, weights = (self._upload(a) for a in
                               (x, y, mask_host, counts))
        base = derive_seed(cfg.seed, global_round_idx)
        for gr in range(cfg.group_comm_round):
            _, seeds, _ = round_keys(base, gr, client_idxs)
            plan = stack_schedules([
                make_batch_schedule(n_pad, tc.epochs, tc.batch_size or n_pad,
                                    tc.shuffle, s, m, tc.accum_steps)
                for s, m in zip(seeds, mask_host)])
            trained = [self._local_train(variables, x[i], y[i], mask[i],
                                         None, schedule=plan.at(i))[0]
                       for i in range(len(client_idxs))]
            variables = self._mean(pt.tree_stack(trained), weights)
        return variables, float(counts.sum())

    def run_global_round(self, global_round_idx: int):
        groups = self._group_clients(global_round_idx)
        group_vars, group_weights = [], []
        for gidx in sorted(groups):
            gv, gw = self._train_group(self.variables, global_round_idx,
                                       groups[gidx])
            group_vars.append(gv)
            group_weights.append(gw)
        self.variables = self._mean(
            pt.tree_stack(group_vars),
            self._upload(np.asarray(group_weights, np.float32)))
        return groups

    def evaluate(self, round_idx: int) -> Dict:
        rec = {"round": round_idx}
        for split, (x, y) in (("test", self.dataset.test_data_global),
                              ("train", self.dataset.train_data_global)):
            if len(x):
                rec.update(_normalized(self._eval_fn(
                    self.variables, self._upload(x), self._upload(y),
                    torch.ones(len(x), device=self.device)), split))
        return rec

    def train(self) -> Dict:
        cfg = self.config
        for gr in range(cfg.global_comm_round):
            self.run_global_round(gr)
            last = gr == cfg.global_comm_round - 1
            if gr % cfg.frequency_of_the_test == 0 or last:
                self.history.append(self.evaluate(gr))
        return self.history[-1] if self.history else {}
