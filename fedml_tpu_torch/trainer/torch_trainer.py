"""The PyTorch implementation of the ModelTrainer protocol.

The counterpart of ``fedml_tpu/trainer/flax_trainer.py``: the host-facing
object for algorithms that want the reference's object-oriented seam (get
and set params, train, test; reference fedml_core/trainer/
model_trainer.py). Its programs are the port's own (trainer/functional.py:
``make_local_train``, built on ``make_train_step``, and ``make_eval``),
shared with the round drivers, so the class and the rounds cannot drift
apart.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.sampling import derive_seed, make_generator
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.trainer.functional import (TrainConfig, make_eval,
                                                make_local_train,
                                                validate_accum_steps)
from fedml_tpu_torch.trainer.model_trainer import ModelTrainer
from fedml_tpu_torch.trainer.tasks import stats_to_metrics
from fedml_tpu_torch.utils.device import resolve_device

Arrays = Tuple[np.ndarray, np.ndarray]  # (x, y)


class TorchModelTrainer(ModelTrainer):
    """``device`` defaults to CUDA and raises when no GPU is present."""

    def __init__(self, module: torch.nn.Module,
                 task: str = "classification",
                 cfg: Optional[TrainConfig] = None, seed: int = 0,
                 device="cuda"):
        super().__init__(module, cfg)
        self.module = module
        self.task = task
        self.cfg = cfg or TrainConfig()
        self.device = resolve_device(device)
        if self.cfg.lr_decay_round != 1.0:
            raise NotImplementedError(
                "lr_decay_round is a ROUND-level schedule; the ModelTrainer "
                "operator has no round index — drivers apply it")
        self._seed, self._calls = seed, 0
        self._variables = None
        self._train_fn = make_local_train(module, task, self.cfg)
        self._eval_fn = make_eval(module, task)

    # -- state ------------------------------------------------------------
    def init(self, sample_x: np.ndarray = None, seed: int = 0):
        """Initialize the weights from ``seed`` (``sample_x`` is accepted
        for the JAX trainer's signature: a torch module knows its shapes)."""
        init_params(self.module.cpu(), make_generator(seed))
        self._variables = {k: v.detach().clone().to(self.device)
                           for k, v in self.module.state_dict().items()}
        self.module.to(self.device)
        return self._variables

    def get_model_params(self):
        return self._variables

    def set_model_params(self, model_parameters):
        self._variables = model_parameters

    # -- compute ----------------------------------------------------------
    def _tensors(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def train(self, train_data, device=None, args=None):
        """``train_data``: (x, y) or (x, y, mask) arrays; trains the
        installed params in place and returns the summed train stats. Each
        call draws its shuffle and dropout from a new seed of the chain."""
        x, y, mask = _with_mask(train_data)
        bsz = self.cfg.batch_size or x.shape[0]
        if self.cfg.accum_steps > 1:
            validate_accum_steps(self.cfg, {0: len(x)})
        x, y, mask = _pad_to_multiple(x, y, mask, bsz)
        seed = derive_seed(self._seed, self._calls)
        self._calls += 1
        self._variables, stats = self._train_fn(
            self._variables, *self._tensors(x, y, mask), seed)
        return {k: float(v) for k, v in stats.items()}

    def test(self, test_data, device=None, args=None) -> Dict[str, float]:
        x, y, mask = _with_mask(test_data)
        return stats_to_metrics(self._eval_fn(self._variables,
                                              *self._tensors(x, y, mask)))


def _with_mask(data):
    if len(data) == 3:
        return data
    x, y = data
    return x, y, np.ones(len(x), dtype=np.float32)


def _pad_to_multiple(x, y, mask, bsz: int):
    n = len(x)
    pad = -(-n // bsz) * bsz - n
    if pad == 0:
        return x, y, mask
    x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
    mask = np.concatenate([mask, np.zeros(pad, mask.dtype)])
    return x, y, mask
