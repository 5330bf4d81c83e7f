"""FedSeg: FedAvg for semantic segmentation, with the reference's toolkit.

The counterpart of ``fedml_tpu/algorithms/fedseg.py`` (reference
fedml_api/distributed/fedseg/utils.py):

- the per-pixel CE and focal heads live with the other task heads
  (trainer/tasks.py ``segmentation_head``, ``segmentation_focal_head``,
  255 ignored), so any algorithm can train on a segmentation dataset;
- :func:`make_lr_schedule`: cos, poly(0.9) and step decay with linear
  warmup (LR_Scheduler, utils.py:114-157), step -> lr in float32;
- :class:`SegEvaluator`: confusion-matrix pixel metrics, pixel accuracy,
  per-class accuracy, mIoU and FWIoU (Evaluator, utils.py:246-288);
- :func:`make_confusion_eval`: the confusion matrix of a model over a test
  set in fixed-size batches, accumulated in int32 on the device;
- :class:`EvaluationMetricsKeeper` (utils.py:62-68) and
  :class:`FedSegAPI`, FedAvg rounds whose evaluation adds ``test_mIoU``,
  ``test_FWIoU`` and ``test_acc_class``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.trainer.functional import make_forward


def make_lr_schedule(mode: str, base_lr: float, num_epochs: int,
                     iters_per_epoch: int, lr_step: int = 0,
                     warmup_epochs: int = 0):
    """``schedule(global step) -> lr`` (a 0-dim float32 tensor) matching
    LR_Scheduler (utils.py:114-157), computed in float32 as the JAX
    package's optax schedule is."""
    N = num_epochs * iters_per_epoch
    warmup_iters = warmup_epochs * iters_per_epoch
    if mode not in ("cos", "poly", "step"):
        raise NotImplementedError(mode)
    if mode == "step" and not lr_step:
        raise ValueError("step mode needs lr_step")

    def schedule(step):
        T = torch.as_tensor(step, dtype=torch.float32)
        if mode == "cos":
            lr = 0.5 * base_lr * (1.0 + torch.cos(T / N * math.pi))
        elif mode == "poly":
            lr = base_lr * (1.0 - T / N) ** 0.9
        else:
            epoch = torch.floor_divide(T, iters_per_epoch)
            lr = base_lr * 0.1 ** torch.floor_divide(epoch, lr_step)
        if warmup_iters > 0:
            lr = torch.where(T < warmup_iters, lr * T / warmup_iters, lr)
        return lr

    return schedule


@dataclasses.dataclass
class EvaluationMetricsKeeper:
    """utils.py:62-68, the same fields."""

    accuracy: float
    accuracy_class: float
    mIoU: float
    FWIoU: float
    loss: float


def confusion_counts(gt: torch.Tensor, pred: torch.Tensor,
                     num_class: int) -> torch.Tensor:
    """The ``[C, C]`` int64 confusion counts (row: ground truth, column:
    prediction) of the pixels whose label is in ``[0, C)``: ignored (255)
    and padded (-1) pixels fall in an extra bin that is dropped."""
    C = num_class
    gt, pred = gt.reshape(-1).long(), pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < C)
    idx = torch.where(valid, gt * C + pred, C * C)
    return torch.bincount(idx, minlength=C * C + 1)[:C * C].view(C, C)


class SegEvaluator:
    """Confusion-matrix pixel metrics (reference Evaluator,
    utils.py:246-288): ``add_batch`` counts on the tensors' device, the
    nan-mean reductions run on the host in float64."""

    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class))

    def add_batch(self, gt_image, pre_image) -> None:
        gt, pred = torch.as_tensor(gt_image), torch.as_tensor(pre_image)
        if gt.shape != pred.shape:
            raise ValueError(f"shapes differ: {tuple(gt.shape)} and "
                             f"{tuple(pred.shape)}")
        self.confusion_matrix += confusion_counts(
            gt, pred, self.num_class).cpu().numpy()

    def reset(self) -> None:
        self.confusion_matrix = np.zeros((self.num_class, self.num_class))

    def pixel_accuracy(self) -> float:
        cm = self.confusion_matrix
        return float(np.diag(cm).sum() / cm.sum())

    def pixel_accuracy_class(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(cm) / cm.sum(axis=1)
        return float(np.nanmean(acc))

    def mean_iou(self) -> float:
        cm = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float(np.nanmean(iu))

    def frequency_weighted_iou(self) -> float:
        cm = self.confusion_matrix
        freq = cm.sum(axis=1) / cm.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float((freq[freq > 0] * iu[freq > 0]).sum())


def make_confusion_eval(module: torch.nn.Module, num_class: int,
                        batch_size: int = 16):
    """Build ``confusion(variables, x, y) -> [C, C] int32``: the model in
    eval mode over ``x`` in batches of ``batch_size``, the counts of each
    batch summed in int32 (exact; the reference accumulates in int64, f32
    cells would round past 2**24). The last batch is padded with zero
    images labelled -1, which the validity rule ``0 <= gt < C`` drops with
    the ignored pixels, as the JAX package's scan pads it."""
    forward = make_forward(module)

    @torch.no_grad()
    def confusion(variables, x: torch.Tensor, y: torch.Tensor):
        n = x.shape[0]
        bsz = min(batch_size, n)
        pad = -(-n // bsz) * bsz - n
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            y = torch.cat([y, y.new_full((pad,) + tuple(y.shape[1:]), -1)])
        cm = torch.zeros((num_class, num_class), dtype=torch.int32,
                         device=x.device)
        for lo in range(0, n + pad, bsz):
            pred = forward(variables, x[lo:lo + bsz], False).argmax(-1)
            cm += confusion_counts(y[lo:lo + bsz], pred,
                                   num_class).to(torch.int32)
        return cm

    return confusion


class FedSegAPI(FedAvgAPI):
    """FedAvg rounds over a segmentation model (``loss_mode`` ``"ce"`` or
    ``"focal"`` picks the head); evaluation reports the IoU family too
    (reference FedSegAggregator + add_client_test_result,
    FedSegAggregator.py:12-105). ``device`` defaults to CUDA and raises
    when no GPU is present."""

    def __init__(self, dataset: FederatedDataset, module: torch.nn.Module,
                 config: Optional[FedAvgConfig] = None,
                 loss_mode: str = "ce", eval_batch_size: int = 16,
                 device="cuda"):
        if loss_mode not in ("ce", "focal"):
            raise ValueError(f"unknown loss_mode {loss_mode!r}")
        task = "segmentation" if loss_mode == "ce" else "segmentation_focal"
        super().__init__(dataset, module, task=task, config=config,
                         device=device)
        self._confusion = make_confusion_eval(module, dataset.class_num,
                                              eval_batch_size)

    def evaluate(self, round_idx: int) -> Dict:
        rec = super().evaluate(round_idx)
        xt, yt = self.dataset.test_data_global
        if len(xt):
            ev = SegEvaluator(self.dataset.class_num)
            ev.confusion_matrix += self._confusion(
                self.variables, self._upload(np.ascontiguousarray(xt)),
                self._upload(np.ascontiguousarray(yt))).cpu().numpy()
            keeper = EvaluationMetricsKeeper(
                accuracy=ev.pixel_accuracy(),
                accuracy_class=ev.pixel_accuracy_class(),
                mIoU=ev.mean_iou(), FWIoU=ev.frequency_weighted_iou(),
                loss=rec.get("test_loss", float("nan")))
            rec.update({"test_mIoU": keeper.mIoU, "test_FWIoU": keeper.FWIoU,
                        "test_acc_class": keeper.accuracy_class})
        return rec
