"""Task heads: loss + metric sums per batch.

Each head is a plain function ``head(logits, targets, mask) -> stat sums``.
All stats are *sums* (not means) so they aggregate across batches and
clients by plain addition. Every example row carries a 0/1 ``mask`` weight
(padding rows are 0); the per-batch training loss is ``loss_sum / count``,
torch's ``reduction='mean'`` over the real examples.

The port has every head of ``fedml_tpu/trainer/tasks.py``:
classification, next-word prediction, tag prediction and the two
segmentation heads (per-pixel cross entropy and focal loss).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Stats = Dict[str, torch.Tensor]
TaskHead = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Stats]

PAD_TOKEN = 0  # sequence pad id (LEAF/TFF convention: 0-padded batches)


def classification_head(logits: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor) -> Stats:
    """Softmax CE + top-1 accuracy. logits [B, C], integer targets [B]."""
    per_ex = F.cross_entropy(logits, targets.long(), reduction="none")
    correct = (logits.argmax(-1) == targets).to(torch.float32)
    return {
        "loss_sum": (per_ex * mask).sum(),
        "count": mask.sum(),
        "correct_sum": (correct * mask).sum(),
    }


def nwp_head(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> Stats:
    """Next-word/char prediction: per-token CE over [B, T, V] logits.

    The accounting unit is the *token*: pad tokens (``PAD_TOKEN``) and
    padded example rows are excluded from the sums."""
    per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1).long(),
                              reduction="none").view(targets.shape)
    tok_mask = (targets != PAD_TOKEN).to(torch.float32) * mask[:, None]
    correct = (logits.argmax(-1) == targets).to(torch.float32)
    return {
        "loss_sum": (per_tok * tok_mask).sum(),
        "count": tok_mask.sum(),
        "correct_sum": (correct * tok_mask).sum(),
    }


def tag_prediction_head(logits: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor) -> Stats:
    """Multi-label tag prediction (stackoverflow_lr): sigmoid BCE over
    [B, L] logits and 0/1 targets. An example is correct only when every
    label matches at threshold 0.5; precision and recall are per-example
    ratios (with the reference's 1e-13 in each denominator) summed over
    the real examples (reference MyModelTrainer.py:72-83)."""
    targets = targets.to(logits.dtype)
    per_label = F.binary_cross_entropy_with_logits(logits, targets,
                                                   reduction="none")
    per_ex = per_label.mean(-1)
    pred = (torch.sigmoid(logits) > 0.5).to(torch.float32)
    exact = (pred == targets).all(-1).to(torch.float32)
    tp = (pred * targets).sum(-1)
    precision = tp / (pred.sum(-1) + 1e-13)
    recall = tp / (targets.sum(-1) + 1e-13)
    return {
        "loss_sum": (per_ex * mask).sum(),
        "count": mask.sum(),
        "correct_sum": (exact * mask).sum(),
        "precision_sum": (precision * mask).sum(),
        "recall_sum": (recall * mask).sum(),
    }


# -- segmentation heads (reference fedseg SegmentationLosses, utils.py:71) --

IGNORE_INDEX = 255  # Pascal-VOC convention: pixels out of loss and metrics


def _pixel_mask(targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Valid-pixel weights: the example mask times (target != ignore)."""
    valid = (targets != IGNORE_INDEX).to(torch.float32)
    return valid * mask.view(tuple(mask.shape) + (1,) * (targets.dim() - 1))


def _pixel_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-pixel softmax CE over NHWC logits ``[B, H, W, C]``, the ignored
    pixels scored against class 0 (their weight is 0)."""
    t = targets.long()
    safe = torch.where(t == IGNORE_INDEX, 0, t)
    return F.cross_entropy(logits.movedim(-1, 1), safe, reduction="none")


def _pixel_stats(per_px, logits, targets, mask) -> Stats:
    pm = _pixel_mask(targets, mask)
    correct = (logits.argmax(-1) == targets).to(torch.float32)
    return {"loss_sum": (per_px * pm).sum(), "count": pm.sum(),
            "correct_sum": (correct * pm).sum()}


def segmentation_head(logits: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor) -> Stats:
    """Mean per-valid-pixel CE (SegmentationLosses.CrossEntropyLoss):
    logits ``[B, H, W, C]``, targets ``[B, H, W]``, 255 ignored."""
    return _pixel_stats(_pixel_ce(logits, targets), logits, targets, mask)


def segmentation_focal_head(logits: torch.Tensor, targets: torch.Tensor,
                            mask: torch.Tensor, gamma: float = 2.0,
                            alpha: float = 0.5) -> Stats:
    """Focal loss ``-alpha * (1 - pt)**gamma * log pt`` per valid pixel
    (SegmentationLosses.FocalLoss, utils.py:95-109)."""
    logpt = -_pixel_ce(logits, targets)
    pt = torch.exp(logpt)
    per_px = -((1.0 - pt) ** gamma) * alpha * logpt
    return _pixel_stats(per_px, logits, targets, mask)


TASK_HEADS: Dict[str, TaskHead] = {
    "classification": classification_head,
    "nwp": nwp_head,
    "tag_prediction": tag_prediction_head,
    "segmentation": segmentation_head,
    "segmentation_focal": segmentation_focal_head,
}


def stats_to_metrics(stats: Stats, prefix: str = "test") -> Dict[str, float]:
    """Stat sums -> the reference metrics dict (MyModelTrainer.test:
    test_correct / test_loss / test_total)."""
    return {f"{prefix}_correct": float(stats["correct_sum"]),
            f"{prefix}_loss": float(stats["loss_sum"]),
            f"{prefix}_total": float(stats["count"])}
