"""Task heads: loss + metric sums per batch.

Each head is a plain function ``head(logits, targets, mask) -> stat sums``.
All stats are *sums* (not means) so they aggregate across batches and
clients by plain addition. Every example row carries a 0/1 ``mask`` weight
(padding rows are 0); the per-batch training loss is ``loss_sum / count``,
torch's ``reduction='mean'`` over the real examples.

The port has the classification and next-word-prediction heads of
``fedml_tpu/trainer/tasks.py``; the tag-prediction and segmentation heads
come with the models that need them.
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


TASK_HEADS: Dict[str, TaskHead] = {
    "classification": classification_head,
    "nwp": nwp_head,
}


def stats_to_metrics(stats: Stats, prefix: str = "test") -> Dict[str, float]:
    """Stat sums -> the reference metrics dict (MyModelTrainer.test:
    test_correct / test_loss / test_total)."""
    return {f"{prefix}_correct": float(stats["correct_sum"]),
            f"{prefix}_loss": float(stats["loss_sum"]),
            f"{prefix}_total": float(stats["count"])}
