"""Task heads: loss + metric sums per batch.

Each head is a plain function ``head(logits, targets, mask) -> stat sums``.
All stats are *sums* (not means) so they aggregate across batches and
clients by plain addition. Every example row carries a 0/1 ``mask`` weight
(padding rows are 0); the per-batch training loss is ``loss_sum / count``,
torch's ``reduction='mean'`` over the real examples.

This slice ports the classification head (``fedml_tpu/trainer/tasks.py``
``classification_head``); the sequence and segmentation heads come with the
models that need them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Stats = Dict[str, torch.Tensor]
TaskHead = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Stats]


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


TASK_HEADS: Dict[str, TaskHead] = {
    "classification": classification_head,
}
