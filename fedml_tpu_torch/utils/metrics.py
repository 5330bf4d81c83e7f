"""Metrics sink: a JSON-lines stream plus a wandb-compatible summary.

The sink always writes ``metrics.jsonl`` and a ``wandb-summary.json`` with
the latest value per key (the artifact the reference CI scrapes,
CI-script-fedavg.sh:45), and mirrors to wandb when it is installed and
enabled. Values may be Python or numpy scalars or 0-d tensors; logging one
that lives on the device copies it to the host, so callers log every k
rounds, not every round.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def _to_plain(v: Any) -> Any:
    if isinstance(v, (np.generic,)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return float(v.item())
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class MetricsSink:
    def __init__(self, run_dir: str, config: Optional[Dict] = None,
                 use_wandb: bool = False, project: str = "fedml_tpu_torch"):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._log_path = os.path.join(run_dir, "metrics.jsonl")
        self._summary_path = os.path.join(run_dir, "wandb-summary.json")
        self.summary: Dict[str, Any] = {}
        self._t0 = time.time()
        self._wandb = None
        if config:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump({k: _to_plain(v) for k, v in config.items()}, f,
                          indent=2)
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, config=config,
                                         dir=run_dir)
            except Exception:  # offline / not installed / not logged in
                import logging
                logging.info("wandb logging disabled (init failed)",
                             exc_info=True)
                self._wandb = None

    def log(self, metrics: Dict[str, Any],
            step: Optional[int] = None) -> None:
        rec = {k: _to_plain(v) for k, v in metrics.items()}
        if step is not None:
            rec["step"] = step
        rec["_wall_s"] = round(time.time() - self._t0, 3)
        with open(self._log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self.summary.update(rec)
        with open(self._summary_path, "w") as f:
            json.dump(self.summary, f)
        if self._wandb is not None:
            self._wandb.log(rec, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def read_metrics(run_dir: str):
    """Every record logged to ``run_dir``, oldest first."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]
