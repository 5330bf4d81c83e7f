"""Job specs: what one tenant federation is, fully and deterministically
(the port's copy of ``fedml_tpu/sched/jobs.py``).

A :class:`JobSpec` pins everything that shapes a job's run (dataset,
model, silo count, rounds, training, seed, compression, the fault
tolerance knobs), because the tenancy contract is bit for bit: the chaos
harness builds the same spec in a solo leg, in the shared leg and inside a
SIGKILLed and respawned server subprocess, and every build must give the
same federation. :func:`build_job_fixture` is therefore a pure function of
the spec.

``jobs.json`` (the input of ``python -m fedml_tpu_torch.sched launch
--jobs``) is a list of spec objects or ``{"jobs": [...]}``::

    {"jobs": [
      {"id": "ads",  "dataset": "blob", "workers": 3, "rounds": 8,
       "share": 2.0, "seed": 7, "epochs": 1, "batch_size": 16,
       "lr": 0.1, "compression": "topk_ef_int8:0.1"},
      {"id": "asr",  "dataset": "blob", "workers": 2, "rounds": 6,
       "share": 1.0, "round_deadline_s": 2.0, "heartbeat_s": 0.3}
    ]}

``share`` is the job's device-time weight (``sched/interleave.py``): when
jobs contend for the card the grant goes to the waiting job with the
lowest ``device_time / share``. Unknown keys are refused: a misspelt knob
must not run on defaults.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, List, Optional

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant federation, fully determined."""

    id: str
    dataset: str = "blob"
    model: Optional[str] = None
    workers: int = 2
    rounds: int = 4
    share: float = 1.0
    clients: Optional[int] = None  # client population (default: workers)
    seed: int = 0
    epochs: int = 1
    batch_size: int = 8
    lr: float = 0.1
    wd: float = 0.0
    compression: Optional[str] = None
    # fault tolerance and the control plane (defaults: strict barrier)
    round_deadline_s: Optional[float] = None
    min_quorum_frac: float = 0.5
    heartbeat_s: float = 0.0
    pace_steering: bool = False
    join_rate_limit: float = 0.0
    max_deadline_extensions: Optional[int] = 25
    # the serving tier (ROADMAP Slice D item 23c, not ported: a spec that
    # sets serve_port is refused when it runs); None = no endpoint
    serve_port: Optional[int] = None
    serve_staleness_rounds: int = 2
    # the blob dataset's shape
    dim: int = 8
    class_num: int = 3
    n_samples: int = 120

    def __post_init__(self):
        if not _ID_RE.match(self.id):
            raise ValueError(
                f"job id {self.id!r} must match {_ID_RE.pattern} (it names "
                "checkpoint directories and wire frames)")
        if self.workers < 1:
            raise ValueError(f"job {self.id}: workers must be >= 1, got "
                             f"{self.workers}")
        if self.rounds < 1:
            raise ValueError(f"job {self.id}: rounds must be >= 1, got "
                             f"{self.rounds}")
        if self.share <= 0:
            raise ValueError(f"job {self.id}: share must be > 0, got "
                             f"{self.share}")

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_FIELDS = {f.name for f in dataclasses.fields(JobSpec)}


def spec_from_dict(obj: Dict[str, Any]) -> JobSpec:
    if not isinstance(obj, dict):
        raise ValueError(f"job spec must be an object, got {type(obj)}")
    unknown = sorted(set(obj) - _FIELDS)
    if unknown:
        raise ValueError(
            f"job spec {obj.get('id', '?')!r}: unknown keys {unknown} — "
            f"known: {sorted(_FIELDS)}")
    if "id" not in obj:
        raise ValueError("job spec missing required key 'id'")
    return JobSpec(**obj)


def load_jobs(path: str) -> List[JobSpec]:
    """Parse a jobs.json file into validated specs with unique ids."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("jobs")
    if not isinstance(data, list) or not data:
        raise ValueError(f"{path}: expected a non-empty list of job specs "
                         "(or {'jobs': [...]})")
    specs = [spec_from_dict(o) for o in data]
    ids = [s.id for s in specs]
    dupes = sorted({i for i in ids if ids.count(i) > 1})
    if dupes:
        raise ValueError(f"{path}: duplicate job ids {dupes} — each tenant "
                         "needs its own control/obs namespace")
    return specs


def build_job_fixture(spec: JobSpec):
    """``(dataset, module, task, train_cfg)``, a pure function of the spec:
    every process that builds it (the solo leg, the shared leg, a
    respawned server subprocess) gets the same federation. The module is
    new on every call and lives on the CPU until a launcher moves it."""
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.functional import TrainConfig
    tcfg = TrainConfig(epochs=spec.epochs, batch_size=spec.batch_size,
                       lr=spec.lr, wd=spec.wd)
    clients = spec.clients if spec.clients is not None else spec.workers
    if spec.dataset == "blob":
        from fedml_tpu_torch.data.synthetic import make_blob_federated
        ds = make_blob_federated(client_num=clients, dim=spec.dim,
                                 class_num=spec.class_num,
                                 n_samples=spec.n_samples, seed=spec.seed)
        task = "classification"
        model_name = spec.model or "lr"
    else:
        from fedml_tpu_torch.data.registry import (DEFAULT_MODEL_AND_TASK,
                                                   load_data)
        ds = load_data(spec.dataset, "", client_num_in_total=clients)
        model_name, task = DEFAULT_MODEL_AND_TASK.get(
            spec.dataset, ("lr", "classification"))
        if spec.model:
            model_name = spec.model
    module = create_model(model_name, output_dim=ds.class_num,
                          input_shape=ds.train_data_global[0].shape[1:])
    return ds, module, task, tcfg
