"""Distributed FedAvg over the message layer: the cross-silo path.

The counterpart of ``fedml_tpu/algorithms/fedavg_cross_silo.py``, its
strict-barrier protocol. When clients are separate trust domains (no
shared mesh), the round is the reference's actor protocol
(fedml_api/distributed/fedavg/): the server broadcasts the global model,
each silo trains its sampled client and sends back ``(model_params,
num_samples)``, and the server aggregates once every silo has reported.

Parity map:
- message schema -> reference message_define.py:1-31 (the same 4 types);
- FedAvgAggregator -> FedAVGAggregator.py:13-107 (all-received barrier,
  sample-weighted average, per-round seeded sampling), as a streaming
  in-order fold;
- FedAvgServerManager / FedAvgClientManager -> FedAvgServerManager.py:
  18-93, FedAvgClientManager.py:18-71, with an explicit FINISH message.

Wire compression (comm/policy.py, ``--compression``): replies compress the
silo's delta against the model it was sent (int8 and/or top-k with a
per-silo error-feedback residual held in memory); broadcasts from the
second on compress against the *mirror*, the model every silo holds,
advanced by exactly what each broadcast decodes to, and fall back to full
precision whenever a silo's reported base disagrees. The int8 quantize and
dequantize run in the hand-written kernels (ops/quantize.py) on a CUDA
device. Wire bytes are the encoded frames' lengths, counted into the
RoundTimer (``comm_bytes_up`` / ``comm_bytes_down``).

The server can instead close each round with a FedOpt step
(:class:`FedOptServerManager`, ``server_optimizer=``), keep every report
for a custom ``aggregate_fn`` (the buffered close), and save the round
state after every round for ``resume`` (``checkpoint_dir``): the server's
model (and server optimizer state) through ``utils/checkpoint.py``, each
silo's error-feedback residual in ``state/residuals.py`` under
``checkpoint_dir/silo_<rank>``. Ranks talk over any transport of
``comm/registry.py`` (``backend`` with ``addresses`` and ``token``).

With ``obs_dir`` every rank writes its own flight log
(``fedml_tpu_torch/obs``) under one shared ``job_id``: the server a
``round`` record a round with its perf record (wire bytes/s, the card's
memory), and a ``silo`` row a reply with the report latency and the
compact counter digest the silo piggybacks on it; each silo its own view
of the round. Observability is a pure observer: the models are bit for
bit those with it off.

Models live on one device (``device``, default CUDA) as state dicts; the
wire carries numpy arrays. All actors of a process share that device, so
one lock serializes every device section, as in the JAX package. Random
bits come from explicit generators on the device, seeded through the
port's ``derive_seed`` chain with the JAX package's tags: uplink
``(977, round, rank)``, downlink ``(1733, broadcast seq)``. Local
training seeds are the simulation's ``round_keys``.

Fault tolerance (``round_deadline_s``): the all-received barrier is taken
against the live silo set (a :class:`SiloLivenessTable` beaten by every
inbound silo message). When the round's deadline passes with at least
``ceil(min_quorum_frac * live)`` reports, the round closes with the
weighted partial aggregate over the reporters and the silos that did not
report are evicted; below quorum the deadline extends, at most
``max_deadline_extensions`` times a round before the schedule fails
loudly (:class:`~fedml_tpu_torch.control.SchedulingStallError`). The
deadline is a self-addressed TIMEOUT message that rides the receive loop,
so the server's state machine stays on one thread. With ``heartbeat_s``
idle silos beat the server and, after ``3 * heartbeat_s`` of server
silence, send JOIN; the server re-admits an evicted silo with a
full-precision resync of the mirror, so the compressed downlink chain
stays coherent. ``fault_plan`` wraps every endpoint in the seeded fault
injector (``comm/faults.py``).

With a WAN world (``wan``, or ``wan_trace`` / ``wan_profiles`` /
``wan_round_s``; ``fedml_tpu_torch/wan``) the population dynamics drive
the same protocol: the server samples availability-restricted cohorts,
evicts trace-offline silos at the deadline, answers a trace-offline
silo's JOIN with BACKPRESSURE and re-admits it at the first round
boundary where its device is online again, with a full-precision
rebase; each silo's agent drops the broadcasts of rounds its device is
offline (and goes dark) and sleeps its client's profiled report delay
before replying. The ``wan_*`` counters land in the timer.

The elastic control plane (``fedml_tpu_torch/control``):
``server_checkpoint_dir`` snapshots the server's whole round-schedule
state at every round boundary and deadline extension, and appends a
round/cohort ledger line at every close; a killed and restarted server
restores the newest snapshot and finishes the schedule with the unkilled
run's ledger (and its final model, bit for bit, with the downlink
uncompressed). ``pace_steering`` derives each round's deadline and
quorum from the observed report latencies; ``join_rate_limit``
token-buckets JOIN floods with BACKPRESSURE replies.

Not ported yet, each raising ``NotImplementedError`` when set: serving
(item 23) and the multi-job scheduler hooks (22g) (see ROADMAP Slice D).
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.comm import (ClientManager, Message, ServerManager,
                                  create_comm_manager)
from fedml_tpu_torch.comm.faults import parse_fault_plan
from fedml_tpu_torch.comm.compression import (compress_for_policy,
                                              decompress, is_compressed,
                                              to_numpy, tree_fingerprint,
                                              tree_to_device)
from fedml_tpu_torch.comm.inproc import InProcRouter
from fedml_tpu_torch.comm.policy import resolve_compression
from fedml_tpu_torch.comm.serialization import SharedPayload
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.sampling import (derive_seed, make_generator,
                                           round_keys, sample_clients)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.obs import (build_observability, default_job_id,
                                 endpoint_epoch)
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule,
                                                make_eval, make_local_train,
                                                round_lr_scale,
                                                validate_accum_steps)
from fedml_tpu_torch.utils.device import resolve_device, synchronize
from fedml_tpu_torch.utils.tracing import RoundTimer
from fedml_tpu_torch.utils.watchdog import SiloLivenessTable
from fedml_tpu_torch.wan import build_wan_world, compose_fault_plan

# -- message schema (reference message_define.py) ---------------------------
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_MODEL = 2
MSG_TYPE_S2C_FINISH = 3
MSG_TYPE_C2S_SEND_MODEL = 4
#: the self-addressed deadline tick: the deadline servers' timer posts it,
#: so the state machine stays on the receive thread
MSG_TYPE_ROUND_TIMEOUT = 9
#: a periodic proof of life from an idle silo; every inbound silo message
#: (replies included) also beats the server's liveness table
MSG_TYPE_C2S_HEARTBEAT = 10
#: an evicted or restarted silo asking back in: the server re-admits it
#: with a full-precision resync of the mirror
MSG_TYPE_C2S_JOIN = 11
#: the server refused a JOIN's resync for now (a WAN-deferred JOIN: the
#: silo's device is still offline in the trace; or the JOIN admission
#: bucket is empty); carries
#: ``retry_after_s``, and the silo defers its next JOIN by that long (its
#: heartbeats keep beating)
MSG_TYPE_S2C_JOIN_BACKPRESSURE = 12

MSG_ARG_KEY_MODEL_PARAMS = Message.MSG_ARG_KEY_MODEL_PARAMS
MSG_ARG_KEY_NUM_SAMPLES = Message.MSG_ARG_KEY_NUM_SAMPLES
MSG_ARG_KEY_CLIENT_INDEX = Message.MSG_ARG_KEY_CLIENT_INDEX
MSG_ARG_KEY_ROUND = "round_idx"
#: broadcast sequence number: the silo's held-model version, echoed back
#: on replies so the server knows which base each silo confirmed holding
MSG_ARG_KEY_BCAST_SEQ = "bcast_seq"
MSG_ARG_KEY_BASE_SEQ = "base_seq"
#: structure fingerprint of the silo's held model: a mismatch makes the
#: server broadcast full precision
MSG_ARG_KEY_BASE_FP = "base_fp"
#: JOIN payload: the rounds the (re)joining silo completed before it left
MSG_ARG_KEY_ROUNDS_COMPLETED = "rounds_completed"
#: BACKPRESSURE payload: seconds until the silo may JOIN again
MSG_ARG_KEY_RETRY_AFTER = "retry_after_s"
#: observability piggyback (fedml_tpu_torch/obs): the compact counter
#: digest a silo attaches to its replies when the flight recorder is on;
#: the server turns it into per-silo rows in ITS flight log. Absent in
#: the (default) obs-off wire format.
MSG_ARG_KEY_OBS_DIGEST = "obs_digest"

#: seed-chain tags of the wire's random bits (the JAX package's key tags)
UPLINK_SEED_TAG = 977
DOWNLINK_SEED_TAG = 1733

#: every actor of a process shares one device; one lock around every
#: device section keeps their work from interleaving, as in the JAX
#: package, and makes the shared module template safe for
#: ``functional_call`` (which swaps the module's tensors during a call)
_DEVICE_LOCK = threading.RLock()


def _host_copy(tree):
    """A nest of dicts and lists with tensor leaves as numpy copies on the
    host (a snapshot outlives the tensors it was taken from)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    return tree


def _like(template, value):
    """``value`` (a restored nest of numpy arrays) in ``template``'s shape:
    each tensor leaf on the template's device and dtype, dict keys in the
    template's order. Names and shapes must agree."""
    if isinstance(template, dict):
        if set(value) != set(template):
            raise ValueError(f"snapshot names {sorted(value)} != the "
                             f"server's {sorted(template)}")
        return {k: _like(template[k], value[k]) for k in template}
    if isinstance(template, (list, tuple)):
        if len(value) != len(template):
            raise ValueError(f"snapshot list of {len(value)} != the "
                             f"server's {len(template)}")
        return type(template)(_like(t, v) for t, v in zip(template, value))
    if isinstance(template, torch.Tensor):
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"snapshot shape {arr.shape} != the server's "
                             f"{tuple(template.shape)}")
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=template.device, dtype=template.dtype)
    return value


class FedAvgAggregator:
    """Server state machine: collect worker results, barrier, aggregate.

    Reference: FedAVGAggregator.py, ``add_local_trained_result`` (:44),
    ``check_whether_all_receive`` (:50), ``aggregate`` (:58), seeded
    ``client_sampling`` (:89).

    Aggregation is a streaming in-order prefix fold (the default): as
    each report arrives, the contiguous worker-index prefix is folded into
    a weighted running sum (``pt.tree_weighted_fold_*``), and only
    out-of-order arrivals wait in ``model_dict``. The fold order is always
    ascending worker index, so every arrival order gives a bit-identical
    result.

    A custom ``aggregate_fn(stacked, weights)`` (rules that need the whole
    cohort, or the aggregation kernel's front end
    ``ops.aggregate.tree_weighted_mean_fused``) keeps the buffered close:
    every report waits in ``model_dict`` and the close stacks them in
    worker order and calls ``aggregate_fn`` once, with the f32 weights on
    the reports' device. Either way, when every reporter had an empty
    shard (all weights 0) the round closes with uniform weights instead
    of a 0/0 model.
    """

    def __init__(self, worker_num: int, aggregate_fn=None):
        self.worker_num = worker_num
        #: streaming close: the reports not yet folded (out of order, or
        #: waiting for a positive weight); buffered close: every report
        self.model_dict: Dict[int, Dict[str, torch.Tensor]] = {}
        self.sample_num_dict: Dict[int, float] = {}
        self.flag_client_model_uploaded = [False] * worker_num
        self._aggregate_fn = aggregate_fn
        self._streaming = aggregate_fn is None
        #: the cohort draw's override (the WAN world's availability-
        #: restricted sampler), or None for the seeded stream. It must be
        #: a pure function of its arguments: the silos' prefetch predicts
        #: cohorts from the round index alone
        self.sampler = None
        self._reset_round()

    def add_local_trained_result(self, worker_idx: int, model_params,
                                 sample_num: float) -> None:
        """Record one report and fold the ready prefix (device work: call
        under the device lock)."""
        if self._streaming and worker_idx < self._fold_next:
            # already folded: a transport duplicate carries the same
            # payload, and it cannot be un-folded anyway
            logging.debug("aggregator: duplicate report from folded "
                          "worker %d ignored", worker_idx)
            self.flag_client_model_uploaded[worker_idx] = True
            return
        self.model_dict[worker_idx] = model_params
        self.sample_num_dict[worker_idx] = sample_num
        self.flag_client_model_uploaded[worker_idx] = True
        if sample_num > 0:
            self._any_pos = True
        self.buffered_peak = max(self.buffered_peak, len(self.model_dict))
        if self._streaming:
            self._drain_ready()

    def check_whether_all_receive(self) -> bool:
        if all(self.flag_client_model_uploaded):
            self.flag_client_model_uploaded = [False] * self.worker_num
            return True
        return False

    # -- streaming fold ------------------------------------------------------
    def _fold_in(self, idx: int, weight=None) -> None:
        model = self.model_dict.pop(idx)
        w32 = np.float32(self.sample_num_dict.pop(idx)
                         if weight is None else weight)
        if self._fold_acc is None:
            self._fold_acc = pt.tree_weighted_fold_init(model, w32)
        else:
            self._fold_acc = pt.tree_weighted_fold_step(self._fold_acc,
                                                        model, w32)
        self._fold_total = np.float32(self._fold_total + w32)
        self._fold_count += 1

    def _drain_ready(self) -> None:
        """Fold the contiguous worker-index prefix now in hand; deferred
        until a positive weight is seen (an all-empty round needs every
        report unfolded for the uniform close)."""
        if not self._any_pos:
            return
        while self._fold_next in self.model_dict:
            self._fold_in(self._fold_next)
            self._fold_next += 1

    def _reset_round(self) -> None:
        self.model_dict.clear()
        self.sample_num_dict.clear()
        self.flag_client_model_uploaded = [False] * self.worker_num
        self._fold_acc = None
        #: next contiguous worker index the fold waits for
        self._fold_next = 0
        self._fold_count = 0
        #: f32 running total of the folded weights
        self._fold_total = np.float32(0.0)
        self._any_pos = False
        #: peak len(model_dict) this round (the agg_buffered_peak gauge)
        self.buffered_peak = 0

    def _close_streaming(self):
        """Drain the pending suffix in ascending worker order and
        normalize; resets the round."""
        if self._fold_count == 0 and not self.model_dict:
            raise ValueError("aggregate on an empty round: no reports")
        uniform = self._fold_count == 0 and \
            not any(w > 0 for w in self.sample_num_dict.values())
        for i in sorted(self.model_dict):
            # x * 1.0 is bitwise x: the uniform close is the same fold
            self._fold_in(i, weight=1.0 if uniform else None)
        out = pt.tree_fold_finish(self._fold_acc, self._fold_total)
        self._reset_round()
        return out

    # -- buffered close (custom aggregate_fn) ---------------------------------
    def _close_buffered(self, idxs):
        if not idxs:
            raise ValueError("aggregate on an empty round: no reports")
        models = [self.model_dict[i] for i in idxs]
        weights = np.asarray([self.sample_num_dict[i] for i in idxs],
                             np.float32)
        if weights.sum() <= 0.0:
            # every reporter had an empty shard: a uniform mix, not 0/0
            weights = np.ones_like(weights)
        device = next(iter(models[0].values())).device
        out = self._aggregate_fn(pt.tree_stack(models),
                                 torch.from_numpy(weights).to(device))
        self._reset_round()
        return out

    def aggregate(self):
        """Close the round over every worker; resets the round."""
        if self._streaming:
            return self._close_streaming()
        return self._close_buffered(list(range(self.worker_num)))

    def aggregate_available(self):
        """The weighted mean over whichever workers reported this round,
        then reset: the straggler-tolerant close. Equal to
        :meth:`aggregate` when every worker reported."""
        if self._streaming:
            return self._close_streaming()
        return self._close_buffered(sorted(self.model_dict))

    def reported_set(self) -> set:
        """Workers whose report is in hand for the open round."""
        return set(range(self._fold_next)) | set(self.model_dict)

    def has_reported(self, worker_idx: int) -> bool:
        return worker_idx < self._fold_next or worker_idx in self.model_dict

    def received_count(self) -> int:
        """Reports in hand for the open round."""
        return self._fold_count + len(self.model_dict)

    def client_sampling(self, round_idx: int, client_num_in_total: int,
                        client_num_per_round: int) -> np.ndarray:
        if self.sampler is not None:
            return self.sampler(round_idx, client_num_in_total,
                                client_num_per_round)
        return sample_clients(round_idx, client_num_in_total,
                              client_num_per_round)


class FedAvgServerManager(ServerManager):
    """Round-based cross-silo server, with the strict all-received barrier
    by default.

    ``checkpoint_mgr`` (a ``utils.checkpoint.CheckpointManager``) saves
    :meth:`_checkpoint_state` after every round, keyed by rounds
    completed; with ``resume`` the server restores the latest one and
    restarts the protocol at its round. Sampling and every random stream
    derive from the round index, so the continuation is the uninterrupted
    run's, bit for bit, when the downlink is not compressed (a resumed
    federation starts without the silos' mirror, so its first broadcast is
    full precision).

    Fault tolerance (``round_deadline_s``): the barrier is taken against
    the live set; at the deadline, with at least ``ceil(min_quorum_frac *
    live)`` reports, the round closes with the weighted partial aggregate
    and the live silos that did not report are evicted (their
    ``_worker_base`` is forgotten, and the mass of a reply that never
    arrived, error-feedback residual included, is lost). Broadcasts go to
    the live set only; an evicted silo comes back through JOIN and a
    full-precision resync of the mirror. Below quorum the deadline extends,
    at most ``max_deadline_extensions`` times a round (``None``: forever),
    each extension a ``deadline_extension`` anomaly in the flight log.
    Without ``round_deadline_s`` the strict barrier is unchanged.

    The control plane (``fedml_tpu_torch/control``, all off by default):
    ``server_ckpt`` (a ``ServerControlCheckpointer`` or its
    ``AsyncCheckpointWriter``) takes a ledger line and a snapshot at every
    round boundary and a snapshot at every deadline extension, and a
    fresh server restores the newest snapshot before its first broadcast;
    ``pace`` (a ``PaceSteerer``) sets each round's deadline and quorum
    fraction; ``join_admission`` (a ``JoinAdmissionController``) answers
    a JOIN past its token bucket with BACKPRESSURE.

    ``device_gate`` replaces the process-wide device lock around every
    device section: the multi-job scheduler passes the job's
    ``JobDeviceGate`` (``sched/interleave.py``), so tenants take turns on
    the one card by their shares."""

    def __init__(self, rank: int, size: int, com_manager,
                 aggregator: FedAvgAggregator, comm_round: int,
                 client_num_in_total: int, global_model,
                 on_round_done=None, checkpoint_mgr=None,
                 resume: bool = False, compression=None,
                 timer: Optional[RoundTimer] = None,
                 round_deadline_s: Optional[float] = None,
                 min_quorum_frac: float = 0.5,
                 server_ckpt=None, pace=None, join_admission=None,
                 max_deadline_extensions: Optional[int] = 25,
                 device_gate=None, wan=None):
        super().__init__(rank, size, com_manager)
        self._device_lock = (device_gate if device_gate is not None
                             else _DEVICE_LOCK)
        self.aggregator = aggregator
        self.comm_round = comm_round
        self.client_num_in_total = client_num_in_total
        #: the exact global model (state dict on the device)
        self.global_model = global_model
        self.device = next(iter(global_model.values())).device
        self.round_idx = 0
        self.on_round_done = on_round_done
        self.worker_num = size - 1
        self.checkpoint_mgr = checkpoint_mgr
        self.round_timer = timer if timer is not None else RoundTimer()
        #: cumulative transport bytes already credited into the timer
        self._wire_credited_up = 0
        self._wire_credited_down = 0
        #: the cohort of the open round (its round record)
        self._round_cohort: Optional[List[int]] = None
        #: the observability bundle (obs.Observability) or None: off
        self.obs = None
        #: when the open round's broadcast went out: the origin of every
        #: reply's report latency
        self._bcast_at: Optional[float] = None
        # -- fault tolerance (liveness, deadline, eviction, rejoin) ---------
        if not 0.0 < min_quorum_frac <= 1.0:
            raise ValueError(f"min_quorum_frac must be in (0, 1], got "
                             f"{min_quorum_frac}")
        self.round_deadline_s = round_deadline_s
        self.min_quorum_frac = min_quorum_frac
        #: deadline eviction on (False: the strict barrier; the quorum
        #: server reuses the timer with its own close policy)
        self._evict_on_deadline = bool(round_deadline_s
                                       and round_deadline_s > 0)
        self.liveness = SiloLivenessTable(range(self.worker_num))
        #: one {round, reported, live, partial} record a round (FT mode)
        self.live_history: List[Dict] = []
        self.ft_counters: Dict[str, int] = defaultdict(int)
        #: the armed deadline timer; arming, cancelling and ``finish`` take
        #: the lock, so no timer outlives the server
        self._timer: Optional[threading.Timer] = None
        self._timer_lock = threading.Lock()
        self._finished = False
        #: worker -> round of its last JOIN resync: one full-precision
        #: resync a silo a round, however often it retries JOIN
        self._resynced_round: Dict[int, int] = {}
        self._max_extensions = max_deadline_extensions
        self._extensions_this_round = 0
        #: set (with a FINISH sweep) when the schedule cannot make
        #: progress; launch_federation raises it
        self.scheduling_error: Optional[Exception] = None
        # -- the control plane (fedml_tpu_torch/control), None: off ---------
        self._server_ckpt = server_ckpt
        self._pace = pace
        self._join_admission = join_admission
        #: checkpoints, restores, steering adjustments, throttled JOINs,
        #: skipped resync latencies; rolled into the timer as ``cp_*``
        self.cp_counters: Dict[str, int] = defaultdict(int)
        #: the global model's version for the snapshot serializer, bumped
        #: at every close and restore (the serializer reuses its bytes
        #: while it is unchanged)
        self._model_version = 0
        #: (model version, host copy): a mid-round snapshot re-captures
        #: the unchanged global model from here instead of the device
        self._gm_capture_cache = None
        self._control_restored = False
        self._restore_lock = threading.Lock()
        # -- downlink compression state (comm/policy.py) --------------------
        self._policy = resolve_compression(compression)
        self._bcast_seq = -1
        #: the model every silo holds: advanced by exactly what each
        #: broadcast decodes to, so with downlink compression it trails the
        #: exact global by the not-yet-sent mass (implicit error feedback)
        self._mirror = None
        self._mirror_fp = None
        #: worker -> (held seq, held structure fp) from its last reply
        self._worker_base: Dict[int, tuple] = {}
        # -- the WAN world (fedml_tpu_torch/wan), None: off -----------------
        #: a pure function of (seed, round), so it is not checkpointed: a
        #: resumed server rebuilds the same dynamics from its arguments
        self._wan = wan
        if wan is not None:
            self.aggregator.sampler = wan.sample_cohort
        #: worker -> (round, deferrals of its JOIN in that round): the
        #: anti-starvation valve's count (WanWorld
        #: .max_join_deferrals_per_round)
        self._wan_join_deferrals: Dict[int, tuple] = {}
        #: workers whose JOIN was deferred while their device was offline,
        #: re-admitted together at the first round boundary where the
        #: trace has them online (:meth:`_wan_admit_pending`), so the
        #: rejoin round is a pure function of the trace
        self._wan_pending_joins: set = set()
        if checkpoint_mgr is not None and resume:
            restored = checkpoint_mgr.restore_latest(
                self._checkpoint_state())
            if restored:
                state, meta = restored
                self._load_state(state)
                self.round_idx = int(meta["round_idx"])

    # the FedOpt server extends the round state with its optimizer state
    def _checkpoint_state(self):
        return {"variables": self.global_model}

    def _load_state(self, state) -> None:
        self.global_model = state["variables"]

    def _aggregate_round(self, partial: bool = False):
        """Close the round: the sample-weighted average (over whichever
        workers reported when ``partial``); FedOpt steps its server
        optimizer on it."""
        return (self.aggregator.aggregate_available() if partial
                else self.aggregator.aggregate())

    # -- the control plane: the round schedule's snapshot and restore -------
    # (fedml_tpu_torch/control/checkpoint.py; the field manifest is
    # control/manifest.py)
    def _capture_extra(self, state: Dict) -> None:
        """Subclass hook: add a flavor's round state (FedOpt's optimizer,
        the quorum server's partial rounds) to the snapshot."""

    def _restore_extra(self, state: Dict) -> None:
        """Subclass hook: restore what :meth:`_capture_extra` added."""

    def _capture_control_state(self) -> Dict:
        """The whole round-schedule state as host data (numpy arrays,
        dicts, lists, scalars): everything a restarted server needs to
        resume mid-schedule. ``round_idx`` is also the sampling cursor:
        cohorts and client seeds are pure functions of (seed, round)."""
        agg = self.aggregator
        with self._device_lock:  # device -> host copies
            cache = self._gm_capture_cache
            if cache is not None and cache[0] == self._model_version:
                gm = cache[1]
            else:
                gm = _host_copy(self.global_model)
                self._gm_capture_cache = (self._model_version, gm)
            # the streaming fold holds only the reports not folded yet;
            # the folded prefix rides in agg_fold
            pending = {str(w): _host_copy(m)
                       for w, m in agg.model_dict.items()}
            fold_acc = (_host_copy(agg._fold_acc)
                        if agg._fold_acc is not None else None)
            mirror = (_host_copy(self._mirror)
                      if self._mirror is not None else None)
        state = {
            "round_idx": int(self.round_idx),
            "comm_round": int(self.comm_round),
            "worker_num": int(self.worker_num),
            "bcast_seq": int(self._bcast_seq),
            "evict_on_deadline": bool(self._evict_on_deadline),
            "global_model": gm,
            "mirror": mirror,
            "mirror_fp": self._mirror_fp,
            "worker_base": {str(w): [int(s), str(fp)]
                            for w, (s, fp) in self._worker_base.items()},
            "live": sorted(int(w) for w in self.liveness.live_workers()),
            "evictions": int(self.liveness.evictions),
            "rejoins": int(self.liveness.rejoins),
            "latency_window": self.liveness.report_latencies.values(),
            "pending_models": pending,
            "pending_weights": {str(w): float(v)
                                for w, v in agg.sample_num_dict.items()},
            # the fold in mid-round: its running sum, the contiguous
            # prefix bound and the f32 weight total (exact through a
            # float64), so a restored server closes on the unkilled bits
            "agg_fold": {
                "next": int(agg._fold_next),
                "count": int(agg._fold_count),
                "total": float(agg._fold_total),
                "any_pos": bool(agg._any_pos),
                "acc": fold_acc,
            },
            "uploaded_flags": [bool(f)
                               for f in agg.flag_client_model_uploaded],
            "live_history": self.live_history,
            "ft_counters": {k: int(v) for k, v in self.ft_counters.items()},
            "cp_counters": {k: int(v) for k, v in self.cp_counters.items()},
            "resynced_round": {str(k): int(v)
                               for k, v in self._resynced_round.items()},
            "round_deadline_s": (float(self.round_deadline_s)
                                 if self.round_deadline_s else None),
            "min_quorum_frac": float(self.min_quorum_frac),
            "extensions_this_round": int(self._extensions_this_round),
            "round_cohort": ([int(i) for i in self._round_cohort]
                             if self._round_cohort is not None else None),
            "pace": (self._pace.state() if self._pace is not None
                     else None),
        }
        self._capture_extra(state)
        return state

    def _restore_control_state(self, state: Dict) -> None:
        if int(state["worker_num"]) != self.worker_num \
                or int(state["comm_round"]) != self.comm_round:
            raise ValueError(
                f"server snapshot is for a {state['worker_num']}-silo/"
                f"{state['comm_round']}-round schedule; this launch is "
                f"{self.worker_num}-silo/{self.comm_round}-round: refusing "
                "a silently wrong resume (point server_checkpoint_dir at a "
                "fresh directory)")
        template = self.global_model
        with self._device_lock:  # host -> device copies
            self.global_model = _like(template, state["global_model"])
            self._mirror = (_like(template, state["mirror"])
                            if state["mirror"] is not None else None)
            pending = {int(w): _like(template, m)
                       for w, m in state["pending_models"].items()}
            fold = state["agg_fold"]
            fold_acc = (_like(template, fold["acc"])
                        if fold["acc"] is not None else None)
        self.round_idx = int(state["round_idx"])
        self._bcast_seq = int(state["bcast_seq"])
        self._evict_on_deadline = bool(state["evict_on_deadline"])
        self._mirror_fp = state["mirror_fp"]
        # worker_base is captured for forensics but not restored: whether
        # each silo still holds the base it reported before the kill is
        # value-level staleness the fingerprint cannot see, so the first
        # broadcast after a restore rebases at full precision
        self._worker_base = {}
        live = {int(w) for w in state["live"]}
        for w in range(self.worker_num):
            if w not in live:
                self.liveness.evict(w)
        self.liveness.evictions = int(state["evictions"])
        self.liveness.rejoins = int(state["rejoins"])
        self.liveness.report_latencies.load(state["latency_window"])
        agg = self.aggregator
        agg.model_dict = pending
        agg.sample_num_dict = {int(w): float(v)
                               for w, v in state["pending_weights"].items()}
        agg.flag_client_model_uploaded = [
            bool(f) for f in state["uploaded_flags"]]
        agg._fold_next = int(fold["next"])
        agg._fold_count = int(fold["count"])
        agg._fold_total = np.float32(fold["total"])
        agg._any_pos = bool(fold["any_pos"])
        agg._fold_acc = fold_acc
        agg.buffered_peak = len(agg.model_dict)
        self.live_history = list(state["live_history"])
        self.ft_counters.update(
            {k: int(v) for k, v in state["ft_counters"].items()})
        self.cp_counters.update(
            {k: int(v) for k, v in state["cp_counters"].items()})
        self._resynced_round = {
            int(k): int(v) for k, v in state["resynced_round"].items()}
        rd = state["round_deadline_s"]
        self.round_deadline_s = float(rd) if rd is not None else None
        self.min_quorum_frac = float(state["min_quorum_frac"])
        self._extensions_this_round = int(state["extensions_this_round"])
        rc = state["round_cohort"]
        self._round_cohort = ([int(i) for i in rc]
                              if rc is not None else None)
        if self._pace is not None:
            self._pace.load_state(state["pace"])
        # the restored model is a new object: the next snapshot captures
        # and serializes it afresh
        self._gm_capture_cache = None
        self._model_version += 1
        self._restore_extra(state)

    def _save_control_snapshot(self) -> None:
        """Snapshot the control state (a no-op without a checkpointer). A
        failed save warns loudly and the schedule goes on, unprotected.

        With the async writer the round thread pays only the capture
        (``cp_capture_ms``); serialization, fsync and publish
        (``cp_flush_ms``, the last completed flush) run on the writer.
        With ``checkpoint_sync`` both run here."""
        if self._server_ckpt is None:
            return
        try:
            t0 = time.perf_counter()
            state = self._capture_control_state()
            # the model's bytes change only at a close or a restore, the
            # mirror's only when a broadcast advances it
            versions = {"global_model": int(self._model_version),
                        "mirror": int(self._bcast_seq)}
            t1 = time.perf_counter()
            self._server_ckpt.save(state, versions=versions)
            t2 = time.perf_counter()
            self.cp_counters["checkpoints"] += 1
            tm = self.round_timer
            tm.gauge("cp_capture_ms", (t1 - t0) * 1e3)
            stats = getattr(self._server_ckpt, "stats", None)
            tm.gauge("cp_flush_ms", stats()["last_flush_ms"]
                     if stats is not None else (t2 - t1) * 1e3)
        except Exception:
            logging.warning(
                "server control snapshot failed at round %d: the schedule "
                "continues WITHOUT failover protection", self.round_idx,
                exc_info=True)

    def _maybe_restore_control_state(self) -> None:
        """The one-shot failover restore, from the top of both :meth:`run`
        (before the receive loop drains the JOINs and heartbeats of a
        waiting fleet) and :meth:`send_init_msg`, whichever the launcher
        reaches first. Not in ``__init__``: the subclasses install their
        own round state after ``super().__init__``, and the restore must
        win over every construction default."""
        if self._server_ckpt is None:
            return
        with self._restore_lock:
            if self._control_restored:
                return
            snap = self._server_ckpt.load_latest()
            if snap is not None:
                self._restore_control_state(snap)
                self.cp_counters["restores"] += 1
                logging.warning(
                    "server control plane RESTORED from %s at round %d "
                    "(live=%s, %d pending replies): resuming the schedule "
                    "mid-flight", self._server_ckpt.directory,
                    self.round_idx, sorted(self.liveness.live_workers()),
                    self.aggregator.received_count())
            # latched after success: a refused restore raises again on
            # the other entry point's thread instead of going on from 0
            self._control_restored = True

    def run(self) -> None:
        self._maybe_restore_control_state()
        super().run()

    def send_init_msg(self) -> None:
        self._maybe_restore_control_state()
        if self.round_idx >= self.comm_round:
            # resumed from the checkpoint of a finished run
            self._finish_federation()
            return
        idxs = self.aggregator.client_sampling(
            self.round_idx, self.client_num_in_total, self.worker_num)
        # the mirror is unset, so the first broadcast (of a resumed run
        # too) is full precision
        self._broadcast_model(MSG_TYPE_S2C_INIT_CONFIG, idxs)
        self._arm_deadline()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEND_MODEL,
            self.handle_message_receive_model_from_client)
        self.register_message_receive_handler(
            MSG_TYPE_ROUND_TIMEOUT, self.handle_round_timeout)
        self.register_message_receive_handler(
            MSG_TYPE_C2S_HEARTBEAT, self.handle_message_heartbeat)
        self.register_message_receive_handler(
            MSG_TYPE_C2S_JOIN, self.handle_message_join)

    def receive_message(self, msg_type: int, msg: Message) -> None:
        # every inbound silo message is proof of life: a silo in local
        # training proves it with its reply, an idle one with heartbeats
        sender = msg.get_sender_id()
        if sender != self.rank:
            self.liveness.beat(sender - 1)
        super().receive_message(msg_type, msg)

    # -- the deadline timer --------------------------------------------------
    def _arm_deadline(self) -> None:
        """Post a self-addressed TIMEOUT tick ``round_deadline_s`` from now
        (a no-op without a deadline or after ``finish``). The timer thread
        touches no protocol state: the tick rides the receive loop."""
        if not self.round_deadline_s:
            return
        round_idx = self.round_idx

        def fire():
            tick = Message(MSG_TYPE_ROUND_TIMEOUT, self.rank, self.rank)
            tick.add(MSG_ARG_KEY_ROUND, round_idx)
            try:
                self.send_message(tick)
            except OSError as exc:  # the backend is already shut down
                logging.debug("round-%d deadline tick not delivered (%r)",
                              round_idx, exc)

        with self._timer_lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            if self._finished:
                return
            self._timer = threading.Timer(self.round_deadline_s, fire)
            self._timer.daemon = True
            self._timer.start()

    def _cancel_deadline(self, final: bool = False) -> None:
        """Cancel the armed tick; ``final`` also refuses every later arm."""
        with self._timer_lock:
            self._finished = self._finished or final
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def finish(self) -> None:
        self._cancel_deadline(final=True)
        super().finish()

    def _finish_federation(self) -> None:
        """FINISH every silo (evicted ones too: a send to a dead peer is
        logged, not fatal) and stop the server loop."""
        for worker in range(1, self.size):
            try:
                self.send_message(
                    Message(MSG_TYPE_S2C_FINISH, self.rank, worker))
            except OSError as exc:
                logging.warning("FINISH to silo %d failed (%r): the peer "
                                "is gone", worker, exc)
        self.finish()
        # the close barrier: the async writer publishes its pending
        # snapshot and the ledger is fsynced before the launcher (or the
        # extension cap's error path) lets the process end
        if self._server_ckpt is not None:
            try:
                self._server_ckpt.close()
            except Exception:
                logging.warning("checkpoint close barrier failed",
                                exc_info=True)
            # the run's fsyncs, the close's included
            raw = getattr(self._server_ckpt, "inner", self._server_ckpt)
            self.round_timer.count("cp_fsync_total", int(raw.fsync_count))
            self.round_timer.count("cp_ledger_fsyncs",
                                   int(raw.ledger_fsync_count))

    def _fail_schedule(self, reason: str) -> None:
        """A terminal scheduling failure: snapshot the final state, FINISH
        every silo and keep the error for the launcher to raise."""
        from fedml_tpu_torch.control import SchedulingStallError
        self.scheduling_error = SchedulingStallError(reason)
        logging.error("%s", self.scheduling_error)
        self._save_control_snapshot()
        self._finish_federation()

    # -- downlink compression (comm/policy.py, comm/compression.py) ---------
    def _silos_in_sync(self) -> bool:
        """True iff some silo has confirmed a base and every reported (seq,
        fingerprint) matches the mirror: a shared compressed broadcast is
        only decodable when every silo holds the same mirror. A silo that
        missed a broadcast (a deadline straggler, a dropped frame) reports
        an older seq and costs one full-precision rebase."""
        if not self._worker_base:
            return False
        for worker, (seq, fp) in self._worker_base.items():
            if fp != self._mirror_fp:
                logging.warning(
                    "silo %d reports base fingerprint %s but the mirror is "
                    "%s: falling back to a full-precision broadcast",
                    worker + 1, fp, self._mirror_fp)
                return False
            if seq != self._bcast_seq:
                return False
        return True

    def _encode_broadcast(self):
        """The broadcast payload: full precision the first time and
        whenever :meth:`_silos_in_sync` fails, else a compressed delta
        against the mirror, which then advances by exactly what the silos
        will decode (downlink error feeds back implicitly)."""
        pol = self._policy
        in_sync = (pol.downlink_enabled and self._mirror is not None
                   and self._silos_in_sync())
        self._bcast_seq += 1
        if not in_sync:
            with self._device_lock:
                full = to_numpy(self.global_model)
            # the global model's tensors are never written in place, so
            # the mirror may share them
            self._mirror = self.global_model
            self._mirror_fp = tree_fingerprint(full)
            return full
        t0 = time.perf_counter()
        with self._device_lock:
            gen = make_generator(derive_seed(DOWNLINK_SEED_TAG,
                                             self._bcast_seq), self.device)
            payload, _ = compress_for_policy(self.global_model, self._mirror,
                                             None, gen, pol)
            self._mirror = decompress(payload, self._mirror)
            synchronize(self.device)
        self.round_timer.gauge("codec_encode_ms",
                               (time.perf_counter() - t0) * 1e3)
        return payload

    def _broadcast_model(self, msg_type: int, idxs) -> None:
        """One shared payload (full or mirror delta) to every silo; with
        deadline eviction to the live set only, a peer whose send fails
        evicted instead of ending the server loop."""
        tm = self.round_timer
        # the flight-recorder round boundary: snapshot the counters so
        # _close_round's end_round attributes deltas to THIS round, and
        # open any anomaly-armed one-shot profile window
        tm.begin_round(self.round_idx)
        if self.obs is not None:
            self.obs.round_begin(self.round_idx)
        with tm.phase("bcast_encode"):
            payload = self._encode_broadcast()
        self._round_cohort = [int(idxs[w - 1]) for w in range(1, self.size)]
        live = self.liveness.live_workers()
        # one encode for the whole fan-out: each per-peer frame splices
        # the cached buffers and adds only its envelope keys
        shared = SharedPayload(payload)
        msgs = []
        for worker in range(1, self.size):
            if self._evict_on_deadline and (worker - 1) not in live:
                continue
            msg = Message(msg_type, self.rank, worker)
            msg.add(MSG_ARG_KEY_MODEL_PARAMS, shared)
            msg.add(MSG_ARG_KEY_CLIENT_INDEX, int(idxs[worker - 1]))
            msg.add(MSG_ARG_KEY_ROUND, self.round_idx)
            msg.add(MSG_ARG_KEY_BCAST_SEQ, self._bcast_seq)
            msgs.append(msg)
        t0 = time.monotonic()
        self._bcast_at = t0
        stats = self.com_manager.broadcast(msgs, on_error=(
            self._on_broadcast_send_error if self._evict_on_deadline
            else None))
        tm.gauge("bcast_fanout_ms", (time.monotonic() - t0) * 1e3)
        if stats is not None:  # a duck-typed endpoint may return none
            tm.gauge("send_queue_depth", stats["max_queue_depth"])

    def _on_broadcast_send_error(self, worker_rank: int, exc) -> None:
        """A peer's broadcast failed after its transport retries: evict it
        (may run on a writer thread; the table locks itself)."""
        if self.liveness.evict(worker_rank - 1):
            self._worker_base.pop(worker_rank - 1, None)
            logging.warning(
                "broadcast to silo %d failed after transport retries (%r): "
                "evicted from the live set; it re-admits via JOIN",
                worker_rank, exc)

    def _note_worker_base(self, msg: Message) -> None:
        params = msg.get_params()
        if MSG_ARG_KEY_BASE_FP in params:
            self._worker_base[msg.get_sender_id() - 1] = (
                int(params.get(MSG_ARG_KEY_BASE_SEQ, -1)),
                params[MSG_ARG_KEY_BASE_FP])

    def _decode_model_payload(self, payload):
        """Compressed replies rebuild against the mirror (the model the
        silos hold); full-precision replies are uploaded as they are."""
        if not is_compressed(payload):
            return tree_to_device(payload, self.device)
        base = self._mirror if self._mirror is not None else self.global_model
        return decompress(payload, base)

    def _report_latency(self, msg: Message, worker: int) -> None:
        """The reply's report latency into the liveness table (a resync's
        reply measures the outage, not the silo's pace, and is left out),
        and with observability on the per-silo flight row with the digest
        the silo piggybacked."""
        latency = (time.monotonic() - self._bcast_at
                   if self._bcast_at is not None else None)
        if latency is not None:
            if self._resynced_round.get(worker) == self.round_idx:
                # kept out of the steering evidence: a flap burst's worth
                # would inflate the steered deadline for a window's width
                self.cp_counters["resync_latency_skips"] += 1
            else:
                self.liveness.observe_report_latency(worker, latency)
        if self.obs is None:
            return
        row = {"kind": "silo", "round": int(self.round_idx),
               "silo_rank": int(worker + 1), "event": "reply"}
        digest = msg.get_params().get(MSG_ARG_KEY_OBS_DIGEST)
        if digest is not None:
            row["digest"] = digest
        if latency is not None:
            row["report_latency_s"] = round(latency, 6)
        self.obs.recorder.append(row)

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        worker = msg.get_sender_id() - 1
        self._note_worker_base(msg)
        if self._evict_on_deadline:
            r = msg.get_params().get(MSG_ARG_KEY_ROUND, self.round_idx)
            if r != self.round_idx:
                # a straggler's reply to a closed round is stale against
                # the advanced global: discard it (the silo stays live)
                self.ft_counters["stale_replies"] += 1
                return
            if self.liveness.admit(worker):
                logging.info("silo %d re-admitted on a live round-%d reply",
                             worker + 1, r)
        self._report_latency(msg, worker)
        tm = self.round_timer
        try:
            with self._device_lock, tm.phase("decode"):
                payload = self._decode_model_payload(
                    msg.get(MSG_ARG_KEY_MODEL_PARAMS))
                synchronize(self.device)
        except (ValueError, KeyError):
            if not self._evict_on_deadline:
                raise
            # a corrupted frame the payload guards refused (a structure
            # fingerprint, a count or an index out of range; a missing
            # field): drop the reply, poison the silo's reported base so
            # the next broadcast is full precision, and let the deadline
            # close the round. A kernel's or the card's error is not a
            # frame's: it propagates and fails the launch
            self.ft_counters["corrupt_frames"] += 1
            self._worker_base[worker] = (-2, "corrupt-frame")
            logging.warning(
                "silo %d round-%d reply failed to decode: dropping the "
                "reply and forcing a full-precision rebase", worker + 1,
                self.round_idx, exc_info=True)
            return
        t0 = time.monotonic()
        with self._device_lock, tm.phase("fold"):
            self.aggregator.add_local_trained_result(
                worker, payload, msg.get(MSG_ARG_KEY_NUM_SAMPLES))
            synchronize(self.device)
        tm.gauge("agg_fold_ms", (time.monotonic() - t0) * 1e3)
        if self._evict_on_deadline:
            reported = self.aggregator.reported_set()
            if self.liveness.live_workers() <= reported:
                self._close_round(partial=len(reported) < self.worker_num)
            return
        if self.aggregator.check_whether_all_receive():
            self._close_round()

    def _credit_wire_bytes(self) -> None:
        """Credit the endpoint's cumulative byte counters into the timer as
        deltas since the last credit (every round close, and once more
        after FINISH)."""
        tm = self.round_timer
        sent = int(getattr(self.com_manager, "bytes_sent", 0))
        recv = int(getattr(self.com_manager, "bytes_received", 0))
        d_down, self._wire_credited_down = (sent - self._wire_credited_down,
                                            sent)
        d_up, self._wire_credited_up = (recv - self._wire_credited_up, recv)
        if d_down:
            tm.count("comm_bytes_down", d_down)
        if d_up:
            tm.count("comm_bytes_up", d_up)

    def _close_round(self, partial: bool = False) -> None:
        """Aggregate (in full, or the weighted partial close), evaluate,
        then broadcast the next round or FINISH. Shared by the strict
        barrier, the deadline close and the quorum server."""
        self._cancel_deadline()
        tm = self.round_timer
        reported = sorted(self.aggregator.reported_set())
        live = sorted(self.liveness.live_workers())
        if self._evict_on_deadline:
            self.live_history.append({"round": self.round_idx,
                                      "reported": reported, "live": live,
                                      "partial": bool(partial)})
            if partial:
                self.ft_counters["partial_rounds"] += 1
        buffered_peak = self.aggregator.buffered_peak
        t0 = time.monotonic()
        with self._device_lock, tm.phase("fold"):
            self.global_model = self._aggregate_round(partial=partial)
            synchronize(self.device)
        self._model_version += 1
        tm.gauge("agg_fold_ms", (time.monotonic() - t0) * 1e3)
        tm.gauge("agg_buffered_peak", buffered_peak)
        if self.on_round_done is not None:
            with tm.phase("eval"):
                self.on_round_done(self.round_idx, self.global_model)
        # wire bytes are credited as deltas since the last close FIRST, so
        # the round record's counters are this round's traffic (the perf
        # record's wire bytes/s derive from exactly these)
        self._credit_wire_bytes()
        extra = {
            "cohort": self._round_cohort,
            "reported": [int(w) for w in reported],
            "live": [int(w) for w in live],
            "partial": bool(partial),
            "evictions": int(self.liveness.evictions),
            "rejoins": int(self.liveness.rejoins),
            "joins_throttled": int(self.cp_counters["joins_throttled"]),
            "deadline_s": (float(self.round_deadline_s)
                           if self.round_deadline_s else None)}
        if self._wan is not None:
            # the world's sampling counters into THIS round's delta, then
            # the population-scale churn estimate (the mass JOIN wave
            # against the shadow admission bucket), all pure functions of
            # (trace seed, round)
            for k, v in self._wan.drain_counters().items():
                tm.count(k, v)
            joins, leaves, throttled = self._wan.mass_churn(self.round_idx)
            if joins:
                tm.count("wan_mass_joins", joins)
            if leaves:
                tm.count("wan_mass_leaves", leaves)
            if throttled:
                tm.count("wan_mass_join_throttled", throttled)
            frac = self._wan.available_frac(self.round_idx)
            if frac is not None:
                tm.gauge("wan_available_frac", frac)
                extra["wan_available_frac"] = round(frac, 4)
        rec = tm.end_round(self.round_idx, extra=extra)
        if self.obs is not None:
            # the server derives wire bytes/s and the card's memory per
            # round (MFU stays silo-side: the server only aggregates)
            self.obs.round_end(self.round_idx,
                               rec["duration_s"] if rec else None,
                               record=rec)
            # group-commit fsyncs since the last close (credited after
            # end_round, so they roll into the NEXT round's delta)
            batches = self.obs.recorder.pop_fsync_batches()
            if batches:
                tm.count("obs_fsync_batches", batches)
        deadline_used = self.round_deadline_s
        self.round_idx += 1
        if self.checkpoint_mgr is not None:
            with self._device_lock, tm.phase("checkpoint"):
                self.checkpoint_mgr.save(self.round_idx,
                                         self._checkpoint_state())
        if self._pace is not None and self.round_deadline_s:
            self._steer(len(reported), len(live) if self._evict_on_deadline
                        else self.worker_num, deadline_used)
        # the new round enters with a full extension budget, before the
        # boundary snapshot: a restored server must not start the next
        # round charged with this one's extensions
        self._extensions_this_round = 0
        if self._server_ckpt is not None:
            # the durable boundary: the ledger line first, the snapshot
            # second (a crash between them closes this round again after
            # the restore, and readers keep the last row of a round)
            self._server_ckpt.append_ledger({
                "round": self.round_idx - 1,
                "cohort": self._round_cohort,
                "reported": reported,
                "partial": bool(partial),
                "deadline_s": deadline_used})
            self._save_control_snapshot()
            # snapshots the writer's newest-wins slot skipped since the
            # last close
            pop = getattr(self._server_ckpt, "pop_coalesced", None)
            coalesced = pop() if pop is not None else 0
            if coalesced:
                tm.count("cp_writer_queue_coalesced", coalesced)
        if self.round_idx == self.comm_round:
            self._finish_federation()
            return
        self._wan_admit_pending()
        idxs = self.aggregator.client_sampling(
            self.round_idx, self.client_num_in_total, self.worker_num)
        self._broadcast_model(MSG_TYPE_S2C_SYNC_MODEL, idxs)
        self._arm_deadline()

    def _steer(self, reported: int, live: int, deadline_used) -> None:
        """Pace steering at a round boundary: the next round's deadline and
        quorum fraction from the report-latency window and the recent
        participation (``control/pace.py``)."""
        self._pace.observe_round(reported, max(1, live))
        latencies = self.liveness.report_latencies
        new_d = self._pace.next_deadline(latencies)
        new_q = self._pace.next_quorum_frac()
        if new_d != self.round_deadline_s or new_q != self.min_quorum_frac:
            self.cp_counters["deadline_adjustments"] += 1
            self.round_timer.gauge("cp_steered_deadline_s", new_d)
            logging.info(
                "pace steering: round %d deadline %.3fs -> %.3fs, quorum "
                "frac %.3f -> %.3f (p90 report latency %s)",
                self.round_idx, deadline_used or 0.0, new_d,
                self.min_quorum_frac, new_q, latencies.quantile(0.9))
        self.round_deadline_s = new_d
        self.min_quorum_frac = new_q

    def _wan_admit_pending(self) -> None:
        """Re-admit, at a round boundary, the silos whose JOIN was deferred
        while their device was offline and whose trace is online at the
        new round, so the rejoin round is a pure function of the trace
        seed, not of a race between JOIN retries and the other replies.
        The admitted silo rides the next broadcast; its reported base is
        poisoned, so that broadcast is full precision (one full frame a
        rejoin, as the JOIN resync)."""
        if self._wan is None or not self._wan_pending_joins:
            return
        for worker in sorted(self._wan_pending_joins):
            if not self._wan.silo_online(worker + 1, self.round_idx):
                continue
            self._wan_pending_joins.discard(worker)
            self.liveness.admit(worker)
            self._worker_base[worker] = (-3, "wan-rejoin")
            # its first reply measures the outage, not its pace
            self._resynced_round[worker] = self.round_idx
            logging.info(
                "silo %d re-admitted at round %d (WAN trace back online; "
                "deferred JOIN batch): the next broadcast full-rebases it",
                worker + 1, self.round_idx)

    # -- fault tolerance: the deadline, heartbeats, JOIN ---------------------
    def handle_round_timeout(self, msg: Message) -> None:
        """The deadline policy: with at least ``ceil(min_quorum_frac *
        live)`` reports, evict the live silos that did not report and
        close with the weighted partial aggregate; below quorum, extend
        the deadline (a close over almost no mass would poison the global
        model), up to the per-round budget. The quorum server overrides
        this with its absolute count."""
        if msg.get(MSG_ARG_KEY_ROUND) != self.round_idx:
            return  # the tick of a round already closed
        if not self._evict_on_deadline:
            return
        live = self.liveness.live_workers()
        reported = self.aggregator.reported_set()
        if self._wan is not None:
            # the trace is the availability oracle: a live silo whose
            # device is offline this round can never report, so it leaves
            # the quorum's denominator now (evicted; it rejoins through
            # the trace-gated JOIN like any eviction)
            for w in sorted(live - reported):
                if not self._wan.silo_online(w + 1, self.round_idx) \
                        and self.liveness.evict(w):
                    self._worker_base.pop(w, None)
                    logging.warning(
                        "silo %d is trace-offline at the round-%d deadline: "
                        "evicted from the quorum denominator (WAN "
                        "availability oracle)", w + 1, self.round_idx)
            live = self.liveness.live_workers()
        need = max(1, math.ceil(self.min_quorum_frac * max(1, len(live))))
        if self._pace is not None and len(live) > 1:
            # steering's no-deadlock rule: ceil(0.9 * n) is n for every n
            # up to 10, so the steered fraction alone would demand every
            # live silo of a small fleet, and one hung silo (no send
            # error, never evicted below quorum) would stall the schedule
            # into the extension cap. The static flags keep their meaning
            # (an explicit min_quorum_frac 1.0 waits for everyone).
            need = min(need, len(live) - 1)
        if len(reported) < need:
            if self._note_deadline_extension():
                self._fail_schedule(
                    f"round {self.round_idx} is still below quorum "
                    f"({len(reported)}/{len(live)} reports, need {need}) "
                    f"after {self._extensions_this_round - 1} deadline "
                    f"extensions (max_deadline_extensions="
                    f"{self._max_extensions}): the federation cannot make "
                    "progress; final state checkpointed")
                return
            if self.obs is not None:
                # the round is not closing: record it and arm a one-shot
                # profile of the next round
                self.obs.note_anomaly(
                    "deadline_extension", self.round_idx,
                    {"reported": len(reported), "live": len(live),
                     "need": int(need),
                     "extensions": int(self._extensions_this_round)})
            logging.warning(
                "round %d deadline passed with %d/%d reports (quorum %d): "
                "extending the deadline (%d/%s extensions used)",
                self.round_idx, len(reported), len(live), need,
                self._extensions_this_round,
                self._max_extensions
                if self._max_extensions is not None else "inf")
            # mid-round durability: the reports in hand survive a kill
            # during a long extension stretch
            self._save_control_snapshot()
            self._arm_deadline()
            return
        for w in sorted(live - reported):
            if self.liveness.evict(w):
                self._worker_base.pop(w, None)
                logging.warning(
                    "silo %d missed the %.3gs round-%d deadline: evicted "
                    "from the live set (the mass of its missing reply, "
                    "error feedback included, is lost); it re-admits via "
                    "JOIN with a full resync", w + 1, self.round_deadline_s,
                    self.round_idx)
        self._close_round(partial=True)

    def _note_deadline_extension(self) -> bool:
        """Count one below-quorum extension; True once the round's budget
        (``max_deadline_extensions``) is spent: the caller fails the
        schedule instead of extending forever (``None``: no budget)."""
        self._extensions_this_round += 1
        self.ft_counters["deadline_extensions"] += 1
        return (self._max_extensions is not None
                and self._extensions_this_round > self._max_extensions)

    def handle_message_heartbeat(self, msg: Message) -> None:
        # the beat itself landed in receive_message; here the count, and
        # with observability on the idle silo's digest row
        self.ft_counters["heartbeats"] += 1
        if self.obs is not None:
            digest = msg.get_params().get(MSG_ARG_KEY_OBS_DIGEST)
            if digest is not None:
                self.obs.recorder.append(
                    {"kind": "silo", "round": int(self.round_idx),
                     "silo_rank": int(msg.get_sender_id()),
                     "event": "heartbeat", "digest": digest})

    def handle_message_join(self, msg: Message) -> None:
        """Re-admit an evicted or restarted silo: mark it live, forget its
        stale base report, and resync it with the full-precision mirror
        (the model every in-sync silo holds), so it decodes the next
        compressed broadcast like everyone else."""
        worker = msg.get_sender_id() - 1
        done = msg.get_params().get(MSG_ARG_KEY_ROUNDS_COMPLETED, None)
        if self.liveness.is_live(worker) \
                and self.aggregator.has_reported(worker):
            # live and already reported: it is waiting out the round
            return
        if self._wan_defers_join(worker) or self._join_throttled(worker):
            return
        self.liveness.admit(worker)
        self._wan_pending_joins.discard(worker)
        self._worker_base.pop(worker, None)
        if not self._evict_on_deadline:
            # the strict barrier: JOIN is proof of life only (a resync
            # could feed the all-received barrier twice)
            return
        if self.round_idx >= self.comm_round:
            return  # the schedule is done
        if self._bcast_at is None:
            # this server has not broadcast yet (a restored one holds the
            # mirror of the round before): its first broadcast reaches
            # the silo, a resync now would send a stale model
            return
        if self._resynced_round.get(worker) == self.round_idx:
            return  # resynced this round already; its reply is on the way
        self._resynced_round[worker] = self.round_idx
        self.ft_counters["join_resyncs"] += 1
        logging.info("silo %d JOIN (rounds_completed=%s): re-admitted with "
                     "a full-precision mirror resync at round %d",
                     worker + 1, done, self.round_idx)
        with self._device_lock:
            payload = to_numpy(self._mirror if self._mirror is not None
                               else self.global_model)
        if self._wan is not None:
            # a redraw of this round's cohort, telemetry-silent: the
            # broadcast's draw already counted it
            idxs = self._wan.sample_cohort(
                self.round_idx, self.client_num_in_total, self.worker_num,
                record=False)
        else:
            idxs = self.aggregator.client_sampling(
                self.round_idx, self.client_num_in_total, self.worker_num)
        out = Message(MSG_TYPE_S2C_SYNC_MODEL, self.rank, worker + 1)
        out.add(MSG_ARG_KEY_MODEL_PARAMS, payload)
        out.add(MSG_ARG_KEY_CLIENT_INDEX, int(idxs[worker]))
        out.add(MSG_ARG_KEY_ROUND, self.round_idx)
        out.add(MSG_ARG_KEY_BCAST_SEQ, self._bcast_seq)
        try:
            self.send_message(out)
        except OSError as exc:
            if self.liveness.evict(worker):
                logging.warning("resync to rejoining silo %d failed (%r): "
                                "evicted again", worker + 1, exc)

    def _wan_defers_join(self, worker: int) -> bool:
        """The WAN rejoin gate: while the silo's device is offline in the
        trace, its JOIN is remembered for the round-boundary admit and
        answered with BACKPRESSURE (``join_retry_s``); True when deferred.
        The anti-starvation valve: the virtual clock advances only at
        round closes, so with every live silo dark the trace would freeze
        and every JOIN wait forever. Past
        ``max_join_deferrals_per_round`` deferrals of one silo's JOIN in
        one round the world forces it online (the server's gates and the
        silo's own agent) and the JOIN is admitted."""
        if self._wan is None or self._wan.silo_online(worker + 1,
                                                      self.round_idx):
            return False
        self._wan_pending_joins.add(worker)
        r, n = self._wan_join_deferrals.get(worker, (-1, 0))
        n = n + 1 if r == self.round_idx else 1
        self._wan_join_deferrals[worker] = (self.round_idx, n)
        if n > self._wan.max_join_deferrals_per_round:
            logging.warning(
                "silo %d JOIN deferred %d times inside round %d with the "
                "trace frozen: admitting it anyway (WAN anti-starvation "
                "valve)", worker + 1, n - 1, self.round_idx)
            self._wan.force_online(worker + 1)
            self._wan_pending_joins.discard(worker)
            return False
        self.round_timer.count("wan_join_deferred")
        self._backpressure(worker, float(self._wan.join_retry_s),
                           "deferred (device offline in the WAN trace)")
        return True

    def _join_throttled(self, worker: int) -> bool:
        """JOIN admission: a mass rejoin after a partition heals must not
        stampede the full-precision resync path. A JOIN that finds the
        token bucket empty gets BACKPRESSURE and the silo defers its next
        attempt (its heartbeats keep beating); True when throttled."""
        if self._join_admission is None \
                or self._join_admission.try_acquire():
            return False
        self.cp_counters["joins_throttled"] += 1
        self._backpressure(worker,
                           float(self._join_admission.retry_after_s()),
                           "throttled (admission token bucket empty)")
        return True

    def _backpressure(self, worker: int, retry_s: float, why: str) -> None:
        out = Message(MSG_TYPE_S2C_JOIN_BACKPRESSURE, self.rank, worker + 1)
        out.add(MSG_ARG_KEY_RETRY_AFTER, retry_s)
        try:
            self.send_message(out)
        except OSError as exc:
            logging.debug("backpressure reply to silo %d failed: %r",
                          worker + 1, exc)
        logging.info("silo %d JOIN %s: backpressure sent", worker + 1, why)


class FedOptServerManager(FedAvgServerManager):
    """Cross-silo FedOpt: the round closes with a step of a persistent
    server optimizer on the pseudo-gradient ``w_old - w_avg`` instead of
    installing the average (reference
    fedml_api/distributed/fedopt/FedOptAggregator.py:70-123; JAX
    ``FedOptServerManager``). ``param_names`` are the module's parameters
    (``named_parameters`` order), the tensors the optimizer steps; the
    other entries of the state dict (BN statistics) keep the plain
    average. The silos are unchanged. The optimizer state joins the
    checkpointed round state."""

    def __init__(self, *args, param_names, server_optimizer: str = "adam",
                 server_lr: float = 1e-3, server_momentum: float = 0.0,
                 **kw):
        from fedml_tpu_torch.algorithms.fedopt import get_server_optimizer

        global_model = args[6] if len(args) > 6 else kw["global_model"]
        opt_kw = {}
        if server_optimizer == "sgd" and server_momentum:
            opt_kw["momentum"] = server_momentum
        self._server_tx = get_server_optimizer(server_optimizer, server_lr,
                                               **opt_kw)
        self._param_names = list(param_names)
        # the job's gate under the scheduler, as every server section
        gate = kw.get("device_gate")
        with gate if gate is not None else _DEVICE_LOCK:
            self.server_opt_state = self._server_tx.init(
                [global_model[n] for n in self._param_names])
        # super() last: a resume overwrites the fresh optimizer state
        # through _load_state
        super().__init__(*args, **kw)

    def _checkpoint_state(self):
        return {"variables": self.global_model,
                "server_opt": self.server_opt_state}

    def _load_state(self, state) -> None:
        self.global_model = state["variables"]
        self.server_opt_state = state["server_opt"]

    def _capture_extra(self, state) -> None:
        with self._device_lock:
            state["server_opt"] = _host_copy(self.server_opt_state)

    def _restore_extra(self, state) -> None:
        # the fresh optimizer state is the template: its structure,
        # devices and dtypes (the step count stays int32)
        with self._device_lock:
            self.server_opt_state = _like(self.server_opt_state,
                                          state["server_opt"])

    def _aggregate_round(self, partial: bool = False):
        avg = super()._aggregate_round(partial=partial)
        params = [self.global_model[n] for n in self._param_names]
        pseudo_grad = torch._foreach_sub(
            params, [avg[n] for n in self._param_names])
        updates, self.server_opt_state = self._server_tx.update(
            pseudo_grad, self.server_opt_state, params)
        new = dict(avg)  # buffers keep the plain average
        new.update(zip(self._param_names,
                       torch._foreach_add(params, updates)))
        return new


class FedAvgClientManager(ClientManager):
    """A silo: receives the global model, points at its sampled client's
    shard (client virtualization, reference FedAVGTrainer.update_dataset),
    runs local training, and ships ``(params, n_i)`` back.

    With ``heartbeat_s`` a thread beats the server every ``heartbeat_s``
    while the silo is idle, and after three beats without a broadcast
    sends JOIN instead (the silo was evicted, or the server forgot it); a
    long local training is not silence. A BACKPRESSURE reply defers the
    next JOIN.

    With ``wan_agent`` (a :class:`~fedml_tpu_torch.wan.WanAgent`) the silo
    embodies a churning device: a broadcast of a round its device is
    offline is dropped (no training, no reply) and the silo goes dark
    (no beats, no JOIN) for the world's ``offline_hold_s``; an online
    round sleeps its client's profiled report delay, outside the device
    lock, before the reply."""

    def __init__(self, rank: int, size: int, com_manager,
                 dataset: FederatedDataset, module, task: str,
                 train_cfg: TrainConfig, seed: int = 0,
                 compress: bool = False, compression=None,
                 state_dir: Optional[str] = None, resume: bool = False,
                 state_sync: bool = False,
                 prefetch_depth: int = 2, device="cuda",
                 timer: Optional[RoundTimer] = None, obs=None,
                 heartbeat_s: float = 0.0, wan_agent=None,
                 device_gate=None):
        super().__init__(rank, size, com_manager)
        self.dataset = dataset
        #: the WAN world's agent for this silo, or None: off
        self._wan_agent = wan_agent
        #: this silo's observability bundle (its own flight log) or None
        self._obs = obs
        #: rounds this silo trained and replied to (the digest's progress)
        self.rounds_completed = 0
        # -- fault tolerance ------------------------------------------------
        self.heartbeat_s = float(heartbeat_s or 0.0)
        #: server silence past this (three beats) sends JOIN
        self.rejoin_idle_s = 3.0 * self.heartbeat_s
        self._last_s2c = time.monotonic()
        #: no JOIN before this (a BACKPRESSURE reply's retry window)
        self._join_backoff_until = 0.0
        #: True while a broadcast's handler (local training) runs
        self._busy = False
        #: guards the flags the receive and heartbeat threads share; a leaf
        #: lock, never held across a send or a device section
        self._hb_lock = threading.Lock()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.device = resolve_device(device)
        #: the process-wide device lock, or the job's fair-share gate
        #: under the multi-job scheduler
        self._device_lock = (device_gate if device_gate is not None
                             else _DEVICE_LOCK)
        validate_accum_steps(train_cfg, dataset.train_data_local_num_dict)
        self._local_train = make_local_train(module, task, train_cfg)
        self._train_cfg = train_cfg
        self._n_pad = dataset.padded_len(train_cfg.batch_size)
        self._bsz = train_cfg.batch_size or self._n_pad
        self._seed = seed
        self._timer = timer if timer is not None else RoundTimer()
        # -- wire compression (comm/policy.py) ------------------------------
        self._policy = resolve_compression(compression, compress=compress)
        #: the last applied global model (on the device): the uplink delta
        #: base AND the downlink decode base (the server's mirror)
        self._held = None
        self._held_seq = -1
        #: uplink error-feedback residual (flat f32, on the device): the
        #: mass top-k did NOT send, added to the next round's delta. Saved
        #: after every round under ``state_dir`` (top-k policies only), so
        #: a resumed silo keeps its error-feedback trajectory.
        self._residual = None
        self._resume_residual = bool(resume)
        self._state_ckpt = None
        if state_dir and self._policy.uplink_topk:
            from fedml_tpu_torch.state.residuals import SiloResidualStore
            # async write-back (unless state_sync): the flush rides a
            # writer thread off the reply's critical path; FINISH closes
            # it (the durability barrier)
            self._state_ckpt = SiloResidualStore(
                state_dir, async_writeback=not state_sync)
        # the server's sampling is the deterministic shared stream, so this
        # silo can pack the client it will be handed next round while the
        # current round trains; keys are (round, client), so a miss packs
        # the actual client inline. Host numpy only.
        from fedml_tpu_torch.parallel.prefetch import (RoundPrefetcher,
                                                       resolve_prefetch_depth)
        depth = resolve_prefetch_depth(prefetch_depth)
        self._prefetch = (RoundPrefetcher(self._pack_client, depth,
                                          next_key=self._predict_next,
                                          name=f"silo{rank}-prefetch")
                          if depth > 0 else None)

    def _pack_client(self, key):
        """Pack one client's padded shard for ``key = (round, client)``
        (numpy; ``client`` None is the silo-outnumbers-pool case)."""
        _, client_idx = key
        ds = self.dataset
        if client_idx is None:
            return ds, None
        x, y, mask = ds.pack_clients([client_idx], self._bsz,
                                     n_pad=self._n_pad)
        return ds, (x[0], y[0], mask[0])

    def _predict_next(self, key):
        """Next round's sampled client for this silo under the server's
        deterministic stream; under a WAN world the same pure
        availability-restricted draw, telemetry-silent (the server counts
        its own draws)."""
        r = key[0] + 1
        if self._wan_agent is not None:
            idxs = self._wan_agent.world.sample_cohort(
                r, self.dataset.client_num, self.size - 1, record=False)
        else:
            idxs = sample_clients(r, self.dataset.client_num, self.size - 1)
        if self.rank - 1 >= len(idxs):
            return (r, None)
        return (r, int(idxs[self.rank - 1]))

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_SYNC_MODEL, self.handle_message_init)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_FINISH, self._handle_finish)
        self.register_message_receive_handler(
            MSG_TYPE_S2C_JOIN_BACKPRESSURE, self._handle_join_backpressure)

    def _handle_join_backpressure(self, msg: Message) -> None:
        """The server refused our JOIN for now: defer the next attempt by
        its retry window. The idle clock keeps running (we are still
        evicted), so the JOIN is retried after the window."""
        retry = float(msg.get_params().get(
            MSG_ARG_KEY_RETRY_AFTER, max(1.0, self.heartbeat_s)))
        with self._hb_lock:
            self._join_backoff_until = time.monotonic() + retry
        logging.info("silo %d: JOIN backpressured, retrying in %.2fs",
                     self.rank, retry)

    def run(self) -> None:
        self.register_message_receive_handlers()
        with self._hb_lock:
            # the idle clock starts with the protocol, not at construction
            # (the JAX package's starts at construction, so the launcher's
            # warm-up between the two reads as server silence)
            self._last_s2c = time.monotonic()
        if self.heartbeat_s > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"silo{self.rank}-heartbeat")
            self._hb_thread.start()
        try:
            self.com_manager.handle_receive_message()
        finally:
            self._hb_stop.set()
            if self._hb_thread is not None:
                self._hb_thread.join(timeout=self.heartbeat_s + 5.0)

    def _send_join(self) -> None:
        msg = Message(MSG_TYPE_C2S_JOIN, self.rank, 0)
        with self._hb_lock:
            done = self.rounds_completed
        msg.add(MSG_ARG_KEY_ROUNDS_COMPLETED, done)
        try:
            self.send_message(msg)
        except OSError as exc:
            # the server may be down: the next beat retries the JOIN
            logging.warning("silo %d: JOIN not delivered (%r); retrying on "
                            "the heartbeat cadence", self.rank, exc)

    def _heartbeat_loop(self) -> None:
        """Beat while idle; send JOIN once the server has been silent past
        ``rejoin_idle_s`` (we were evicted, or the server restarted)."""
        while not self._hb_stop.wait(self.heartbeat_s):
            if self._wan_agent is not None \
                    and not self._wan_agent.online_now():
                # the device is dark: no beats (the deadline evicts it),
                # no JOIN (the rejoin waits for the trace)
                continue
            with self._hb_lock:
                idle = time.monotonic() - self._last_s2c
                busy = self._busy
                backoff_until = self._join_backoff_until
            if (not busy
                    and idle > self.rejoin_idle_s
                    and time.monotonic() >= backoff_until):
                self._send_join()
                continue
            beat = Message(MSG_TYPE_C2S_HEARTBEAT, self.rank, 0)
            if self._obs is not None:
                beat.add(MSG_ARG_KEY_OBS_DIGEST, self._obs_digest())
            try:
                self.send_message(beat)
            except OSError as exc:
                logging.debug("silo %d heartbeat failed: %r", self.rank, exc)

    def _handle_finish(self, msg: Message) -> None:
        self._hb_stop.set()
        if self._prefetch is not None:
            self._prefetch.close()
        if self._state_ckpt is not None:
            # every save of this run is on disk before the silo stops
            self._state_ckpt.close()
        self.finish()

    def _apply_broadcast(self, msg: Message):
        """Decode this round's global model onto the device: full payloads
        install directly; compressed deltas rebuild against the held model
        (the fingerprint guard inside ``decompress`` raises on skew)."""
        variables = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        # the phase starts once the lock is held: it times the work, not
        # the wait for the other silos' turns
        with self._device_lock, self._timer.phase("apply"):
            if is_compressed(variables):
                if self._held is None:
                    raise RuntimeError(
                        "silo received a compressed broadcast before any "
                        "full-precision model: the server must send INIT "
                        "full")
                variables = decompress(variables, self._held)
            else:
                variables = tree_to_device(variables, self.device)
            synchronize(self.device)
        self._held = variables
        seq = msg.get_params().get(MSG_ARG_KEY_BCAST_SEQ)
        if seq is not None:
            self._held_seq = int(seq)
        return variables

    def _uplink_residual(self, round_idx: int, variables):
        """The EF residual entering this round. On resume it is restored
        once, from the residual saved for the server's resumed round;
        absent state starts error feedback from zero (it re-loses the
        pending mass, it never corrupts)."""
        if self._resume_residual:
            self._resume_residual = False
            if self._state_ckpt is not None:
                restored = self._state_ckpt.load(round_idx,
                                                 pt.tree_size(variables))
                if restored is not None:
                    self._residual = torch.from_numpy(restored).to(
                        self.device)
                else:
                    logging.info("silo%d: no residual checkpoint for round "
                                 "%d; starting error feedback from zero",
                                 self.rank, round_idx)
        return self._residual

    def _obs_digest(self) -> Dict:
        """The compact counter digest piggybacked on replies when
        observability is on: cumulative wire bytes, transport retries and
        dedup drops, rounds completed and prefetch hits, plus this
        endpoint incarnation's stream epoch, a few dozen bytes."""
        com = self.com_manager
        with self._hb_lock:
            done = self.rounds_completed
        counters = dict(com.all_counters() if hasattr(com, "all_counters")
                        else getattr(com, "counters", {}))
        digest = {"rounds_completed": int(done),
                  "epoch": endpoint_epoch(com) or 0,
                  "bytes_up": int(getattr(com, "bytes_sent", 0)),
                  "bytes_down": int(getattr(com, "bytes_received", 0)),
                  "retries": int(counters.get("retries", 0)),
                  "dedup_drops": int(counters.get("dedup_drops", 0))}
        if self._prefetch is not None:
            st = self._prefetch.stats()
            digest["prefetch_hits"] = int(st.get("hits", 0))
            digest["prefetch_misses"] = int(st.get("misses", 0))
        return digest

    def handle_message_init(self, msg: Message) -> None:
        # busy for the whole handler: local training may run far longer
        # than rejoin_idle_s, and the heartbeat thread must not read that
        # as eviction and JOIN mid-round
        with self._hb_lock:
            self._last_s2c = time.monotonic()
            self._busy = True
        try:
            self._train_and_reply(msg)
        finally:
            with self._hb_lock:
                self._busy = False
                self._last_s2c = time.monotonic()

    def _wan_payload_bytes(self) -> float:
        """The model frame's size for the WAN bandwidth model: the held
        state dict's f32 bytes (0 before the first broadcast)."""
        if self._held is None:
            return 0.0
        return 4.0 * sum(v.numel() for v in self._held.values())

    def _train_and_reply(self, msg: Message) -> None:
        t0 = time.perf_counter()
        tm = self._timer
        client_idx = int(msg.get(MSG_ARG_KEY_CLIENT_INDEX))
        round_idx = msg.get(MSG_ARG_KEY_ROUND)
        wan_delay = 0.0
        if self._wan_agent is not None:
            # decided before the broadcast applies: an offline device never
            # got the frame, so its held model goes stale and the server's
            # next broadcast to it is a full rebase
            nbytes = self._wan_payload_bytes()
            drop, wan_delay = self._wan_agent.on_round(
                round_idx, client_idx, up_bytes=nbytes, down_bytes=nbytes)
            if drop:
                logging.info("silo %d: device offline in the WAN trace at "
                             "round %s: dropping the broadcast (no training, "
                             "no reply)", self.rank, round_idx)
                return
        variables = self._apply_broadcast(msg)
        packed = None
        if self._prefetch is not None:
            (ds, payload), _, _ = self._prefetch.get((round_idx, client_idx))
            if ds is self.dataset:
                packed = payload
        if packed is None:
            x, y, mask = self.dataset.pack_clients([client_idx], self._bsz,
                                                   n_pad=self._n_pad)
            packed = (x[0], y[0], mask[0])
        xb, yb, maskb = packed
        cfg = self._train_cfg
        scale = round_lr_scale(cfg, round_idx, self.device)
        _, (seed,), _ = round_keys(self._seed, round_idx, [client_idx])
        sched = make_batch_schedule(self._n_pad, cfg.epochs, self._bsz,
                                    cfg.shuffle, seed, maskb,
                                    cfg.accum_steps)
        reply = Message(MSG_TYPE_C2S_SEND_MODEL, self.rank, 0)
        with self._device_lock:
            with tm.phase("train"):
                dev = self.device
                new_vars, _ = self._local_train(
                    variables, torch.from_numpy(xb).to(dev),
                    torch.from_numpy(yb).to(dev),
                    torch.from_numpy(maskb).to(dev), seed, lr_scale=scale,
                    schedule=sched)
                synchronize(dev)
            with tm.phase("encode"):
                if self._policy.enabled:
                    gen = make_generator(derive_seed(
                        UPLINK_SEED_TAG, round_idx, self.rank), dev)
                    residual = (self._uplink_residual(round_idx, variables)
                                if self._policy.uplink_topk else None)
                    payload, new_residual = compress_for_policy(
                        new_vars, variables, residual, gen, self._policy)
                    if self._policy.uplink_topk:
                        self._residual = new_residual
                else:
                    payload = to_numpy(new_vars)
            # a copy: the store's writer thread reads it later
            saved = (self._residual.cpu().numpy().copy()
                     if self._state_ckpt is not None
                     and self._residual is not None else None)
        if saved is not None:
            # keyed by rounds completed, as the server's model checkpoint
            self._state_ckpt.save(round_idx + 1, saved)
        reply.add(MSG_ARG_KEY_MODEL_PARAMS, payload)
        n_i = float(self.dataset.train_data_local_num_dict[client_idx])
        reply.add(MSG_ARG_KEY_NUM_SAMPLES, n_i)
        reply.add(MSG_ARG_KEY_ROUND, round_idx)
        # the held-base report drives the server's downlink decision
        reply.add(MSG_ARG_KEY_BASE_SEQ, self._held_seq)
        reply.add(MSG_ARG_KEY_BASE_FP, tree_fingerprint(variables))
        if self._obs is not None:
            # the digest for the server's per-silo row, and this silo's
            # own view of the round, recorded BEFORE the send
            reply.add(MSG_ARG_KEY_OBS_DIGEST, self._obs_digest())
            self._obs.recorder.append(
                {"kind": "round", "round": int(round_idx),
                 "client_idx": int(client_idx),
                 "train_s": round(time.perf_counter() - t0, 6)})
        if wan_delay > 0:
            # the injected report latency, outside the device lock: a
            # straggler straggles alone (the busy flag is still up, so the
            # heartbeat thread does not read the sleep as eviction)
            time.sleep(wan_delay)
        try:
            self.send_message(reply)
        except OSError as exc:
            # the server may be gone: the receive loop must survive to
            # hear a restarted server, which re-drives the round
            logging.warning("silo %d: round-%d reply not delivered (%r)",
                            self.rank, round_idx, exc)
            return
        with self._hb_lock:
            self.rounds_completed += 1


#: options of the JAX launchers that the port does not run yet, with the
#: ROADMAP item that ports each; any value other than the default raises
_NOT_PORTED = {
    "serve_port": "Slice D item 23 (serving)",
    "serving": "Slice D item 23 (serving)",
}


def _refuse_not_ported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet: ROADMAP Queue 1, "
                f"{_NOT_PORTED[name]}")


def run_fedavg_cross_silo(dataset: FederatedDataset, module,
                          task: str = "classification",
                          worker_num: int = 2, comm_round: int = 2,
                          train_cfg: Optional[TrainConfig] = None,
                          backend: str = "INPROC",
                          addresses=None, wire_codec: bool = True,
                          compress: bool = False, compression=None,
                          token=None,
                          checkpoint_dir: Optional[str] = None,
                          resume: bool = False,
                          server_optimizer: Optional[str] = None,
                          server_lr: float = 1e-3,
                          server_momentum: float = 0.0,
                          seed: int = 0,
                          join_timeout_s: float = 600.0,
                          round_record_hook=None,
                          timer=None,
                          prefetch_depth: int = 2,
                          round_deadline_s: Optional[float] = None,
                          min_quorum_frac: float = 0.5,
                          heartbeat_s: float = 0.0,
                          fault_plan=None,
                          server_checkpoint_dir: Optional[str] = None,
                          checkpoint_sync: bool = False,
                          pace_steering: bool = False,
                          join_rate_limit: float = 0.0,
                          max_deadline_extensions: Optional[int] = 25,
                          obs_dir: Optional[str] = None,
                          job_id: Optional[str] = None,
                          comm_factory=None,
                          device_gate=None,
                          serve_port: Optional[int] = None,
                          serve_staleness_rounds: int = 2,
                          serving=None,
                          wan_trace=None,
                          wan_profiles=None,
                          wan_round_s: float = 60.0,
                          wan=None,
                          device="cuda",
                          init_variables=None):
    """Launch the server and ``worker_num`` silo actors (threads, one per
    silo) and run the full protocol. Returns ``(final global model,
    history)``, one ``{round, test_acc, test_loss}`` record a round.

    ``compression`` selects the wire policy (none | delta_int8 | topk_ef
    | topk_ef_int8, optionally ``:frac``; a name or a CompressionPolicy);
    the legacy boolean ``compress`` maps to delta_int8 on the uplink only.
    ``timer`` (a RoundTimer) receives the wire accounting
    (``comm_bytes_up`` / ``comm_bytes_down`` from the encoded frames) and
    the round's phases. ``device`` (default CUDA; raises without a GPU)
    holds every model; ``init_variables`` is a state dict to start from in
    place of the seeded initialization.

    ``backend`` names a transport of ``comm/registry.py`` ("INPROC",
    "TCP", "GRPC", "GRPC_PROTO", "MQTT", "ROUTED"), reached through
    ``addresses`` and, for ROUTED, the shared-secret ``token``.
    ``server_optimizer`` (adam, sgd, ...; ``server_lr``,
    ``server_momentum``) closes each round with a FedOpt step
    (:class:`FedOptServerManager`). ``checkpoint_dir`` saves the round
    state after every round (the server's model and optimizer state, and
    each silo's EF residual under ``checkpoint_dir/silo_<rank>``);
    ``resume`` restarts from the latest checkpoint.

    Fault tolerance: ``round_deadline_s`` turns on deadline rounds (the
    weighted partial close once ``min_quorum_frac`` of the live silos
    reported, evicting the rest; below quorum at most
    ``max_deadline_extensions`` extensions a round, then
    ``SchedulingStallError``); ``heartbeat_s`` makes idle silos beat and
    JOIN back after three silent beats; ``fault_plan`` (DSL or JSON, see
    ``comm/faults.py``) wraps every endpoint in the seeded fault
    injector. The fault-tolerance counters land in ``timer`` as ``ft_*``.

    The WAN world: ``wan_trace`` (and ``wan_profiles``, ``wan_round_s``)
    build a :class:`~fedml_tpu_torch.wan.WanWorld` over the dataset's
    clients; a prebuilt ``wan`` wins (see :func:`launch_federation`). A
    ``fault_plan`` then composes with it through ``compose_fault_plan``.

    The control plane: ``server_checkpoint_dir`` snapshots the server's
    round-schedule state at round boundaries and deadline extensions and
    keeps the round/cohort ledger there (a killed and restarted server
    resumes mid-schedule); the snapshots are written by a thread of their
    own with group-committed ledger fsyncs, or inline with an fsync a
    ledger line under ``checkpoint_sync`` (which also makes each silo's
    residual store write synchronously). ``pace_steering`` derives each
    round's deadline and quorum from the observed report latencies (the
    static flags are its base and floor); ``join_rate_limit`` (JOINs a
    second) token-buckets JOIN floods with BACKPRESSURE replies and is
    the WAN world's shadow bucket rate. The ``cp_*`` counters land in
    ``timer``.

    The signature is the JAX package's; the options the port does not run
    yet raise ``NotImplementedError`` when set, in
    :func:`launch_federation` (``serve_staleness_rounds`` only takes
    effect with one of those, so it is accepted and unused). ``obs_dir``
    gives every rank a flight log under one ``job_id`` (see
    :func:`launch_federation`)."""
    from fedml_tpu_torch.control import build_control_plane
    if wan is None:
        # the shadow mass-JOIN bucket runs at the admission rate, so the
        # population's JOIN wave is measured against the configured policy
        wan = build_wan_world(wan_trace, wan_profiles, wan_round_s,
                              population=dataset.client_num,
                              mass_join_rate=join_rate_limit)
    if wan is not None and fault_plan:
        fault_plan = compose_fault_plan(fault_plan)
    policy = resolve_compression(compression, compress=compress)
    checkpoint_mgr = None
    if checkpoint_dir:
        from fedml_tpu_torch.utils.checkpoint import CheckpointManager
        checkpoint_mgr = CheckpointManager(checkpoint_dir)
    control = build_control_plane(
        server_checkpoint_dir=server_checkpoint_dir,
        pace_steering=pace_steering, join_rate_limit=join_rate_limit,
        round_deadline_s=round_deadline_s, min_quorum_frac=min_quorum_frac,
        max_deadline_extensions=max_deadline_extensions,
        checkpoint_sync=checkpoint_sync)

    def server_factory(size, server_com, aggregator, global_model,
                       on_round_done):
        common = dict(on_round_done=on_round_done,
                      checkpoint_mgr=checkpoint_mgr, resume=resume,
                      compression=policy, round_deadline_s=round_deadline_s,
                      min_quorum_frac=min_quorum_frac,
                      device_gate=device_gate, wan=wan, **control)
        if server_optimizer:
            return FedOptServerManager(
                0, size, server_com, aggregator, comm_round,
                dataset.client_num, global_model,
                param_names=[n for n, _ in module.named_parameters()],
                server_optimizer=server_optimizer, server_lr=server_lr,
                server_momentum=server_momentum, **common)
        return FedAvgServerManager(0, size, server_com, aggregator,
                                   comm_round, dataset.client_num,
                                   global_model, **common)

    if job_id is None and (checkpoint_dir or server_checkpoint_dir):
        # keyed on the run's durable namespace, so a run that persists
        # through server_checkpoint_dir alone also rejoins its own flight
        # timeline when it resumes after a crash
        job_id = default_job_id(
            "fed", stable_key=checkpoint_dir or server_checkpoint_dir)
    model, history, _ = launch_federation(
        dataset, module, task, worker_num, train_cfg, server_factory,
        backend=backend, addresses=addresses, wire_codec=wire_codec,
        compression=policy, token=token, seed=seed,
        client_state_dir=checkpoint_dir, resume=resume,
        state_sync=checkpoint_sync, join_timeout_s=join_timeout_s,
        round_record_hook=round_record_hook, timer=timer,
        prefetch_depth=prefetch_depth, heartbeat_s=heartbeat_s,
        fault_plan=fault_plan, obs_dir=obs_dir, job_id=job_id,
        comm_factory=comm_factory, device_gate=device_gate,
        serve_port=serve_port, serving=serving, wan=wan, device=device,
        init_variables=init_variables)
    return model, history


def _initial_model(module, seed: int, device, init_variables):
    """The starting global model on ``device``: ``init_variables`` when
    given (names and shapes checked against the module), else the seeded
    flax-matching initialization on the CPU, so every device starts from
    the same weights."""
    if init_variables is None:
        init_params(module.cpu(), make_generator(seed))
        return {k: v.detach().clone().to(device)
                for k, v in module.state_dict().items()}
    want = module.state_dict()
    if list(init_variables) != list(want):
        raise KeyError(f"init_variables names {list(init_variables)} != the "
                       f"module's {list(want)}")
    out = {}
    for k, v in init_variables.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v).to(device=device, dtype=want[k].dtype)
        if t.shape != want[k].shape:
            raise ValueError(f"init_variables[{k!r}] {tuple(t.shape)} != "
                             f"{tuple(want[k].shape)}")
        out[k] = t.clone()
    return out


def _actor(fn, errors: list, stop_all):
    """Thread target: run ``fn``; on an exception record it and stop every
    actor's receive loop, so the launch ends and re-raises it instead of
    waiting out ``join_timeout_s``."""
    def run():
        try:
            fn()
        except Exception as exc:  # re-raised by the launch
            logging.exception("cross-silo actor failed")
            errors.append(exc)
            stop_all()
    return run


def launch_federation(dataset: FederatedDataset, module, task: str,
                      worker_num: int, train_cfg: Optional[TrainConfig],
                      server_factory, backend: str = "INPROC",
                      addresses=None, wire_codec: bool = True,
                      compress: bool = False, compression=None,
                      token=None, seed: int = 0,
                      client_state_dir: Optional[str] = None,
                      resume: bool = False,
                      state_sync: bool = False,
                      join_timeout_s: float = 600.0,
                      raise_on_timeout: bool = True,
                      round_record_hook=None,
                      timer=None,
                      prefetch_depth: int = 2,
                      heartbeat_s: float = 0.0,
                      fault_plan=None,
                      obs_dir: Optional[str] = None,
                      job_id: Optional[str] = None,
                      comm_factory=None,
                      device_gate=None,
                      serve_port: Optional[int] = None,
                      serve_staleness_rounds: int = 2,
                      serving=None,
                      wan=None,
                      device="cuda",
                      init_variables=None):
    """Shared federation scaffolding: init the global model, build the
    per-round eval hook, wire the comm endpoints and silos, run the
    protocol threads, bounded join. ``server_factory(size, server_com,
    aggregator, global_model, on_round_done)`` returns the server manager.
    Returns ``(final global model, history, server)``; the server carries
    ``round_timer`` with the wire byte accounting.

    An exception in any actor stops the others and is re-raised here, as
    is a server's ``scheduling_error`` (a round that used up its deadline
    extensions). A federation that outlasts ``join_timeout_s`` raises
    too: the port defaults ``raise_on_timeout`` to True, where the JAX
    package returns the partial history after logging the error.
    ``wire_codec=False`` (the JAX package's object hand-off, which ships
    no frame and counts no bytes) is not ported: every message crosses as
    an encoded frame.

    Every rank's endpoint comes from ``create_comm_manager(backend, rank,
    size, addresses=, token=, fault_plan=)`` (one parsed plan for every
    rank, so each rank's stream comes from one seed); ``heartbeat_s``
    reaches every silo. ``client_state_dir`` holds each silo's residual
    store (``silo_<rank>``), restored once on ``resume``. The transport
    and fault counters of every endpoint (``retries``, ``dedup_drops``,
    ``conn_errors``, ``faults_injected``) and the server's protocol
    counters (evictions, rejoins, partial rounds, stale replies, corrupt
    frames, JOIN resyncs, heartbeats, deadline extensions) are summed into
    the timer as ``ft_*``, its control-plane counters as ``cp_*``.
    ``state_sync`` makes each silo's residual store write inline.
    ``wan`` (a :class:`~fedml_tpu_torch.wan.WanWorld`, which takes the
    dataset's client count as its population when it has none) gives
    every silo its agent; the server factory hands it to the server.
    The world's remaining counters and every agent's
    (``wan_offline_drops``, ``wan_delay_injected_ms``) land in the timer
    after the run. ``obs_dir`` builds one observability bundle a rank
    (the server's with the slow-round profiler and the perf accountant)
    under one ``job_id``, derived once for the launch when unset; every
    recorder is closed on the way out.

    The multi-job scheduler's hooks (``fedml_tpu_torch/sched``):
    ``comm_factory(rank)`` supplies each rank's endpoint in place of
    ``create_comm_manager`` (the job's virtual channels over one shared
    fabric), and ``device_gate`` replaces the process-wide device lock
    around model init, every actor's device sections and the eval (the
    job's fair-share gate). Both None is the single-tenant launch. The
    port has no warm-up to gate: nothing compiles before the first
    round."""
    _refuse_not_ported(serve_port=serve_port, serving=serving)
    if comm_factory is not None:
        # the factory's endpoints are built elsewhere (the scheduler's
        # shared fabric): the knobs only create_comm_manager reads would
        # be dropped without a word, so refuse
        dropped = [name for name, unset in (
            ("fault_plan", fault_plan is None),
            ("token", token is None),
            ("addresses", addresses is None),
            ("wire_codec", wire_codec)) if not unset]
        if dropped:
            raise ValueError(
                f"comm_factory supplies prebuilt endpoints: {dropped} "
                "would be silently ignored — apply transport knobs where "
                "the endpoints are built (e.g. SharedFabric(wire_codec=, "
                "token=, fault_plan=))")
    if wan is not None and wan.population is None:
        wan.population = dataset.client_num
    if not wire_codec:
        raise NotImplementedError(
            "wire_codec=False (the object hand-off) is not ported: the "
            "in-process router always ships encoded frames")
    train_cfg = train_cfg or TrainConfig()
    dev = resolve_device(device)
    policy = resolve_compression(compression, compress=compress)
    size = worker_num + 1
    gate = device_gate if device_gate is not None else _DEVICE_LOCK
    router = (InProcRouter() if comm_factory is None
              and backend.upper() in ("INPROC", "MPI") else None)
    timer = timer if timer is not None else RoundTimer()
    plan = parse_fault_plan(fault_plan)
    coms, clients = [], []

    def endpoint(rank):
        if comm_factory is not None:
            com = comm_factory(rank)
        else:
            com = create_comm_manager(backend, rank, size, router=router,
                                      addresses=addresses, token=token,
                                      fault_plan=plan)
        coms.append(com)
        return com

    def stop_all():
        for com in coms:
            com.stop_receive_message()

    xt, yt = dataset.test_data_global
    with gate:  # model init and the uploads are device work
        global_model = _initial_model(module, seed, dev, init_variables)
        module.to(dev)
        test = (torch.from_numpy(np.ascontiguousarray(xt)).to(dev),
                torch.from_numpy(np.ascontiguousarray(yt)).to(dev),
                torch.ones(len(xt), device=dev))
    history: List[Dict] = []
    eval_fn = make_eval(module, task)

    def on_round_done(round_idx, model):
        if not len(xt):
            return
        with gate:  # only the eval is device work
            stats = eval_fn(model, *test)
            count = max(1.0, float(stats["count"]))
            acc = float(stats["correct_sum"]) / count
            loss = float(stats["loss_sum"]) / count
        rec = {"round": round_idx, "test_acc": acc, "test_loss": loss}
        history.append(rec)
        logging.info("cross-silo round %d: %s", round_idx, rec)
        if round_record_hook is not None:
            try:
                round_record_hook(rec)
            except Exception:
                logging.warning("round_record_hook failed for round %d",
                                round_idx, exc_info=True)

    errors: List[BaseException] = []
    # one id for every rank of this launch; keyed on the run's durable
    # namespace when it has one, so a resumed run rejoins its own flight
    # timeline instead of forking a phantom second job
    job = job_id or default_job_id("fed", stable_key=client_state_dir)
    observers = []

    def observe(com, rank, role):
        obs = build_observability(obs_dir, job_id=job, rank=rank, role=role,
                                  perf_device=dev)
        if obs is not None:
            obs.recorder.set_epoch(endpoint_epoch(com))
            observers.append(obs)
        return obs

    server = None
    try:
        server_com = endpoint(0)
        server = server_factory(size, server_com, FedAvgAggregator(
            worker_num), global_model, on_round_done)
        server.round_timer = timer
        server.obs = observe(server_com, 0, "server")
        if server.obs is not None:
            server.obs.bind_timer(timer)
        for rank in range(1, size):
            com = endpoint(rank)
            clients.append(FedAvgClientManager(
                rank, size, com, dataset, module, task,
                train_cfg, seed=seed, compression=policy,
                state_dir=(os.path.join(client_state_dir, f"silo_{rank}")
                           if client_state_dir else None),
                resume=resume, state_sync=state_sync,
                prefetch_depth=prefetch_depth, device=dev,
                timer=timer, obs=observe(com, rank, "silo"),
                heartbeat_s=heartbeat_s,
                wan_agent=wan.agent(rank) if wan is not None else None,
                device_gate=device_gate))
        threads = [threading.Thread(target=_actor(c.run, errors, stop_all),
                                    daemon=True, name=f"silo{c.rank}")
                   for c in clients]
        server_thread = threading.Thread(
            target=_actor(server.run, errors, stop_all), daemon=True,
            name="server")
        for t in threads:
            t.start()
        server_thread.start()
        server.send_init_msg()
        server_thread.join(timeout=join_timeout_s)
        timed_out = server_thread.is_alive()
        if timed_out:
            stop_all()
        for t in threads:
            t.join(timeout=60)
    finally:
        # every exit (an endpoint that failed to construct, a raising
        # actor, a timeout) releases every listener, connection, timer
        # and prefetch thread: an in-process relaunch must find its ports
        # free, and no deadline tick outlives the launch
        stop_all()
        if server is not None:
            server._cancel_deadline(final=True)
        for c in clients:
            c._hb_stop.set()
            if c._hb_thread is not None:
                c._hb_thread.join(timeout=c.heartbeat_s + 5.0)
            if c._prefetch is not None:
                c._prefetch.close()
        for obs in observers:
            obs.close()
    if errors:
        raise errors[0]
    if timed_out:
        msg = (f"federation did not finish within {join_timeout_s:.0f}s "
               f"({len(history)} rounds recorded)")
        if raise_on_timeout:
            raise RuntimeError(msg)
        logging.error("%s; returning the partial history", msg)
    server._credit_wire_bytes()
    transport = defaultdict(int)
    for com in coms:
        counters = (com.all_counters() if hasattr(com, "all_counters")
                    else com.counters)
        for k, v in counters.items():
            transport[k] += int(v)
    for key in ("retries", "dedup_drops", "conn_errors", "faults_injected"):
        timer.count(f"ft_{key}", transport[key])
    timer.count("ft_evictions", int(server.liveness.evictions))
    timer.count("ft_rejoins", int(server.liveness.rejoins))
    for key in ("partial_rounds", "stale_replies", "corrupt_frames",
                "join_resyncs", "heartbeats", "deadline_extensions"):
        timer.count(f"ft_{key}", int(server.ft_counters.get(key, 0)))
    # the control plane's, counted at zero too, as the ft_* family
    cpc = getattr(server, "cp_counters", {})
    for key in ("checkpoints", "restores", "deadline_adjustments",
                "joins_throttled", "resync_latency_skips"):
        timer.count(f"cp_{key}", int(cpc.get(key, 0)))
    if getattr(server, "_pace", None) is not None and server.round_deadline_s:
        timer.gauge("cp_steered_deadline_s", float(server.round_deadline_s))
    if wan is not None:
        # what the round closes did not drain, and every agent's totals
        for k, v in wan.drain_counters().items():
            timer.count(k, int(v))
        for c in clients:
            for k, v in c._wan_agent.counters.items():
                timer.count(k, int(v))
    if server.scheduling_error is not None:
        # the server FINISHed the silos; surface the stall loudly
        raise server.scheduling_error
    return server.global_model, history, server
