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

Not ported yet, each raising ``NotImplementedError`` when set: the
control plane and serving (item 23), the WAN world (22f) and the
multi-job scheduler hooks (22g) (see ROADMAP Slice D).
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
#: the server refused a JOIN's resync for now (the JAX package's JOIN
#: admission control, ROADMAP item 23, sends it; the port's server does
#: not yet); carries ``retry_after_s``, and the silo defers its next JOIN
#: by that long (its heartbeats keep beating)
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
    Without ``round_deadline_s`` the strict barrier is unchanged."""

    def __init__(self, rank: int, size: int, com_manager,
                 aggregator: FedAvgAggregator, comm_round: int,
                 client_num_in_total: int, global_model,
                 on_round_done=None, checkpoint_mgr=None,
                 resume: bool = False, compression=None,
                 timer: Optional[RoundTimer] = None,
                 round_deadline_s: Optional[float] = None,
                 min_quorum_frac: float = 0.5,
                 max_deadline_extensions: Optional[int] = 25):
        super().__init__(rank, size, com_manager)
        self._device_lock = _DEVICE_LOCK
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

    def send_init_msg(self) -> None:
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

    def _fail_schedule(self, reason: str) -> None:
        """A terminal scheduling failure: FINISH every silo and keep the
        error for the launcher to raise."""
        from fedml_tpu_torch.control import SchedulingStallError
        self.scheduling_error = SchedulingStallError(reason)
        logging.error("%s", self.scheduling_error)
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
        self.com_manager.broadcast(msgs, on_error=(
            self._on_broadcast_send_error if self._evict_on_deadline
            else None))
        tm.gauge("bcast_fanout_ms", (time.monotonic() - t0) * 1e3)

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
        if latency is not None \
                and self._resynced_round.get(worker) != self.round_idx:
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
        tm.gauge("agg_fold_ms", (time.monotonic() - t0) * 1e3)
        tm.gauge("agg_buffered_peak", buffered_peak)
        if self.on_round_done is not None:
            with tm.phase("eval"):
                self.on_round_done(self.round_idx, self.global_model)
        # wire bytes are credited as deltas since the last close FIRST, so
        # the round record's counters are this round's traffic (the perf
        # record's wire bytes/s derive from exactly these)
        self._credit_wire_bytes()
        rec = tm.end_round(self.round_idx, extra={
            "cohort": self._round_cohort,
            "reported": [int(w) for w in reported],
            "live": [int(w) for w in live],
            "partial": bool(partial),
            "evictions": int(self.liveness.evictions),
            "rejoins": int(self.liveness.rejoins),
            "deadline_s": (float(self.round_deadline_s)
                           if self.round_deadline_s else None)})
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
        self.round_idx += 1
        # the new round enters with a full extension budget
        self._extensions_this_round = 0
        if self.checkpoint_mgr is not None:
            with self._device_lock, tm.phase("checkpoint"):
                self.checkpoint_mgr.save(self.round_idx,
                                         self._checkpoint_state())
        if self.round_idx == self.comm_round:
            self._finish_federation()
            return
        idxs = self.aggregator.client_sampling(
            self.round_idx, self.client_num_in_total, self.worker_num)
        self._broadcast_model(MSG_TYPE_S2C_SYNC_MODEL, idxs)
        self._arm_deadline()

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
        need = max(1, math.ceil(self.min_quorum_frac * max(1, len(live))))
        if len(reported) < need:
            if self._note_deadline_extension():
                self._fail_schedule(
                    f"round {self.round_idx} is still below quorum "
                    f"({len(reported)}/{len(live)} reports, need {need}) "
                    f"after {self._extensions_this_round - 1} deadline "
                    f"extensions (max_deadline_extensions="
                    f"{self._max_extensions}): the federation cannot make "
                    "progress")
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
        self.liveness.admit(worker)
        self._worker_base.pop(worker, None)
        if not self._evict_on_deadline:
            # the strict barrier: JOIN is proof of life only (a resync
            # could feed the all-received barrier twice)
            return
        if self.round_idx >= self.comm_round:
            return  # the schedule is done
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
        with _DEVICE_LOCK:
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
    next JOIN."""

    def __init__(self, rank: int, size: int, com_manager,
                 dataset: FederatedDataset, module, task: str,
                 train_cfg: TrainConfig, seed: int = 0,
                 compress: bool = False, compression=None,
                 state_dir: Optional[str] = None, resume: bool = False,
                 prefetch_depth: int = 2, device="cuda",
                 timer: Optional[RoundTimer] = None, obs=None,
                 heartbeat_s: float = 0.0):
        super().__init__(rank, size, com_manager)
        self.dataset = dataset
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
        self._device_lock = _DEVICE_LOCK
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
            # async write-back: the flush rides a writer thread off the
            # reply's critical path; FINISH closes it (the durability
            # barrier)
            self._state_ckpt = SiloResidualStore(state_dir,
                                                 async_writeback=True)
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
        deterministic stream."""
        r = key[0] + 1
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

    def _train_and_reply(self, msg: Message) -> None:
        t0 = time.perf_counter()
        tm = self._timer
        client_idx = int(msg.get(MSG_ARG_KEY_CLIENT_INDEX))
        round_idx = msg.get(MSG_ARG_KEY_ROUND)
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
    "server_checkpoint_dir": "Slice D item 23 (control plane)",
    "checkpoint_sync": "Slice D item 23 (control plane)",
    "pace_steering": "Slice D item 23 (control plane)",
    "join_rate_limit": "Slice D item 23 (control plane)",
    "serve_port": "Slice D item 23 (serving)",
    "serving": "Slice D item 23 (serving)",
    "wan_trace": "Slice D item 22f (the WAN world)",
    "wan_profiles": "Slice D item 22f (the WAN world)",
    "wan": "Slice D item 22f (the WAN world)",
    "comm_factory": "Slice D item 22g (the multi-job scheduler)",
    "device_gate": "Slice D item 22g (the multi-job scheduler)",
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

    The signature is the JAX package's; the options the port does not run
    yet raise ``NotImplementedError`` when set, the server's here and the
    silos' and transport's in :func:`launch_federation`
    (``serve_staleness_rounds`` and ``wan_round_s`` only take effect with
    one of those, so they are accepted and unused). ``obs_dir`` gives
    every rank a flight log under one ``job_id`` (see
    :func:`launch_federation`)."""
    _refuse_not_ported(
        server_checkpoint_dir=server_checkpoint_dir,
        pace_steering=pace_steering, join_rate_limit=join_rate_limit,
        wan_trace=wan_trace, wan_profiles=wan_profiles)
    policy = resolve_compression(compression, compress=compress)
    checkpoint_mgr = None
    if checkpoint_dir:
        from fedml_tpu_torch.utils.checkpoint import CheckpointManager
        checkpoint_mgr = CheckpointManager(checkpoint_dir)

    def server_factory(size, server_com, aggregator, global_model,
                       on_round_done):
        common = dict(on_round_done=on_round_done,
                      checkpoint_mgr=checkpoint_mgr, resume=resume,
                      compression=policy, round_deadline_s=round_deadline_s,
                      min_quorum_frac=min_quorum_frac,
                      max_deadline_extensions=max_deadline_extensions)
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
    the timer as ``ft_*``. ``obs_dir``
    builds one observability bundle a rank (the server's with the
    slow-round profiler and the perf accountant) under one ``job_id``,
    derived once for the launch when unset; every recorder is closed on
    the way out."""
    _refuse_not_ported(
        checkpoint_sync=state_sync,
        comm_factory=comm_factory, device_gate=device_gate,
        serve_port=serve_port, serving=serving, wan=wan)
    if not wire_codec:
        raise NotImplementedError(
            "wire_codec=False (the object hand-off) is not ported: the "
            "in-process router always ships encoded frames")
    train_cfg = train_cfg or TrainConfig()
    dev = resolve_device(device)
    policy = resolve_compression(compression, compress=compress)
    size = worker_num + 1
    router = InProcRouter() if backend.upper() in ("INPROC", "MPI") else None
    timer = timer if timer is not None else RoundTimer()
    plan = parse_fault_plan(fault_plan)
    coms, clients = [], []

    def endpoint(rank):
        com = create_comm_manager(backend, rank, size, router=router,
                                  addresses=addresses, token=token,
                                  fault_plan=plan)
        coms.append(com)
        return com

    def stop_all():
        for com in coms:
            com.stop_receive_message()

    global_model = _initial_model(module, seed, dev, init_variables)
    module.to(dev)
    history: List[Dict] = []
    eval_fn = make_eval(module, task)
    xt, yt = dataset.test_data_global
    test = (torch.from_numpy(np.ascontiguousarray(xt)).to(dev),
            torch.from_numpy(np.ascontiguousarray(yt)).to(dev),
            torch.ones(len(xt), device=dev))

    def on_round_done(round_idx, model):
        if not len(xt):
            return
        with _DEVICE_LOCK:
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
                resume=resume, prefetch_depth=prefetch_depth, device=dev,
                timer=timer, obs=observe(com, rank, "silo"),
                heartbeat_s=heartbeat_s))
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
    if server.scheduling_error is not None:
        # the server FINISHed the silos; surface the stall loudly
        raise server.scheduling_error
    return server.global_model, history, server
