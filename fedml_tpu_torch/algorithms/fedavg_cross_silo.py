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

Models live on one device (``device``, default CUDA) as state dicts; the
wire carries numpy arrays. All actors of a process share that device, so
one lock serializes every device section, as in the JAX package. Random
bits come from explicit generators on the device, seeded through the
port's ``derive_seed`` chain with the JAX package's tags: uplink
``(977, round, rank)``, downlink ``(1733, broadcast seq)``. Local
training seeds are the simulation's ``round_keys``.

Not ported yet, each raising ``NotImplementedError`` when set: the silo
residual store and resume, deadline/quorum rounds and fault tolerance,
the FedOpt server, the control plane, observability, serving, the WAN
world and the multi-job scheduler hooks (see ROADMAP Slice D).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.comm import (ClientManager, Message, ServerManager,
                                  create_comm_manager)
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
from fedml_tpu_torch.trainer.functional import (TrainConfig,
                                                make_batch_schedule,
                                                make_eval, make_local_train,
                                                round_lr_scale,
                                                validate_accum_steps)
from fedml_tpu_torch.utils.device import resolve_device, synchronize
from fedml_tpu_torch.utils.tracing import RoundTimer

# -- message schema (reference message_define.py) ---------------------------
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_MODEL = 2
MSG_TYPE_S2C_FINISH = 3
MSG_TYPE_C2S_SEND_MODEL = 4

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

    Aggregation is a streaming in-order prefix fold: as each report
    arrives, the contiguous worker-index prefix is folded into a weighted
    running sum (``pt.tree_weighted_fold_*``), and only out-of-order
    arrivals wait in ``model_dict``. The fold order is always ascending
    worker index, so every arrival order gives a bit-identical result.
    When every reporter had an empty shard (all weights 0) the round
    closes with uniform weights instead of a 0/0 model.
    """

    def __init__(self, worker_num: int, aggregate_fn=None):
        if aggregate_fn is not None:
            raise NotImplementedError(
                "a custom aggregate_fn (the robust rules' buffered close) is "
                "not ported yet: ROADMAP Queue 1, Slice B item 11")
        self.worker_num = worker_num
        #: the reports not yet folded (out of order, or waiting for a
        #: positive weight)
        self.model_dict: Dict[int, Dict[str, torch.Tensor]] = {}
        self.sample_num_dict: Dict[int, float] = {}
        self.flag_client_model_uploaded = [False] * worker_num
        self._reset_round()

    def add_local_trained_result(self, worker_idx: int, model_params,
                                 sample_num: float) -> None:
        """Record one report and fold the ready prefix (device work: call
        under the device lock)."""
        self.model_dict[worker_idx] = model_params
        self.sample_num_dict[worker_idx] = sample_num
        self.flag_client_model_uploaded[worker_idx] = True
        if sample_num > 0:
            self._any_pos = True
        self.buffered_peak = max(self.buffered_peak, len(self.model_dict))
        self._drain_ready()

    def check_whether_all_receive(self) -> bool:
        if all(self.flag_client_model_uploaded):
            self.flag_client_model_uploaded = [False] * self.worker_num
            return True
        return False

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

    def aggregate(self):
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

    def reported_set(self) -> set:
        """Workers whose report is in hand for the open round."""
        return set(range(self._fold_next)) | set(self.model_dict)

    def client_sampling(self, round_idx: int, client_num_in_total: int,
                        client_num_per_round: int) -> np.ndarray:
        return sample_clients(round_idx, client_num_in_total,
                              client_num_per_round)


class FedAvgServerManager(ServerManager):
    """Round-based cross-silo server with the strict all-received
    barrier."""

    def __init__(self, rank: int, size: int, com_manager,
                 aggregator: FedAvgAggregator, comm_round: int,
                 client_num_in_total: int, global_model,
                 on_round_done=None, compression=None,
                 timer: Optional[RoundTimer] = None):
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
        self.round_timer = timer if timer is not None else RoundTimer()
        #: cumulative transport bytes already credited into the timer
        self._wire_credited_up = 0
        self._wire_credited_down = 0
        #: the cohort of the open round (its round record)
        self._round_cohort: Optional[List[int]] = None
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

    def send_init_msg(self) -> None:
        idxs = self.aggregator.client_sampling(
            self.round_idx, self.client_num_in_total, self.worker_num)
        # the mirror is unset, so the first broadcast is full precision
        self._broadcast_model(MSG_TYPE_S2C_INIT_CONFIG, idxs)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_SEND_MODEL,
            self.handle_message_receive_model_from_client)

    def _finish_federation(self) -> None:
        """FINISH every silo and stop the server loop."""
        for worker in range(1, self.size):
            self.send_message(Message(MSG_TYPE_S2C_FINISH, self.rank, worker))
        self.finish()

    # -- downlink compression (comm/policy.py, comm/compression.py) ---------
    def _silos_in_sync(self) -> bool:
        """True iff some silo has confirmed a base and every reported (seq,
        fingerprint) matches the mirror: a shared compressed broadcast is
        only decodable when every silo holds the same mirror."""
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
        """One shared payload (full or mirror delta) to every silo."""
        tm = self.round_timer
        tm.begin_round(self.round_idx)
        with tm.phase("bcast_encode"):
            payload = self._encode_broadcast()
        self._round_cohort = [int(idxs[w - 1]) for w in range(1, self.size)]
        # one encode for the whole fan-out: each per-peer frame splices
        # the cached buffers and adds only its envelope keys
        shared = SharedPayload(payload)
        msgs = []
        for worker in range(1, self.size):
            msg = Message(msg_type, self.rank, worker)
            msg.add(MSG_ARG_KEY_MODEL_PARAMS, shared)
            msg.add(MSG_ARG_KEY_CLIENT_INDEX, int(idxs[worker - 1]))
            msg.add(MSG_ARG_KEY_ROUND, self.round_idx)
            msg.add(MSG_ARG_KEY_BCAST_SEQ, self._bcast_seq)
            msgs.append(msg)
        t0 = time.monotonic()
        self.com_manager.broadcast(msgs)
        tm.gauge("bcast_fanout_ms", (time.monotonic() - t0) * 1e3)

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

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        worker = msg.get_sender_id() - 1
        self._note_worker_base(msg)
        tm = self.round_timer
        with self._device_lock, tm.phase("decode"):
            payload = self._decode_model_payload(
                msg.get(MSG_ARG_KEY_MODEL_PARAMS))
            synchronize(self.device)
        t0 = time.monotonic()
        with self._device_lock, tm.phase("fold"):
            self.aggregator.add_local_trained_result(
                worker, payload, msg.get(MSG_ARG_KEY_NUM_SAMPLES))
            synchronize(self.device)
        tm.gauge("agg_fold_ms", (time.monotonic() - t0) * 1e3)
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

    def _close_round(self) -> None:
        """Aggregate, evaluate, then broadcast the next round or FINISH."""
        tm = self.round_timer
        reported = sorted(self.aggregator.reported_set())
        buffered_peak = self.aggregator.buffered_peak
        t0 = time.monotonic()
        with self._device_lock, tm.phase("fold"):
            self.global_model = self.aggregator.aggregate()
            synchronize(self.device)
        tm.gauge("agg_fold_ms", (time.monotonic() - t0) * 1e3)
        tm.gauge("agg_buffered_peak", buffered_peak)
        if self.on_round_done is not None:
            with tm.phase("eval"):
                self.on_round_done(self.round_idx, self.global_model)
        self._credit_wire_bytes()
        tm.end_round(self.round_idx, extra={
            "cohort": self._round_cohort, "reported": reported})
        self.round_idx += 1
        if self.round_idx == self.comm_round:
            self._finish_federation()
            return
        idxs = self.aggregator.client_sampling(
            self.round_idx, self.client_num_in_total, self.worker_num)
        self._broadcast_model(MSG_TYPE_S2C_SYNC_MODEL, idxs)


class FedAvgClientManager(ClientManager):
    """A silo: receives the global model, points at its sampled client's
    shard (client virtualization, reference FedAVGTrainer.update_dataset),
    runs local training, and ships ``(params, n_i)`` back."""

    def __init__(self, rank: int, size: int, com_manager,
                 dataset: FederatedDataset, module, task: str,
                 train_cfg: TrainConfig, seed: int = 0,
                 compress: bool = False, compression=None,
                 prefetch_depth: int = 2, device="cuda",
                 timer: Optional[RoundTimer] = None):
        super().__init__(rank, size, com_manager)
        self.dataset = dataset
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
        #: mass top-k did NOT send, added to the next round's delta
        self._residual = None
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

    def _handle_finish(self, msg: Message) -> None:
        if self._prefetch is not None:
            self._prefetch.close()
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

    def handle_message_init(self, msg: Message) -> None:
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
                    residual = (self._residual if self._policy.uplink_topk
                                else None)
                    payload, new_residual = compress_for_policy(
                        new_vars, variables, residual, gen, self._policy)
                    if self._policy.uplink_topk:
                        self._residual = new_residual
                else:
                    payload = to_numpy(new_vars)
        reply.add(MSG_ARG_KEY_MODEL_PARAMS, payload)
        n_i = float(self.dataset.train_data_local_num_dict[client_idx])
        reply.add(MSG_ARG_KEY_NUM_SAMPLES, n_i)
        reply.add(MSG_ARG_KEY_ROUND, round_idx)
        # the held-base report drives the server's downlink decision
        reply.add(MSG_ARG_KEY_BASE_SEQ, self._held_seq)
        reply.add(MSG_ARG_KEY_BASE_FP, tree_fingerprint(variables))
        self.send_message(reply)


#: options of the JAX launchers that the port does not run yet, with the
#: ROADMAP item that ports each; any value other than the default raises
_NOT_PORTED = {
    "checkpoint_dir": "Slice D item 22a (the silo residual store, resume)",
    "resume": "Slice D item 22a (the silo residual store, resume)",
    "token": "Slice D item 22b (transports)",
    "round_deadline_s": "Slice D item 22c (deadline/quorum, fault tolerance)",
    "heartbeat_s": "Slice D item 22c (deadline/quorum, fault tolerance)",
    "fault_plan": "Slice D item 22c (deadline/quorum, fault tolerance)",
    "server_optimizer": "Slice D item 22d (the FedOpt cross-silo server)",
    "server_checkpoint_dir": "Slice D item 23 (control plane)",
    "checkpoint_sync": "Slice D item 23 (control plane)",
    "pace_steering": "Slice D item 23 (control plane)",
    "join_rate_limit": "Slice D item 23 (control plane)",
    "serve_port": "Slice D item 23 (serving)",
    "serving": "Slice D item 23 (serving)",
    "obs_dir": "Slice D item 24 (obs)",
    "job_id": "Slice D item 24 (obs)",
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

    The signature is the JAX package's; the options the port does not run
    yet raise ``NotImplementedError`` when set, the server's here and the
    silos' and transport's in :func:`launch_federation` (``min_quorum_frac``,
    ``max_deadline_extensions``, ``server_lr``, ``server_momentum``,
    ``serve_staleness_rounds`` and ``wan_round_s`` only take effect with
    one of those, so they are accepted and unused)."""
    _refuse_not_ported(
        round_deadline_s=round_deadline_s, server_optimizer=server_optimizer,
        server_checkpoint_dir=server_checkpoint_dir,
        pace_steering=pace_steering, join_rate_limit=join_rate_limit,
        wan_trace=wan_trace, wan_profiles=wan_profiles)
    policy = resolve_compression(compression, compress=compress)

    def server_factory(size, server_com, aggregator, global_model,
                       on_round_done):
        return FedAvgServerManager(0, size, server_com, aggregator,
                                   comm_round, dataset.client_num,
                                   global_model, on_round_done=on_round_done,
                                   compression=policy)

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

    An exception in any actor stops the others and is re-raised here. A
    federation that outlasts ``join_timeout_s`` raises too: the port
    defaults ``raise_on_timeout`` to True, where the JAX package returns
    the partial history after logging the error. ``wire_codec=False`` (the
    JAX package's object hand-off, which ships no frame and counts no
    bytes) is not ported: every message crosses as an encoded frame."""
    _refuse_not_ported(
        checkpoint_dir=client_state_dir, resume=resume, token=token,
        checkpoint_sync=state_sync, heartbeat_s=heartbeat_s,
        fault_plan=fault_plan, obs_dir=obs_dir, job_id=job_id,
        comm_factory=comm_factory, device_gate=device_gate,
        serve_port=serve_port, serving=serving, wan=wan)
    if not wire_codec:
        raise NotImplementedError(
            "wire_codec=False (the object hand-off) is not ported: the "
            "in-process router always ships encoded frames")
    if addresses is not None:
        raise NotImplementedError(
            "addresses (the socket transports) are not ported yet: ROADMAP "
            "Queue 1, Slice D item 22b (transports)")
    train_cfg = train_cfg or TrainConfig()
    dev = resolve_device(device)
    policy = resolve_compression(compression, compress=compress)
    size = worker_num + 1
    router = InProcRouter() if backend.upper() in ("INPROC", "MPI") else None
    server_com = create_comm_manager(backend, 0, size, router=router)
    timer = timer if timer is not None else RoundTimer()

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

    aggregator = FedAvgAggregator(worker_num)
    server = server_factory(size, server_com, aggregator, global_model,
                            on_round_done)
    server.round_timer = timer
    clients, coms = [], [server_com]
    for rank in range(1, size):
        com = create_comm_manager(backend, rank, size, router=router)
        coms.append(com)
        clients.append(FedAvgClientManager(
            rank, size, com, dataset, module, task, train_cfg, seed=seed,
            compression=policy, prefetch_depth=prefetch_depth, device=dev,
            timer=timer))

    errors: List[BaseException] = []

    def stop_all():
        for com in coms:
            com.stop_receive_message()

    threads = [threading.Thread(target=_actor(c.run, errors, stop_all),
                                daemon=True, name=f"silo{c.rank}")
               for c in clients]
    server_thread = threading.Thread(
        target=_actor(server.run, errors, stop_all), daemon=True,
        name="server")
    for t in threads:
        t.start()
    server_thread.start()
    try:
        server.send_init_msg()
    except BaseException:
        stop_all()
        raise
    server_thread.join(timeout=join_timeout_s)
    timed_out = server_thread.is_alive()
    if timed_out:
        stop_all()
    for t in threads:
        t.join(timeout=60)
    for c in clients:
        if c._prefetch is not None:
            c._prefetch.close()
    if errors:
        raise errors[0]
    if timed_out:
        msg = (f"federation did not finish within {join_timeout_s:.0f}s "
               f"({len(history)} rounds recorded)")
        if raise_on_timeout:
            raise RuntimeError(msg)
        logging.error("%s; returning the partial history", msg)
    server._credit_wire_bytes()
    return server.global_model, history, server
