"""Straggler-tolerant aggregation: quorum rounds and fully-async FedAvg
(the port's counterpart of ``fedml_tpu/algorithms/fedavg_async.py``).

The reference's server blocks on the all-received barrier
(FedAVGAggregator.py:50-56), so one dead or slow silo stalls the
federation. Two relaxations on the cross-silo actor protocol:

* :class:`QuorumFedAvgServerManager` closes the round when every worker
  reported, or when its deadline passes with at least ``quorum`` updates
  in; a late reply carries its round tag and is discarded (its silo
  trains the next broadcast like everyone else). The deadline is the
  parent's self-addressed TIMEOUT message, so the state machine stays on
  the receive thread.
* :class:`AsyncFedAvgServerManager` is FedAsync (Xie et al., 2019,
  arXiv:1903.03934): no rounds; every arriving update is merged at once
  with the staleness-decayed weight ``alpha * (staleness + 1) **
  -poly_a`` and its worker is re-dispatched at the newest version. The
  merge is an elementwise axpy on the device (``core/pytree.tree_axpy``),
  as the JAX package computes it outside any kernel.

Both reuse the FedAvg message schema and the round tag every reply
carries (``MSG_ARG_KEY_ROUND``).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List

import numpy as np

from fedml_tpu_torch.algorithms.fedavg_cross_silo import (
    MSG_ARG_KEY_CLIENT_INDEX, MSG_ARG_KEY_MODEL_PARAMS,
    MSG_ARG_KEY_NUM_SAMPLES, MSG_ARG_KEY_ROUND, MSG_TYPE_S2C_SYNC_MODEL,
    FedAvgServerManager, launch_federation)
from fedml_tpu_torch.comm.compression import (is_compressed, to_numpy,
                                              tree_to_device)
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.policy import CompressionPolicy, resolve_compression
from fedml_tpu_torch.control import build_control_plane
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.utils.device import synchronize


class QuorumFedAvgServerManager(FedAvgServerManager):
    """The all-received barrier relaxed to (all | deadline and quorum).

    The deadline timer is the parent's; only the close policy differs: an
    absolute ``quorum`` count instead of the parent's live fraction with
    eviction. ``partial_rounds`` lists the rounds closed at a deadline."""

    def __init__(self, *args, quorum: int = 1,
                 round_deadline_s: float = 10.0, **kw):
        # the parent's deadline stays unset (no eviction); the timer reads
        # round_deadline_s, set after init
        super().__init__(*args, **kw)
        if not (1 <= quorum <= self.worker_num):
            raise ValueError(f"quorum {quorum} outside [1, {self.worker_num}]")
        self.quorum = quorum
        self.round_deadline_s = round_deadline_s
        self.partial_rounds: List[int] = []

    def _capture_extra(self, state) -> None:
        state["partial_rounds"] = [int(r) for r in self.partial_rounds]
        state["quorum"] = int(self.quorum)

    def _restore_extra(self, state) -> None:
        self.partial_rounds = [int(r) for r in state["partial_rounds"]]
        # the deadline may have been steered; the absolute quorum is the
        # launch's configuration and only checked
        if int(state["quorum"]) != self.quorum:
            logging.warning(
                "restored snapshot was taken at quorum=%s, this launch "
                "uses %d: continuing with the launch's", state.get("quorum"),
                self.quorum)

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        # the base is noted before the stale discard: a straggler's reply
        # still reports which model the silo holds
        self._note_worker_base(msg)
        if msg.get_params().get(MSG_ARG_KEY_ROUND,
                                self.round_idx) != self.round_idx:
            self.ft_counters["stale_replies"] += 1
            return  # a straggler's reply to a closed round
        worker = msg.get_sender_id() - 1
        if self._bcast_at is not None:
            self.liveness.observe_report_latency(
                worker, time.monotonic() - self._bcast_at)
        tm = self.round_timer
        with self._device_lock, tm.phase("fold"):
            payload = self._decode_model_payload(
                msg.get(MSG_ARG_KEY_MODEL_PARAMS))
            self.aggregator.add_local_trained_result(
                worker, payload, msg.get(MSG_ARG_KEY_NUM_SAMPLES))
            synchronize(self.device)
        if self.aggregator.check_whether_all_receive():
            # everyone reported: aggregate_available == aggregate
            self._close_round(partial=True)

    def handle_round_timeout(self, msg: Message) -> None:
        if msg.get(MSG_ARG_KEY_ROUND) != self.round_idx:
            return  # the tick of a round already closed
        received = self.aggregator.received_count()
        if received >= self.quorum:
            self.partial_rounds.append(self.round_idx)
            # every silo receives every broadcast in order, so a straggler
            # whose reply is discarded still holds the mirror's base
            self._close_round(partial=True)
            return
        # below quorum: wait on, within the extension budget
        if self._note_deadline_extension():
            self._fail_schedule(
                f"round {self.round_idx} is still below quorum "
                f"({received}/{self.quorum} updates) after "
                f"{self._extensions_this_round - 1} deadline extensions "
                f"(max_deadline_extensions={self._max_extensions}): the "
                "federation cannot make progress; final state "
                "checkpointed")
            return
        if self.obs is not None:
            self.obs.note_anomaly(
                "deadline_extension", self.round_idx,
                {"reported": int(received), "need": int(self.quorum),
                 "extensions": int(self._extensions_this_round)})
        self._save_control_snapshot()
        self._arm_deadline()


class AsyncFedAvgServerManager(FedAvgServerManager):
    """FedAsync: merge every update on arrival, staleness-decayed.
    ``update_log`` holds one ``{version, staleness, mix, worker}`` a
    merge. Delta compression is refused (full precision): the global
    model moves every update, so no delta base is stable."""

    def __init__(self, *args, alpha: float = 0.6, poly_a: float = 0.5,
                 max_updates: int = 100, **kw):
        kw.setdefault("comm_round", max_updates)
        super().__init__(*args, **kw)
        if self._policy.enabled:
            logging.warning(
                "compression policy %r requested with the FedAsync server: "
                "FedAsync has no stable delta base (the global model moves "
                "every update); staying full precision",
                self._policy.name)
            self._policy = CompressionPolicy("none")
        self.alpha = alpha
        self.poly_a = poly_a
        self.max_updates = max_updates
        self.version = 0
        self.update_log: List[Dict] = []
        #: set when a silo sends a compressed update (a misconfiguration)
        self.config_error = None

    def staleness_weight(self, staleness: int) -> float:
        return self.alpha * float(staleness + 1) ** (-self.poly_a)

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        if self.version >= self.max_updates:
            return
        client_version = msg.get_params().get(MSG_ARG_KEY_ROUND, 0)
        staleness = max(0, self.version - client_version)
        a = self.staleness_weight(staleness)
        w_client = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        if is_compressed(w_client):
            # raising here would only end this receive loop and hang every
            # silo: tear the federation down loudly instead
            self.config_error = ValueError(
                "FedAsync cannot use delta compression (int8 or top-k): "
                "the global model moves every update, so the silo's base "
                "is stale at decompression time; run the silos with "
                "compression policy 'none'")
            logging.error("%s", self.config_error)
            self._finish_federation()
            return
        with self._device_lock:
            update = tree_to_device(w_client, self.device)
            self.global_model = pt.tree_axpy(
                a, update, pt.tree_scale(self.global_model, 1.0 - a))
            synchronize(self.device)
        self.version += 1
        self.update_log.append({"version": self.version,
                                "staleness": staleness, "mix": a,
                                "worker": msg.get_sender_id() - 1})
        if self.on_round_done is not None:
            self.on_round_done(self.version, self.global_model)
        if self.version >= self.max_updates:
            self._finish_federation()
            return
        # re-dispatch this worker at the newest version
        rng = np.random.RandomState(self.version)
        client_idx = int(rng.randint(0, self.client_num_in_total))
        out = Message(MSG_TYPE_S2C_SYNC_MODEL, self.rank, msg.get_sender_id())
        with self._device_lock:
            out.add(MSG_ARG_KEY_MODEL_PARAMS, to_numpy(self.global_model))
        out.add(MSG_ARG_KEY_CLIENT_INDEX, client_idx)
        out.add(MSG_ARG_KEY_ROUND, self.version)
        self.send_message(out)


def run_fedavg_async(dataset, module, task: str = "classification",
                     worker_num: int = 2, mode: str = "quorum",
                     comm_round: int = 2, quorum: int = 1,
                     round_deadline_s: float = 10.0, alpha: float = 0.6,
                     poly_a: float = 0.5, max_updates: int = 20,
                     train_cfg=None, seed: int = 0,
                     backend: str = "INPROC", addresses=None,
                     wire_codec: bool = True, compression=None,
                     timer=None, heartbeat_s: float = 0.0,
                     fault_plan=None,
                     server_checkpoint_dir=None,
                     checkpoint_sync: bool = False,
                     pace_steering: bool = False,
                     join_rate_limit: float = 0.0,
                     max_deadline_extensions=25,
                     join_timeout_s: float = 600.0,
                     device="cuda", init_variables=None):
    """Launch a straggler-tolerant federation (a server and ``worker_num``
    silo threads over any backend) and block until it completes.
    ``mode="quorum"`` closes rounds at (all | deadline and quorum);
    ``mode="fedasync"`` merges every arriving update with the
    staleness-decayed weight. Returns ``(final global model, history,
    server)``; the server has ``partial_rounds`` (quorum) or
    ``update_log`` (fedasync).

    The scaffolding is :func:`~fedml_tpu_torch.algorithms.
    fedavg_cross_silo.launch_federation`'s; only the server differs. The
    quorum server runs the control plane (``server_checkpoint_dir``,
    ``checkpoint_sync``, ``pace_steering``, ``join_rate_limit``, see
    ``run_fedavg_cross_silo``); FedAsync has no round schedule to
    snapshot or steer, so there they are refused with a warning and not
    applied, as in the JAX package. ``wire_codec=False`` (the JAX
    package's in-process object hand-off, its default here) is not
    ported: every message crosses as an encoded frame."""
    if mode not in ("quorum", "fedasync"):
        raise ValueError(f"unknown async mode: {mode!r} "
                         "(quorum | fedasync)")
    policy = resolve_compression(compression)
    if mode == "fedasync" and policy.enabled:
        # FedAsync has no stable delta base: every silo runs full
        # precision, so the server's config_error path never fires
        logging.warning(
            "compression policy %r requested with mode='fedasync': the "
            "global model moves every update, so delta compression has no "
            "stable base; running full precision", policy.name)
        policy = CompressionPolicy("none")
    if mode == "fedasync" and (server_checkpoint_dir or pace_steering):
        logging.warning(
            "server checkpoint/pace steering requested with "
            "mode='fedasync': FedAsync has no round schedule to "
            "checkpoint or steer; ignoring (use mode='quorum' or the "
            "round-based servers)")
    control = (build_control_plane(
        server_checkpoint_dir=server_checkpoint_dir,
        pace_steering=pace_steering, join_rate_limit=join_rate_limit,
        round_deadline_s=round_deadline_s,
        max_deadline_extensions=max_deadline_extensions,
        checkpoint_sync=checkpoint_sync)
        if mode == "quorum" else {})

    def server_factory(size, server_com, aggregator, global_model,
                       on_round_done):
        if mode == "quorum":
            return QuorumFedAvgServerManager(
                0, size, server_com, aggregator, comm_round,
                dataset.client_num, global_model, quorum=quorum,
                round_deadline_s=round_deadline_s,
                on_round_done=on_round_done, compression=policy,
                **control)
        return AsyncFedAvgServerManager(
            0, size, server_com, aggregator,
            client_num_in_total=dataset.client_num,
            global_model=global_model, alpha=alpha, poly_a=poly_a,
            max_updates=max_updates, on_round_done=on_round_done)

    return launch_federation(dataset, module, task, worker_num, train_cfg,
                             server_factory, backend=backend,
                             addresses=addresses, seed=seed,
                             wire_codec=wire_codec, compression=policy,
                             timer=timer, raise_on_timeout=True,
                             join_timeout_s=join_timeout_s,
                             heartbeat_s=heartbeat_s, fault_plan=fault_plan,
                             device=device, init_variables=init_variables)
