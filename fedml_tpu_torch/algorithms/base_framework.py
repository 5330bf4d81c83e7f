"""Minimal algorithm templates over the cross-silo comm layer (the port's
copy of ``fedml_tpu/algorithms/base_framework.py``).

Two reference components re-expressed:

* **base_framework** (fedml_api/distributed/base_framework/ — algorithm_api.py:16,
  central_manager.py:8, central_worker.py:4, client_manager.py:6,
  client_worker.py:1): the smallest centralized-topology algorithm — each
  client sends a scalar/pytree "information" to the server, the server sums
  (central_worker.py:28) and broadcasts the result, for ``max_round`` rounds.
  New algorithms clone this skeleton and swap the local/global computation.

* **decentralized_framework** (fedml_api/distributed/decentralized_framework/
  — algorithm_api.py:15, decentralized_worker_manager.py:8): the serverless
  template — every rank is a worker; each round it sends its local result to
  its out-neighbors from a ``SymmetricTopologyManager`` ring+random topology
  and averages what it receives (handle_msg_from_neighbor:29, __train:41).

Unlike the reference (one MPI process per rank, ``MPI.COMM_WORLD.Abort()`` to
stop), ranks here are threads over a pluggable backend (inproc for tests/sim,
TCP/gRPC cross-silo) and termination is a clean stop message. The
"information" may be any nest of dicts, lists and tuples over numbers and
numpy arrays (what the wire codec carries). The JAX package sums it with
``jnp.add``, so its scalars come back as f32 arrays; here the sum is
Python's and numpy's own (a Python float stays a float64), so the two agree
to f32 precision, not bit for bit.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from fedml_tpu_torch.comm.inproc import InProcCommManager, InProcRouter
from fedml_tpu_torch.comm.manager import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.topology import SymmetricTopologyManager
from fedml_tpu_torch.utils.context import FederationErrors, federation_guard

# message schema (base_framework/message_define.py)
MSG_TYPE_S2C_INIT = 1
MSG_TYPE_C2S_INFORMATION = 2
MSG_TYPE_S2C_SYNC = 3
MSG_TYPE_FINISH = 4
MSG_ARG_KEY_INFORMATION = "information"
MSG_ARG_KEY_ROUND = "round_idx"


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    return fn(tree, *rest)


def _tree_sum(trees: List[Any]) -> Any:
    acc = trees[0]
    for t in trees[1:]:
        acc = _tree_map(lambda a, b: a + b, acc, t)
    return acc


class BaseCentralWorker:
    """Server-side aggregation state (central_worker.py:4-34): collect one
    information per client, aggregate by summation when all arrived."""

    def __init__(self, client_num: int,
                 aggregate_fn: Callable[[List[Any]], Any] = _tree_sum):
        self.client_num = client_num
        self.aggregate_fn = aggregate_fn
        self._store: Dict[int, Any] = {}

    def add_client_local_result(self, index: int, info: Any) -> None:
        self._store[index] = info

    def check_whether_all_receive(self) -> bool:
        return len(self._store) == self.client_num

    def aggregate(self) -> Any:
        out = self.aggregate_fn([self._store[i] for i in sorted(self._store)])
        self._store.clear()
        return out


class BaseClientWorker:
    """Client-side local computation (client_worker.py:1-12). Subclass and
    override :meth:`local_compute` to build a real algorithm."""

    def __init__(self, client_index: int,
                 local_fn: Optional[Callable[[Any, int], Any]] = None):
        self.client_index = client_index
        self._local_fn = local_fn

    def local_compute(self, global_info: Any, round_idx: int) -> Any:
        if self._local_fn is not None:
            return self._local_fn(global_info, round_idx)
        # reference demo: every client contributes its index + round noise-free
        return float(self.client_index + 1)


class BaseCentralManager(ServerManager):
    """central_manager.py:8-49: broadcast init, await all informations,
    aggregate, broadcast sync; finish after ``max_round`` rounds."""

    def __init__(self, com_manager, worker: BaseCentralWorker, client_num: int,
                 max_round: int, init_info: Any = 0.0):
        super().__init__(0, client_num + 1, com_manager)
        self.worker = worker
        self.client_num = client_num
        self.max_round = max_round
        self.round_idx = 0
        self.init_info = init_info
        self.global_history: List[Any] = []

    def run(self) -> None:
        self.register_message_receive_handlers()
        if self.max_round <= 0:
            for cid in range(1, self.client_num + 1):
                self.send_message(Message(MSG_TYPE_FINISH, 0, cid))
            self.finish()
            return
        for cid in range(1, self.client_num + 1):
            msg = Message(MSG_TYPE_S2C_INIT, 0, cid)
            msg.add(MSG_ARG_KEY_INFORMATION, self.init_info)
            msg.add(MSG_ARG_KEY_ROUND, 0)
            self.send_message(msg)
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MSG_TYPE_C2S_INFORMATION, self.handle_message_receive_information)

    def handle_message_receive_information(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        self.worker.add_client_local_result(
            sender - 1, msg.get(MSG_ARG_KEY_INFORMATION))
        if not self.worker.check_whether_all_receive():
            return
        global_info = self.worker.aggregate()
        self.global_history.append(global_info)
        self.round_idx += 1
        done = self.round_idx >= self.max_round
        for cid in range(1, self.client_num + 1):
            out = Message(MSG_TYPE_FINISH if done else MSG_TYPE_S2C_SYNC,
                          0, cid)
            out.add(MSG_ARG_KEY_INFORMATION, global_info)
            out.add(MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(out)
        if done:
            self.finish()


class BaseClientManager(ClientManager):
    """client_manager.py:6-38: on init/sync run local computation and send the
    information to the server; stop on finish."""

    def __init__(self, com_manager, worker: BaseClientWorker, rank: int,
                 size: int):
        super().__init__(rank, size, com_manager)
        self.worker = worker

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MSG_TYPE_S2C_INIT,
                                              self._handle_sync)
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC,
                                              self._handle_sync)
        self.register_message_receive_handler(MSG_TYPE_FINISH,
                                              self._handle_finish)

    def _handle_sync(self, msg: Message) -> None:
        info = self.worker.local_compute(msg.get(MSG_ARG_KEY_INFORMATION),
                                         msg.get(MSG_ARG_KEY_ROUND))
        out = Message(MSG_TYPE_C2S_INFORMATION, self.rank, 0)
        out.add(MSG_ARG_KEY_INFORMATION, info)
        self.send_message(out)

    def _handle_finish(self, msg: Message) -> None:
        self.finish()


@dataclass
class BaseFrameworkResult:
    global_history: List[Any] = field(default_factory=list)


def _run_rank_threads(managers: List[Any], timeout: float = 60.0) -> None:
    """Run every manager's event loop on its own thread; re-raise the first
    handler exception on the caller (a dead rank otherwise deadlocks the
    federation and the launcher would silently return partial results)."""
    errors = FederationErrors()

    def runner(rank, m):
        with federation_guard(errors, managers, rank=rank):
            m.run()

    threads = [threading.Thread(target=runner, args=(i, m), daemon=True)
               for i, m in enumerate(managers)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout  # shared: N joins, one budget
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    errors.reraise()
    if any(t.is_alive() for t in threads):
        raise TimeoutError(
            f"federation did not terminate within {timeout:.0f}s "
            "(a rank is blocked waiting for a message)")


def run_base_framework_distributed(
        client_num: int, max_round: int,
        local_fn: Optional[Callable[[Any, int], Any]] = None,
        aggregate_fn: Callable[[List[Any]], Any] = _tree_sum,
        init_info: Any = 0.0) -> BaseFrameworkResult:
    """FedML_Base_distributed (algorithm_api.py:16-40) on the inproc fabric:
    spawn server + ``client_num`` client threads, run to completion."""
    router = InProcRouter()
    size = client_num + 1
    server = BaseCentralManager(
        InProcCommManager(router, 0, size),
        BaseCentralWorker(client_num, aggregate_fn), client_num, max_round,
        init_info)
    clients = [
        BaseClientManager(InProcCommManager(router, r, size),
                          BaseClientWorker(r - 1, local_fn), r, size)
        for r in range(1, size)
    ]
    _run_rank_threads([server] + clients)
    return BaseFrameworkResult(global_history=server.global_history)


# ---------------------------------------------------------------------------
# decentralized_framework: serverless neighbor-gossip template
# ---------------------------------------------------------------------------

MSG_TYPE_NEIGHBOR_RESULT = 10


class DecentralizedWorkerManager(ClientManager):
    """decentralized_worker_manager.py:8-56: each round, send local result to
    out-neighbors, average own + received when all in-neighbors reported."""

    def __init__(self, com_manager, rank: int, size: int,
                 topology: SymmetricTopologyManager, max_round: int,
                 local_fn: Optional[Callable[[Any, int], Any]] = None,
                 init_value: Any = None):
        super().__init__(rank, size, com_manager)
        self.topology = topology
        # the topology is immutable after generate_topology(); cache the
        # neighbor lists instead of rescanning a matrix row per message
        self.in_neighbors: List[int] = list(
            topology.get_in_neighbor_idx_list(rank))
        self.out_neighbors: List[int] = list(
            topology.get_out_neighbor_idx_list(rank))
        self.max_round = max_round
        self.round_idx = 0
        self._local_fn = local_fn
        self.value = (float(rank + 1) if init_value is None else init_value)
        # inbox buffered per round: neighbors run unsynchronized, so a fast
        # neighbor's round-(r+1) result can arrive before our round r closes
        self._inbox: Dict[int, Dict[int, Any]] = {}
        self.history: List[Any] = []
        self.done = threading.Event()

    def run(self) -> None:
        self.register_message_receive_handlers()
        if self.max_round <= 0 or not self.in_neighbors:
            # nothing to gossip with (singleton topology) or nothing to do:
            # run the local computation alone and terminate cleanly instead
            # of blocking on a message that will never come
            for r in range(max(0, self.max_round)):
                if self._local_fn is not None:
                    self.value = self._local_fn(self.value, r)
                self.history.append(self.value)
            self.round_idx = max(0, self.max_round)
            self.done.set()
            self.finish()
            return
        self._start_round()
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(MSG_TYPE_NEIGHBOR_RESULT,
                                              self.handle_msg_from_neighbor)

    def _start_round(self) -> None:
        if self._local_fn is not None:
            self.value = self._local_fn(self.value, self.round_idx)
        for nb in self.out_neighbors:
            msg = Message(MSG_TYPE_NEIGHBOR_RESULT, self.rank, nb)
            msg.add(MSG_ARG_KEY_INFORMATION, self.value)
            msg.add(MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(msg)

    def handle_msg_from_neighbor(self, msg: Message) -> None:
        rnd = msg.get(MSG_ARG_KEY_ROUND)
        self._inbox.setdefault(rnd, {})[msg.get_sender_id()] = msg.get(
            MSG_ARG_KEY_INFORMATION)
        # drain every already-complete round (later rounds may have fully
        # buffered while this one was still open)
        while True:
            cur = self._inbox.get(self.round_idx, {})
            if len(cur) < len(self.in_neighbors):
                return
            vals = [self.value] + [cur[i] for i in sorted(cur)]
            self.value = _tree_map(lambda x: x * (1.0 / len(vals)),
                                    _tree_sum(vals))
            self.history.append(self.value)
            del self._inbox[self.round_idx]
            self.round_idx += 1
            if self.round_idx >= self.max_round:
                self.done.set()
                self.finish()
                return
            self._start_round()


def run_decentralized_framework_demo(
        worker_num: int, max_round: int,
        neighbor_num: int = 2,
        local_fn: Optional[Callable[[Any, int], Any]] = None
) -> List["DecentralizedWorkerManager"]:
    """FedML_Decentralized_Demo_distributed (algorithm_api.py:15-33): build a
    ``SymmetricTopology(n, 2)``, run every rank as a gossip worker thread."""
    topo = SymmetricTopologyManager(worker_num, neighbor_num)
    topo.generate_topology()
    router = InProcRouter()
    workers = [
        DecentralizedWorkerManager(
            InProcCommManager(router, r, worker_num), r, worker_num, topo,
            max_round, local_fn)
        for r in range(worker_num)
    ]
    _run_rank_threads(workers)
    return workers
