"""Decentralized communication topologies as mixing matrices (the port's
copy of ``fedml_tpu/core/topology.py``, numpy only).

The reference builds ring-plus-random-link graphs with networkx and exposes
per-node neighbor index/weight queries
(fedml_core/distributed/topology/{base,symmetric,asymmetric}_topology_manager.py).
On the device the topology's real consumer is the gossip *mixing step*: the whole
round is ``params' = W @ params`` over the stacked client parameters (one
einsum, or a ``ppermute`` chain for a pure ring) — so the first-class object
here is the row-normalized mixing matrix ``W``. The neighbor-query API is kept
for parity with the reference ABC (base_topology_manager.py:4-23).

``nx.watts_strogatz_graph(n, k, 0)`` (rewiring probability 0) is a ring
lattice: node i connects to i±1..i±k//2 (mod n); we construct it directly.
"""

from __future__ import annotations

import abc

import numpy as np

from fedml_tpu_torch.core.sampling import locked_global_numpy_rng


def ring_lattice_adjacency(n: int, k: int) -> np.ndarray:
    """Adjacency of a ring lattice where each node links to k//2 neighbors on
    each side — identical to watts_strogatz_graph(n, k, p=0)."""
    adj = np.zeros((n, n), dtype=np.float32)
    for off in range(1, k // 2 + 1):
        idx = np.arange(n)
        adj[idx, (idx + off) % n] = 1
        adj[idx, (idx - off) % n] = 1
    return adj


class BaseTopologyManager(abc.ABC):
    """Neighbor-query ABC (parity: base_topology_manager.py:4-23)."""

    topology: np.ndarray

    @abc.abstractmethod
    def generate_topology(self):
        ...

    def get_in_neighbor_weights(self, node_index: int):
        if node_index >= self.n:
            return []
        return self.topology[:, node_index] if self._directed else self.topology[node_index]

    def get_out_neighbor_weights(self, node_index: int):
        if node_index >= self.n:
            return []
        return self.topology[node_index]

    def get_in_neighbor_idx_list(self, node_index: int):
        w = self.get_in_neighbor_weights(node_index)
        return [i for i, wi in enumerate(w) if wi > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index: int):
        w = self.get_out_neighbor_weights(node_index)
        return [i for i, wi in enumerate(w) if wi > 0 and i != node_index]

    def get_mixing_matrix(self) -> np.ndarray:
        """Row-normalized weight matrix W; gossip step is W @ stacked_params."""
        return np.asarray(self.topology)

    _directed = False


class SymmetricTopologyManager(BaseTopologyManager):
    """Undirected ring ∪ random symmetric links, row-normalized.

    Parity target: symmetric_topology_manager.py:7-52 — union of the ring
    lattice with a k-neighbor ring lattice (the reference's ws(n,k,0)), ones on
    the diagonal, each row divided by its degree.
    """

    def __init__(self, n: int, neighbor_num: int = 2):
        self.n = n
        self.neighbor_num = neighbor_num
        self.topology = np.zeros((n, n), dtype=np.float32)

    def generate_topology(self):
        ring = ring_lattice_adjacency(self.n, 2)
        extra = ring_lattice_adjacency(self.n, int(self.neighbor_num))
        adj = np.maximum(ring, extra)
        np.fill_diagonal(adj, 1)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
        return self.topology


class AsymmetricTopologyManager(BaseTopologyManager):
    """Directed variant: symmetric base plus random directed out-links, then
    row normalization (parity: asymmetric_topology_manager.py:7-80). Rows sum
    to one but columns need not — push-sum style correction is the consumer's
    job (see algorithms/decentralized pushsum)."""

    _directed = True

    def __init__(self, n: int, undirected_neighbor_num: int = 3, out_directed_neighbor: int = 3):
        self.n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        self.topology = np.zeros((n, n), dtype=np.float32)

    def generate_topology(self):
        base = np.maximum(
            ring_lattice_adjacency(self.n, 2),
            ring_lattice_adjacency(self.n, self.undirected_neighbor_num),
        )
        np.fill_diagonal(base, 1)
        # coin-flip extra directed links on the zero entries, avoiding
        # creating a link where the reverse direction was already added this way
        added = set()
        # the coin flips ride the caller-seeded GLOBAL stream (the
        # decentralized driver's reference parity); lock so a concurrent
        # sample_clients cannot interleave its seed/draw pair
        with locked_global_numpy_rng():
            flip_rows = [np.random.randint(2, size=len(np.where(base[i] == 0)[0]))
                         for i in range(self.n)]
        for i in range(self.n):
            zeros = np.where(base[i] == 0)[0]
            for j, flip in zip(zeros, flip_rows[i]):
                if flip == 1 and (j, i) not in added:
                    base[i, j] = 1
                    added.add((i, j))
        self.topology = base / base.sum(axis=1, keepdims=True)
        return self.topology


def ring_mixing_matrix(n: int) -> np.ndarray:
    """Uniform ring: self + two neighbors at weight 1/3 — the pure-ppermute
    case for on-mesh gossip."""
    mgr = SymmetricTopologyManager(n, 2)
    return mgr.generate_topology()
