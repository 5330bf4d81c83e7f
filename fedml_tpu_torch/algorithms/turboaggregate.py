"""TurboAggregate: secure aggregation by additive shares and Lagrange
coding.

The counterpart of ``fedml_tpu/algorithms/turboaggregate.py``. Reference
scaffolding (fedml_api/distributed/turboaggregate/): the MPC toolbox
(mpc_function.py) and a TA_Aggregator whose ``aggregate`` is still a plain
weighted mean (TA_Aggregator.py:56-84). Assembled here into a working
secure-sum round:

1. each client quantizes its weighted model to the field (fixed point,
   core/mpc.py) and splits it into N additive shares (Gen_Additive_SS),
   one per peer;
2. every peer sums the shares it received, and sees only uniformly random
   residues;
3. the server adds the N share sums and dequantizes: the masks cancel and
   the result is the weighted sum mod p. LCC coding of the share vectors
   (lcc_encoding / lcc_decoding) adds dropout resilience: any K+T of the N
   coded evaluations reconstruct.

The float <-> field boundary is the only approximation (2^-frac_bits
round-off per client); the protocol itself is exact. The whole state dict
goes through it, a model's BatchNorm statistics too, as the JAX package's
variables do: the field holds a coordinate's sum of ``n_i * value`` below
``p / 2**(frac_bits + 1)`` (2**14 at the defaults), past which it wraps in
both packages alike. The share exchange is numpy int64 arithmetic on the
host, so a round copies the clients' models off the device; local training
stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.core import pytree as pt


@dataclasses.dataclass(frozen=True)
class TurboAggregateConfig:
    prime: int = mpc.DEFAULT_PRIME
    frac_bits: int = 16
    seed: int = 0


class SecureAggregator:
    """Server and client share logic for one secure weighted-mean round:
    the same inputs (stacked client state dicts, weights) and output (the
    weighted mean) as FedAvg's aggregation, computed through the share
    protocol on the host, for the cross-silo trust model where no single
    party may see a raw update."""

    def __init__(self, config: Optional[TurboAggregateConfig] = None):
        self.cfg = config or TurboAggregateConfig()

    def client_shares(self, flat_weighted: np.ndarray, n_peers: int,
                      rng: np.random.RandomState) -> np.ndarray:
        """One client: quantize its (w_i * n_i) flat vector, split into
        ``n_peers`` additive shares [n_peers, d]."""
        q = mpc.quantize(flat_weighted, self.cfg.prime, self.cfg.frac_bits)
        return mpc.gen_additive_ss(q, n_peers, self.cfg.prime, rng)

    def aggregate(self, stacked, weights, round_idx: int = 0):
        """Run the protocol over a stacked state dict of client models.

        Returns the weighted-mean state dict (on the models' device), equal
        to ``tree_weighted_mean`` up to fixed-point round-off. ``round_idx``
        seeds the masks: masks reused across rounds would let a peer
        difference its shares between rounds and recover a client's
        update."""
        weights = np.asarray(torch.as_tensor(weights).cpu(), np.float64)
        n = len(weights)
        rng = np.random.RandomState(
            np.random.SeedSequence([self.cfg.seed, round_idx]
                                   ).generate_state(1)[0])
        clients = pt.tree_unstack(stacked, n)
        template = clients[0]
        flats = [pt.tree_ravel(c).cpu().numpy().astype(np.float64) * w
                 for c, w in zip(clients, weights)]
        # peer j accumulates the j-th share from every client
        peer_sums = np.zeros((n, flats[0].size), dtype=np.int64)
        for i in range(n):
            shares = self.client_shares(flats[i], n, rng)
            peer_sums = (peer_sums + shares) % self.cfg.prime
        total_q = peer_sums.sum(axis=0) % self.cfg.prime
        total = mpc.dequantize(total_q, self.cfg.prime, self.cfg.frac_bits)
        mean = torch.from_numpy((total / weights.sum()).astype(np.float32))
        device = next(iter(template.values())).device
        return pt.tree_unravel(template, mean.to(device))


def coded_share_exchange(share_matrix: np.ndarray, K: int, T: int,
                         n_workers: int, prime: int,
                         rng: np.random.RandomState):
    """LCC-code a [m, d] share block for dropout resilience: any K+T of the
    ``n_workers`` coded rows reconstruct the block (the TA ring's redundancy
    mechanism)."""
    coded = mpc.lcc_encoding(share_matrix, n_workers, K, T, prime, rng)

    def reconstruct(surviving_idx):
        return mpc.lcc_decoding(coded[np.asarray(surviving_idx)], n_workers,
                                K, T, surviving_idx, prime)

    return coded, reconstruct


class SecureFedAvgAPI(FedAvgAPI):
    """FedAvg whose server step is the secure-sum protocol: FedAvgAPI's
    round (seeded sampling, local training on the device) with the host
    share exchange as its aggregation (reference
    fedml_api/distributed/turboaggregate/TA_Aggregator.py)."""

    def __init__(self, dataset, module, task: str = "classification",
                 config=None,
                 secure_config: Optional[TurboAggregateConfig] = None,
                 device="cuda"):
        self._secure = SecureAggregator(secure_config)
        self._secure_round = 0

        def hook(variables, stacked, weights, agg_seed):
            return self._secure.aggregate(stacked, weights,
                                          round_idx=self._secure_round)
        super().__init__(dataset, module, task=task, config=config,
                         aggregate_hook=hook, device=device)

    def run_round(self, round_idx: int):
        self._secure_round = round_idx  # the round's masks
        return super().run_round(round_idx)


# the secure server step is a host-side share exchange that no captured
# round can hold, so this API has no fused driver (fused_rounds() raises
# rather than skip the protocol)
SecureFedAvgAPI._fused_driver_cls = None
