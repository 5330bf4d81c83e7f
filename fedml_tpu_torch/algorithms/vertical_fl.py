"""Classical vertical FL: one guest (it holds the labels) and N hosts (features
only), the counterpart of ``fedml_tpu/algorithms/vertical_fl.py``.

Reference protocol (fedml_api/standalone/classical_vertical_fl/ and
distributed/classical_vertical_fl/): every party computes a logit
component ``U_p = dense_p(local_p(x_p))`` on its own feature columns; the
guest sums the components, takes the BCE-with-logits loss against the
labels it alone holds, and sends ``dL/dU`` back (party_models.py:57-75):
the same gradient for every party, since ``U = sum_p U_p``. Each party then
backpropagates through its own stack with plain SGD (no momentum).

A party's update recomputes its forward and backpropagates the received
``dL/dU`` (the JAX package's ``jax.vjp``), so nothing but ``U_p`` and
``dL/dU`` (``[batch, 1]``) crosses a party boundary, the reference's wire.
Each epoch's batch order is ``np.random.RandomState(seed).permutation``, the
JAX package's numpy stream, and the last partial batch is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core.sampling import derive_seed, make_generator
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.models.vfl import VFLDenseModel, VFLFeatureExtractor
from fedml_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VFLConfig:
    epochs: int = 5
    batch_size: int = 64
    lr: float = 0.01
    seed: int = 0


class VFLParty:
    """One party's stack: a feature extractor and a dense logit head,
    trained by plain SGD. The guest and the hosts differ only in the head's
    bias (reference VFLGuestModel and VFLHostModel) and in who computes the
    loss."""

    def __init__(self, input_dim: int, cfg: VFLConfig, with_bias: bool,
                 generator: torch.Generator, hidden_dims=(32, 16),
                 device="cuda"):
        self.device = resolve_device(device)
        self.local = init_params(VFLFeatureExtractor(input_dim, hidden_dims),
                                 generator).to(self.device)
        self.dense = init_params(VFLDenseModel(self.local.output_dim,
                                               use_bias=with_bias),
                                 generator).to(self.device)
        self.lr = cfg.lr

    def parameters(self) -> List[torch.Tensor]:
        return [*self.local.parameters(), *self.dense.parameters()]

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(self.local(x))

    @torch.no_grad()
    def send_components(self, x: torch.Tensor) -> torch.Tensor:
        """``U_p`` of a batch of this party's features."""
        return self._forward(x)

    def receive_gradients(self, x: torch.Tensor,
                          grad_u: torch.Tensor) -> None:
        """Recompute the forward, backpropagate ``dL/dU`` and take the SGD
        step ``p - lr * g``."""
        params = self.parameters()
        grads = torch.autograd.grad(self._forward(x), params, grad_u)
        with torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-self.lr)


def guest_loss_and_grad(u_total: torch.Tensor, y: torch.Tensor):
    """The mean BCE-with-logits over the summed components and its gradient
    ``dL/dU``: the guest's ``_compute_common_gradient_and_loss``
    (party_models.py:57-69)."""
    u = u_total.detach().requires_grad_(True)
    loss = F.binary_cross_entropy_with_logits(u.squeeze(-1), y.to(u.dtype))
    (grad,) = torch.autograd.grad(loss, u)
    return loss.detach(), grad


class VerticalMultiplePartyLogisticRegressionFederatedLearning:
    """The batch-level orchestrator (reference standalone/
    classical_vertical_fl/vfl.py:1-60)."""

    def __init__(self, guest: VFLParty, hosts: List[VFLParty]):
        self.guest = guest
        self.hosts = hosts

    def fit_batch(self, x_parts: List[torch.Tensor],
                  y: torch.Tensor) -> torch.Tensor:
        """``x_parts[0]`` is the guest's feature slice, the rest the hosts';
        returns the batch loss (a 0-dim tensor, not synchronized)."""
        u = self.guest.send_components(x_parts[0])
        for h, xp in zip(self.hosts, x_parts[1:]):
            u = u + h.send_components(xp)
        loss, grad = guest_loss_and_grad(u, y)
        self.guest.receive_gradients(x_parts[0], grad)
        for h, xp in zip(self.hosts, x_parts[1:]):
            h.receive_gradients(xp, grad)
        return loss

    def predict(self, x_parts: List[torch.Tensor]) -> torch.Tensor:
        u = self.guest.send_components(x_parts[0])
        for h, xp in zip(self.hosts, x_parts[1:]):
            u = u + h.send_components(xp)
        return torch.sigmoid(u.squeeze(-1))


class VFLFixture:
    """Train and evaluate (reference vfl_fixture.py:27): epochs of the
    aligned samples in batches, accuracy at the 0.5 threshold."""

    def __init__(self, federation, cfg: VFLConfig):
        self.fl = federation
        self.cfg = cfg
        self.device = federation.guest.device
        self.history: List[Dict] = []

    def _upload(self, arrays):
        return [torch.as_tensor(np.ascontiguousarray(a), device=self.device)
                for a in arrays]

    def fit(self, x_train_parts: List[np.ndarray], y_train: np.ndarray,
            x_test_parts: List[np.ndarray], y_test: np.ndarray) -> Dict:
        n = len(y_train)
        rng = np.random.RandomState(self.cfg.seed)
        bsz = self.cfg.batch_size
        xs = self._upload(x_train_parts)
        (y,) = self._upload([y_train])
        xts = self._upload(x_test_parts)
        y_test_pos = torch.as_tensor(np.asarray(y_test) > 0.5,
                                     device=self.device)
        for epoch in range(self.cfg.epochs):
            idx = torch.as_tensor(rng.permutation(n), device=self.device)
            losses = [self.fl.fit_batch([xp[sel] for xp in xs], y[sel])
                      for sel in (idx[s:s + bsz]
                                  for s in range(0, n - bsz + 1, bsz))]
            pred = self.fl.predict(xts)
            acc = int(((pred > 0.5) == y_test_pos).sum()) / len(y_test)
            self.history.append({
                "epoch": epoch,
                "train_loss": float(torch.stack(losses).mean())
                if losses else float("nan"),
                "test_acc": acc})
        return self.history[-1]


def build_vfl(party_feature_dims: List[int],
              cfg: Optional[VFLConfig] = None, hidden_dims=(32, 16),
              device="cuda") -> VFLFixture:
    """The guest (party 0, with the bias) and the hosts; party ``p``'s
    weights come from a generator seeded ``derive_seed(seed, p)``."""
    cfg = cfg or VFLConfig()
    parties = [VFLParty(d, cfg, with_bias=p == 0,
                        generator=make_generator(derive_seed(cfg.seed, p)),
                        hidden_dims=hidden_dims, device=device)
               for p, d in enumerate(party_feature_dims)]
    fl = VerticalMultiplePartyLogisticRegressionFederatedLearning(
        parties[0], parties[1:])
    return VFLFixture(fl, cfg)
