"""Split learning: the model cut across a trust boundary, with the clients
relayed in a ring. The counterpart of ``fedml_tpu/algorithms/split_nn.py``.

Reference protocol (fedml_api/distributed/split_nn/): the active client
runs the bottom network and sends the activations at the cut
(client.py:24-30); the server runs the top network, takes the CE loss,
backpropagates and returns the gradient at the cut (server.py:41-60,
99-102); the client finishes the backward pass (client.py:32-34). After its
epochs the activity token passes to the next client of the ring
(client_manager.py:154-169). Each client keeps its own bottom network; the
server's top network is shared.

The client's backward recomputes its forward (the JAX package's
``jax.vjp``), so a step is a function of (params, batch, gradient at the
cut) and the protocol carries tensors only. Both halves step with
``add_decayed_weights(wd)`` then SGD with momentum (server.py:19-20): here
``wd`` applies, unlike the FedAvg family's ``optax.sgd``. Each rotation's
batch order is ``np.random.RandomState(seed + rotation)``, the JAX
package's numpy stream, and each client's last partial batch is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.core.sampling import derive_seed, make_generator
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.common import init_params
from fedml_tpu_torch.trainer.functional import decayed_sgd
from fedml_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SplitNNConfig:
    epochs_per_node: int = 1  # reference MAX_EPOCH_PER_NODE (client.py:16)
    batch_size: int = 32
    lr: float = 0.1
    wd: float = 5e-4
    seed: int = 0


class SplitNNAPI:
    """The standalone simulation of the whole ring protocol (parity:
    SplitNNAPI.py and the managers' message flow, in one process in the
    same order). ``bottom_module`` and ``top_module`` are templates driven
    through ``functional_call``; client ``c``'s bottom weights come from a
    generator seeded ``derive_seed(seed, 0, c)``, the top's from
    ``derive_seed(seed, 1)``."""

    def __init__(self, dataset: FederatedDataset, bottom_module, top_module,
                 config: Optional[SplitNNConfig] = None, device="cuda"):
        self.ds = dataset
        self.cfg = config or SplitNNConfig()
        self.device = resolve_device(device)
        self.bottom = bottom_module
        self.top = top_module
        cfg = self.cfg

        def weights(module, seed):
            init_params(module.cpu(), make_generator(seed))
            return {k: v.detach().clone().to(self.device)
                    for k, v in module.state_dict().items()}
        self.bottom_params = [weights(bottom_module,
                                      derive_seed(cfg.seed, 0, c))
                              for c in range(dataset.client_num)]
        self.top_params = weights(top_module, derive_seed(cfg.seed, 1))
        bottom_module.to(self.device)
        top_module.to(self.device)
        self._opt = decayed_sgd(cfg.lr, 0.9, cfg.wd)
        self.bottom_opts = [self._opt.init(list(p.values()))
                            for p in self.bottom_params]
        self.top_opt = self._opt.init(list(self.top_params.values()))
        self._train = {c: self._upload(*dataset.train_data_local_dict[c])
                       for c in range(dataset.client_num)}
        self.history: List[Dict] = []

    def _upload(self, x, y):
        return (torch.as_tensor(np.ascontiguousarray(x), device=self.device),
                torch.as_tensor(np.asarray(y), dtype=torch.int64,
                                device=self.device))

    @torch.no_grad()
    def _step(self, params, grads, state):
        p = list(params.values())
        updates, state = self._opt.update(list(grads), state, p)
        return dict(zip(params, torch._foreach_add(p, updates))), state

    # -- the three half-steps ---------------------------------------------
    def client_forward(self, bottom_params, x):
        with torch.no_grad():
            return functional_call(self.bottom, bottom_params, (x,))

    def server_step(self, top_params, top_opt, acts, labels):
        """The top network's loss on the cut activations: its SGD step, and
        the gradient at the cut. Returns ``(top_params, top_opt, grad_acts,
        loss, correct)``."""
        params = {k: v.detach().requires_grad_(True)
                  for k, v in top_params.items()}
        acts = acts.detach().requires_grad_(True)
        logits = functional_call(self.top, params, (acts,))
        loss = F.cross_entropy(logits, labels)
        correct = (logits.argmax(-1) == labels).sum()
        *grads, grad_acts = torch.autograd.grad(
            loss, [*params.values(), acts])
        top_params, top_opt = self._step(top_params, grads, top_opt)
        return top_params, top_opt, grad_acts, loss.detach(), correct

    def client_backward(self, bottom_params, bottom_opt, x, grad_acts):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in bottom_params.items()}
        acts = functional_call(self.bottom, params, (x,))
        grads = torch.autograd.grad(acts, list(params.values()), grad_acts)
        return self._step(bottom_params, grads, bottom_opt)

    # -- rotations ---------------------------------------------------------
    def train_one_rotation(self, rotation: int = 0) -> Dict:
        """Every client takes one active turn of ``epochs_per_node`` epochs
        (the reference's full ring pass: the active node rotates at
        server.py:70-71)."""
        rng = np.random.RandomState(self.cfg.seed + rotation)
        bsz = self.cfg.batch_size
        loss_sum = correct_sum = 0.0
        count = 0
        for c in range(self.ds.client_num):
            x, y = self._train[c]
            for _ in range(self.cfg.epochs_per_node):
                idx = torch.as_tensor(rng.permutation(len(x)),
                                      device=self.device)
                for s in range(0, len(idx) - bsz + 1, bsz):
                    sel = idx[s:s + bsz]
                    xb, yb = x[sel], y[sel]
                    acts = self.client_forward(self.bottom_params[c], xb)
                    (self.top_params, self.top_opt, ga, loss,
                     correct) = self.server_step(self.top_params,
                                                 self.top_opt, acts, yb)
                    self.bottom_params[c], self.bottom_opts[c] = (
                        self.client_backward(self.bottom_params[c],
                                             self.bottom_opts[c], xb, ga))
                    loss_sum = loss_sum + loss * bsz
                    correct_sum = correct_sum + correct
                    count += bsz
        rec = {"rotation": rotation,
               "train_acc": float(correct_sum) / max(1.0, count),
               "train_loss": float(loss_sum) / max(1.0, count)}
        rec.update(self.evaluate())
        self.history.append(rec)
        return rec

    @torch.no_grad()
    def evaluate(self) -> Dict:
        """The global test pass: each test sample goes through its owner's
        bottom network (client-specific features, the shared top)."""
        loss = correct = 0.0
        count = 0
        for c in range(self.ds.client_num):
            t = self.ds.test_data_local_dict.get(c)
            if t is None or not len(t[0]):
                continue
            x, y = self._upload(*t)
            logits = functional_call(
                self.top, self.top_params,
                (self.client_forward(self.bottom_params[c], x),))
            loss = loss + F.cross_entropy(logits, y, reduction="sum")
            correct = correct + (logits.argmax(-1) == y).sum()
            count += len(y)
        if not count:
            return {}
        return {"test_acc": float(correct) / count,
                "test_loss": float(loss) / count}
