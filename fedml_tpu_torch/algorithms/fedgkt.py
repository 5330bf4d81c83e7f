"""FedGKT, group knowledge transfer: small client networks and a large server
network. The counterpart of ``fedml_tpu/algorithms/fedgkt.py``.

Reference protocol (fedml_api/distributed/fedgkt/): each round every client
trains its small network on ``CE + alpha * KL(client logits, server
logits)`` (GKTClientTrainer.py:49-90), then sweeps its data once in eval
mode and sends its features, logits and labels to the server (:108-127).
The server trains the large network on those features with ``CE + alpha
* KL(server logits, client logits)`` (GKTServerTrainer
train_large_model_on_the_server) and returns its eval-mode logits to each
client for the next round's distillation. Client weights are never
averaged, so no aggregation kernel runs on this path.

The clients train one after another on the device, as the FedAvg family's
host loop does (the JAX package ``vmap``s them); each keeps its own SGD
momentum (0.9, no weight decay) across rounds. Every client's sweep runs
over its *unshuffled padded* rows, and the server trains on the clients'
rows flattened to ``[C * n_pad]``, in batches of ``perm[:nb * bsz]``.
Every batch of the permutation is a step, padding-only ones too, as in the
JAX package's scan. Distillation is off in round 0 (no server logits yet).

The batch orders are inputs of :meth:`FedGKTAPI.run_round`: by default
``torch.randperm`` from a generator seeded ``derive_seed(seed, round, 0,
c, epoch)`` (clients) and ``derive_seed(seed, round, 1, epoch)`` (the
server), not the JAX
package's ``jax.random.permutation`` stream; a test passes in the orders
the JAX package drew.
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
from fedml_tpu_torch.trainer.functional import (decayed_sgd,
                                                make_train_forward,
                                                next_colls, param_names)
from fedml_tpu_torch.utils.device import resolve_device

#: rows of one eval-mode forward of a sweep or an evaluation
EVAL_BATCH = 512


@dataclasses.dataclass(frozen=True)
class FedGKTConfig:
    comm_round: int = 10
    epochs_client: int = 1
    epochs_server: int = 1
    batch_size: int = 32
    lr_client: float = 0.01
    lr_server: float = 0.01
    alpha: float = 1.0  # distillation weight (--alpha, main_fedgkt.py)
    temperature: float = 1.0
    seed: int = 0
    # a torch .pth checkpoint of the client model: every client's weights
    # start from it (reference create_client_model, main_fedgkt.py:124-167)
    pretrained_client_path: Optional[str] = None


def kl_distill(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               T: float) -> torch.Tensor:
    """Per-example ``T^2 * KL(teacher || student)`` at temperature ``T``, the
    teacher's softmax plus 1e-7 (reference KL_Loss, fedgkt/utils.py:75-95);
    the caller takes the masked mean."""
    student = torch.log_softmax(student_logits / T, dim=-1)
    teacher = torch.softmax(teacher_logits / T, dim=-1) + 1e-7
    return T * T * (teacher * (torch.log(teacher) - student)).sum(-1)


def _split(variables, names):
    """``(params in the order of names, the other entries)``."""
    held = set(names)
    return ([variables[k] for k in names],
            {k: v for k, v in variables.items() if k not in held})


def _param_order(module) -> List[str]:
    """The state-dict names of ``module``'s parameters, in its order: the
    order of each optimizer state's lists."""
    trained = param_names(module)
    return [k for k in module.state_dict() if k in trained]


class FedGKTAPI:
    """The standalone simulation of the whole protocol. Client ``c``'s
    weights come from a generator seeded ``derive_seed(seed, 0, c)`` (or
    the warm-start checkpoint, the same for every client), the server's
    from ``derive_seed(seed, 1)``."""

    def __init__(self, dataset: FederatedDataset, client_module,
                 server_module, config: Optional[FedGKTConfig] = None,
                 device="cuda"):
        self.ds = dataset
        self.cfg = cfg = config or FedGKTConfig()
        self.device = resolve_device(device)
        self.client_module = client_module
        self.server_module = server_module
        C = dataset.client_num
        self._n_pad = dataset.padded_len(cfg.batch_size)

        def weights(module, seed):
            init_params(module.cpu(), make_generator(seed))
            return {k: v.detach().clone().to(self.device)
                    for k, v in module.state_dict().items()}
        if cfg.pretrained_client_path:
            from fedml_tpu_torch.models.resnet_gkt import (
                load_reference_client_state, load_torch_state_dict)
            warm = load_reference_client_state(
                load_torch_state_dict(cfg.pretrained_client_path),
                client_module.cpu())
            self.client_vars = [{k: v.clone().to(self.device)
                                 for k, v in warm.items()}
                                for _ in range(C)]
        else:
            self.client_vars = [weights(client_module,
                                        derive_seed(cfg.seed, 0, c))
                                for c in range(C)]
        self.server_vars = weights(server_module, derive_seed(cfg.seed, 1))
        client_module.to(self.device)
        server_module.to(self.device)
        self._client_names = _param_order(client_module)
        self._server_names = _param_order(server_module)
        self._opt_c = decayed_sgd(cfg.lr_client, 0.9)
        self._opt_s = decayed_sgd(cfg.lr_server, 0.9)
        self.client_opts = [
            self._opt_c.init(_split(v, self._client_names)[0])
            for v in self.client_vars]
        self.server_opt = self._opt_s.init(
            _split(self.server_vars, self._server_names)[0])
        self._client_forward = make_train_forward(client_module)
        self._server_forward = make_train_forward(server_module)

        # the packed data, unshuffled: [C, n_pad, ...]
        x, y, mask = dataset.pack_clients(list(range(C)), cfg.batch_size,
                                          n_pad=self._n_pad)
        self._x = torch.as_tensor(x, device=self.device)
        self._y = torch.as_tensor(y, dtype=torch.int64, device=self.device)
        self._mask = torch.as_tensor(mask, device=self.device).to(
            self._x.dtype)
        self._server_logits = torch.zeros(
            (C, self._n_pad, dataset.class_num), dtype=self._x.dtype,
            device=self.device)
        self._have_server_logits = False
        self.history: List[Dict] = []

    # -- one train step, either side ---------------------------------------
    def _step(self, forward, opt, variables, names, state, xb, yb, mb,
              teacher, kd_weight):
        """One SGD step of ``mean(CE + kd_weight * KL(out, teacher))`` over
        the batch's real rows. Returns ``(variables, state, loss)``."""
        params, colls = _split(variables, names)
        leaves = [p.detach().requires_grad_(True) for p in params]
        out, new_colls = forward({**colls, **dict(zip(names, leaves))}, xb,
                                 None)
        logits = out[0] if isinstance(out, tuple) else out
        per = (F.cross_entropy(logits, yb, reduction="none")
               + kd_weight * kl_distill(logits, teacher,
                                        self.cfg.temperature))
        loss = (per * mb).sum() / mb.sum().clamp(min=1.0)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, state = opt.update(list(grads), state, params)
            params = torch._foreach_add(params, updates)
        new = {**next_colls(colls, new_colls), **dict(zip(names, params))}
        return {k: new[k] for k in variables}, state, loss.detach()

    def _batches(self, perm: torch.Tensor):
        bsz = self.cfg.batch_size
        nb = perm.shape[0] // bsz
        return perm[:nb * bsz].view(nb, bsz)

    @torch.no_grad()
    def _sweep(self, module, variables, x):
        """The eval-mode forward over ``x`` in chunks: per row, so the
        chunking changes nothing."""
        outs = [functional_call(module, variables, (x[i:i + EVAL_BATCH],),
                                {"train": False})
                for i in range(0, x.shape[0], EVAL_BATCH)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    # -- the two halves of a round -------------------------------------------
    def client_step(self, c: int, idx: torch.Tensor, kd_weight):
        """One train step of client ``c`` on its rows ``idx``."""
        self.client_vars[c], self.client_opts[c], loss = self._step(
            self._client_forward, self._opt_c, self.client_vars[c],
            self._client_names, self.client_opts[c], self._x[c][idx],
            self._y[c][idx], self._mask[c][idx],
            self._server_logits[c][idx], kd_weight)
        return loss

    def server_step(self, f, cl, yy, mm, idx: torch.Tensor):
        """One train step of the server on the flattened rows ``idx``."""
        self.server_vars, self.server_opt, loss = self._step(
            self._server_forward, self._opt_s, self.server_vars,
            self._server_names, self.server_opt, f[idx], yy[idx], mm[idx],
            cl[idx], self.cfg.alpha)
        return loss

    def _default_orders(self, round_idx: int):
        cfg, C = self.cfg, self.ds.client_num
        client = np.stack([np.stack([
            torch.randperm(self._n_pad, generator=make_generator(
                derive_seed(cfg.seed, round_idx, 0, c, e))).numpy()
            for e in range(cfg.epochs_client)]) for c in range(C)])
        server = np.stack([
            torch.randperm(C * self._n_pad, generator=make_generator(
                derive_seed(cfg.seed, round_idx, 1, e))).numpy()
            for e in range(cfg.epochs_server)])
        return client, server

    def run_round(self, round_idx: int, client_orders=None,
                  server_orders=None) -> Dict:
        """One round. ``client_orders`` is ``[C, epochs_client, n_pad]``
        (each client's permutation of its padded rows, an epoch each),
        ``server_orders`` ``[epochs_server, C * n_pad]``; both default to
        the port's own draws."""
        cfg, C = self.cfg, self.ds.client_num
        if client_orders is None or server_orders is None:
            drawn = self._default_orders(round_idx)
            client_orders = drawn[0] if client_orders is None \
                else client_orders
            server_orders = drawn[1] if server_orders is None \
                else server_orders
        client_orders = torch.as_tensor(np.asarray(client_orders),
                                        dtype=torch.int64, device=self.device)
        server_orders = torch.as_tensor(np.asarray(server_orders),
                                        dtype=torch.int64, device=self.device)
        kd_weight = (1.0 if self._have_server_logits else 0.0) * cfg.alpha
        client_losses, feats, logits = [], [], []
        for c in range(C):
            losses = [self.client_step(c, idx, kd_weight)
                      for e in range(cfg.epochs_client)
                      for idx in self._batches(client_orders[c, e])]
            client_losses.append(torch.stack(losses).mean())
            lg, ft = self._sweep(self.client_module, self.client_vars[c],
                                 self._x[c])
            logits.append(lg)
            feats.append(ft)
        # the server sees one feature set: the clients' rows flattened
        f = torch.cat(feats)
        cl = torch.cat(logits)
        yy, mm = self._y.reshape(-1), self._mask.reshape(-1)
        server_losses = [self.server_step(f, cl, yy, mm, idx)
                         for e in range(cfg.epochs_server)
                         for idx in self._batches(server_orders[e])]
        self._server_logits = self._sweep(
            self.server_module, self.server_vars, f).reshape(
                C, self._n_pad, -1)
        self._have_server_logits = True
        rec = {"round": round_idx,
               "client_loss": float(torch.stack(client_losses).mean()),
               "server_loss": float(torch.stack(server_losses).mean())}
        rec.update(self.evaluate())
        self.history.append(rec)
        return rec

    def train(self) -> Dict:
        for r in range(self.cfg.comm_round):
            self.run_round(r)
        return self.history[-1]

    @torch.no_grad()
    def evaluate(self) -> Dict:
        """Each client's test data through its own small network and the
        server network (reference eval_large_model_on_the_server)."""
        correct = loss = 0.0
        count = 0
        for c in range(self.ds.client_num):
            t = self.ds.test_data_local_dict.get(c)
            if t is None or not len(t[0]):
                continue
            x = torch.as_tensor(np.ascontiguousarray(t[0]),
                                device=self.device)
            y = torch.as_tensor(np.asarray(t[1]), dtype=torch.int64,
                                device=self.device)
            _, ft = self._sweep(self.client_module, self.client_vars[c], x)
            out = self._sweep(self.server_module, self.server_vars, ft)
            correct = correct + (out.argmax(-1) == y).sum()
            loss = loss + F.cross_entropy(out, y, reduction="sum")
            count += len(y)
        if not count:
            return {}
        return {"test_acc": float(correct) / count,
                "test_loss": float(loss) / count}
