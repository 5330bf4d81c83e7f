"""The port's split learning and vertical FL against the JAX package's: the
party networks' forward (``VFLFeatureExtractor``, ``VFLDenseModel`` with
and without its bias), one VFL epoch of a guest and two hosts, and one
split-learning rotation over three clients with their own bottom networks.
Both packages draw the batch orders from the same numpy stream
(``RandomState(seed)``, ``RandomState(seed + rotation)``), so the orders
are exact and the weights are carried with ``utils/convert.py``. f32,
params at rtol 1e-5, atol 1e-5; the records' losses and accuracies at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.algorithms.split_nn import SplitNNAPI as JaxSplitNNAPI
from fedml_tpu.algorithms.split_nn import SplitNNConfig as JaxSplitNNConfig
from fedml_tpu.algorithms.vertical_fl import VFLConfig as JaxVFLConfig
from fedml_tpu.algorithms.vertical_fl import build_vfl as jax_build_vfl
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.models import vfl as flax_vfl
from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI, SplitNNConfig
from fedml_tpu_torch.algorithms.vertical_fl import (VFLConfig, build_vfl,
                                                    guest_loss_and_grad)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.vfl import VFLDenseModel, VFLFeatureExtractor
from fedml_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)


def _load(module, params):
    module.load_state_dict(flax_to_state_dict(
        {"params": jax.tree.map(np.asarray, params)}, module))


@pytest.mark.parametrize("use_bias", [True, False])
def test_party_networks_forward(use_bias):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7).astype(np.float32)
    fl, fd = flax_vfl.VFLFeatureExtractor((32, 16)), flax_vfl.VFLDenseModel(
        output_dim=3, use_bias=use_bias)
    vl = fl.init(jax.random.key(0), jnp.asarray(x))
    z = fl.apply(vl, jnp.asarray(x))
    vd = fd.init(jax.random.key(1), z)
    local, dense = VFLFeatureExtractor(7), VFLDenseModel(16, 3, use_bias)
    _load(local, vl["params"])
    _load(dense, vd["params"])
    assert (dense.dense.bias is not None) == use_bias
    zt = local(torch.tensor(x))
    np.testing.assert_allclose(zt.detach(), z, **TOL)
    np.testing.assert_allclose(dense(zt).detach(), fd.apply(vd, z), **TOL)


def test_guest_gradient_is_the_bce_gradient():
    rng = np.random.RandomState(1)
    u = torch.tensor(rng.randn(6, 1).astype(np.float32))
    y = torch.tensor((rng.rand(6) > 0.5).astype(np.float32))
    loss, grad = guest_loss_and_grad(u, y)
    want = (torch.sigmoid(u.squeeze(-1)) - y) / 6
    np.testing.assert_allclose(grad.squeeze(-1), want, rtol=1e-6, atol=1e-7)
    assert loss.ndim == 0


def _vfl_data(n=70, dims=(4, 3, 3)):
    rng = np.random.RandomState(2)
    xs = [rng.randn(n, d).astype(np.float32) for d in dims]
    y = (sum(x.sum(1) for x in xs) > 0).astype(np.float32)
    xts = [rng.randn(20, d).astype(np.float32) for d in dims]
    yt = (sum(x.sum(1) for x in xts) > 0).astype(np.float32)
    return xs, y, xts, yt


def test_one_vfl_epoch_matches_jax():
    """A guest and two hosts, batch 16 over 70 aligned samples (the last
    partial batch dropped), the same numpy permutation."""
    xs, y, xts, yt = _vfl_data()
    dims = [x.shape[1] for x in xs]
    kw = dict(epochs=1, batch_size=16, lr=0.1, seed=3)
    ref = jax_build_vfl(dims, JaxVFLConfig(**kw))
    fixture = build_vfl(dims, VFLConfig(**kw), device="cpu")
    parties = [fixture.fl.guest, *fixture.fl.hosts]
    refs = [ref.fl.guest, *ref.fl.hosts]
    for p, r in zip(parties, refs):
        _load(p.local, r.local_params)
        _load(p.dense, r.dense_params)
    assert parties[0].dense.dense.bias is not None
    assert all(p.dense.dense.bias is None for p in parties[1:])
    want = ref.fit(xs, y, xts, yt)
    got = fixture.fit(xs, y, xts, yt)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-5)
    assert got["test_acc"] == want["test_acc"]
    for p, r in zip(parties, refs):
        for mod, params in ((p.local, r.local_params),
                            (p.dense, r.dense_params)):
            for k, v in flax_to_state_dict(
                    {"params": jax.tree.map(np.asarray, params)},
                    mod).items():
                np.testing.assert_allclose(mod.state_dict()[k], v,
                                           err_msg=k, **TOL)


def _split_federation():
    rng = np.random.RandomState(4)
    centers = rng.randn(3, 10).astype(np.float32) * 2.0
    train, test = {}, {}
    for c, n in enumerate((40, 27, 33)):
        y = rng.randint(0, 3, n).astype(np.int32)
        x = centers[y] + rng.randn(n, 10).astype(np.float32)
        train[c], test[c] = (x, y), (x[:7], y[:7])
    return train, test


def test_one_split_rotation_matches_jax():
    """Three clients, each with its own (64, 32) bottom, a shared dense top,
    SGD momentum 0.9 with weight decay 5e-4 on both halves, batch 8 (each
    client's last partial batch dropped), the orders of ``RandomState(seed
    + rotation)``; per-client evaluation through each owner's bottom."""
    train, test = _split_federation()
    kw = dict(epochs_per_node=1, batch_size=8, lr=0.05, seed=5)
    ref = JaxSplitNNAPI(
        JaxFederatedDataset.from_client_arrays(train, test, 3),
        flax_vfl.VFLFeatureExtractor((64, 32)),
        flax_vfl.VFLDenseModel(output_dim=3, use_bias=True), (32,),
        config=JaxSplitNNConfig(**kw))
    api = SplitNNAPI(FederatedDataset.from_client_arrays(train, test, 3),
                     VFLFeatureExtractor(10, (64, 32)),
                     VFLDenseModel(32, 3), config=SplitNNConfig(**kw),
                     device="cpu")

    def as_sd(params, module):
        return flax_to_state_dict({"params": jax.tree.map(np.asarray,
                                                          params)}, module)
    api.bottom_params = [as_sd(p, api.bottom) for p in ref.bottom_params]
    api.top_params = as_sd(ref.top_params, api.top)
    want = ref.train_one_rotation(1)
    got = api.train_one_rotation(1)
    for k in ("train_acc", "train_loss", "test_acc", "test_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for c, p in enumerate(ref.bottom_params):
        for k, v in as_sd(p, api.bottom).items():
            np.testing.assert_allclose(api.bottom_params[c][k], v,
                                       err_msg=f"client {c} {k}", **TOL)
    for k, v in as_sd(ref.top_params, api.top).items():
        np.testing.assert_allclose(api.top_params[k], v, err_msg=k, **TOL)
    # every client's bottom trained in its turn, apart from the others'
    assert not torch.equal(api.bottom_params[0]["layers.0.weight"],
                           api.bottom_params[1]["layers.0.weight"])
