"""The port's FedGKT against the JAX package's: the GKT client and server
networks' eval forward (f32, rtol 1e-4, atol 1e-5; the full-size
``resnet8_56`` client, a one-block-a-stage server), ``kl_distill`` (1e-6),
two rounds (distillation off in round 0 and on in round 1) with the
permutations JAX drew passed in, and the ``.pth`` warm start, which gives
every client the same weights in both packages from a file the test
writes.

The rounds run in float64 on both sides (BatchNorm train steps at batch
4), and every client's weights, BatchNorm statistics and the server's are
held at atol 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.algorithms.fedgkt import FedGKTAPI as JaxFedGKTAPI
from fedml_tpu.algorithms.fedgkt import FedGKTConfig as JaxFedGKTConfig
from fedml_tpu.algorithms.fedgkt import kl_distill as jax_kl_distill
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.models import resnet_gkt as flax_gkt
from fedml_tpu_torch.algorithms.fedgkt import (FedGKTAPI, FedGKTConfig,
                                               kl_distill)
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.resnet_gkt import (ResNetClientGKT,
                                               ResNetServerGKT,
                                               load_reference_client_state,
                                               load_torch_state_dict,
                                               resnet8_56)
from fedml_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-5)
ROUND_ATOL = 1e-5
CLASSES = 3


def _random_variables(shapes, rng):
    def draw(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            w = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf in ("scale", "var"):
            w = 1.0 + 0.3 * (rng.rand(*a.shape) - 0.5)
        else:
            w = 0.1 * rng.randn(*a.shape)
        return w.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _drawn_inits(client, server, x, rng, dtype=np.float32):
    """Patch both flax modules' ``init`` to return variables drawn with
    numpy (flax's own init runs eagerly, and takes seconds here); returns
    the patches and the two variable trees."""
    vc = _random_variables(jax.eval_shape(lambda: client.init(
        jax.random.key(0), jnp.asarray(x[:1]), train=False)), rng)
    feats = jax.eval_shape(lambda: client.apply(vc, jnp.asarray(x[:1]))[1])
    vs = _random_variables(jax.eval_shape(lambda f: server.init(
        jax.random.key(0), f, train=False), feats), rng)
    vc, vs = (jax.tree.map(lambda a: a.astype(dtype), v) for v in (vc, vs))
    return (mock.patch.object(type(client), "init", lambda *a, **k: vc),
            mock.patch.object(type(server), "init", lambda *a, **k: vs),
            vc, vs)


def _federation(sizes=(6, 9, 4), hw=8, seed=3):
    rng = np.random.RandomState(seed)
    train, test = {}, {}
    for c, n in enumerate(sizes):
        x = rng.rand(n, hw, hw, 3)
        y = rng.randint(0, CLASSES, n).astype(np.int32)
        train[c], test[c] = (x, y), (x[:3], y[:3])
    return train, test


def test_gkt_networks_eval_forward():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 8, 8, 3).astype(np.float32)
    fc, fs = flax_gkt.resnet8_56(CLASSES), flax_gkt.ResNetServerGKT(
        stage_sizes=(1, 1, 1), num_classes=CLASSES)
    vc = _random_variables(jax.eval_shape(lambda: fc.init(
        jax.random.key(0), jnp.asarray(x), train=False)), rng)
    logits, feats = fc.apply(vc, jnp.asarray(x), train=False)
    vs = _random_variables(jax.eval_shape(lambda: fs.init(
        jax.random.key(0), feats, train=False)), rng)
    out = fs.apply(vs, feats, train=False)
    client, server = resnet8_56(CLASSES), ResNetServerGKT((1, 1, 1), CLASSES)
    client.load_state_dict(flax_to_state_dict(vc, client))
    server.load_state_dict(flax_to_state_dict(vs, server))
    got_logits, got_feats = client(torch.tensor(x))
    assert tuple(got_feats.shape) == (2, 64, 8, 8)
    np.testing.assert_allclose(got_logits.detach(), logits, **TOL)
    np.testing.assert_allclose(got_feats.permute(0, 2, 3, 1).detach(),
                               feats, **TOL)
    np.testing.assert_allclose(server(got_feats).detach(), out, **TOL)


@pytest.mark.parametrize("T", [1.0, 3.0])
def test_kl_distill_matches_jax(T):
    rng = np.random.RandomState(1)
    s, t = (rng.randn(6, 5).astype(np.float32) for _ in range(2))
    want = jax_kl_distill(jnp.asarray(s), jnp.asarray(t), T)
    got = kl_distill(torch.tensor(s), torch.tensor(t), T)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    same = kl_distill(torch.tensor(s), torch.tensor(s), T)
    assert float(same.abs().max()) < 1e-5


def _jax_orders(api, r, C):
    """The permutations the JAX round draws: ``fold_in(key(seed), r)``,
    then the clients' ``split(fold_in(., 0), C)`` -> ``split(rng,
    epochs_client)`` and the server's ``split(fold_in(., 1),
    epochs_server)``, each a ``permutation``."""
    cfg, n_pad = api.cfg, api._n_pad
    rkey = jax.random.fold_in(jax.random.key(cfg.seed), r)
    crngs = jax.random.split(jax.random.fold_in(rkey, 0), C)
    client = np.stack([np.stack([
        np.asarray(jax.random.permutation(k, n_pad))
        for k in jax.random.split(crngs[c], cfg.epochs_client)])
        for c in range(C)])
    server = np.stack([
        np.asarray(jax.random.permutation(k, C * n_pad))
        for k in jax.random.split(jax.random.fold_in(rkey, 1),
                                  cfg.epochs_server)])
    return client, server


def test_two_rounds_match_jax_with_its_permutations():
    train, test = _federation()
    C = len(train)
    kw = dict(comm_round=2, epochs_client=1, epochs_server=2, batch_size=4,
              seed=0)
    client, server = ResNetClientGKT(1, CLASSES), ResNetServerGKT(
        (1, 1), CLASSES)
    fc = flax_gkt.ResNetClientGKT(num_blocks=1, num_classes=CLASSES)
    fs = flax_gkt.ResNetServerGKT(stage_sizes=(1, 1), num_classes=CLASSES)
    with jax.enable_x64(True):
        patch_c, patch_s, _, _ = _drawn_inits(
            fc, fs, train[0][0], np.random.RandomState(6), np.float64)
        with patch_c, patch_s:
            ref = JaxFedGKTAPI(
                JaxFederatedDataset.from_client_arrays(train, test,
                                                       CLASSES),
                fc, fs, JaxFedGKTConfig(**kw))
        ref._server_logits = jnp.asarray(ref._server_logits, jnp.float64)
        start_c = jax.tree.map(np.asarray, ref.client_vars)
        start_s = jax.tree.map(np.asarray, ref.server_vars)
        orders = [_jax_orders(ref, r, C) for r in range(2)]
        want = [ref.run_round(r) for r in range(2)]
        want_c = jax.tree.map(np.asarray, ref.client_vars)
        want_s = jax.tree.map(np.asarray, ref.server_vars)
    client, server = client.double(), server.double()
    api = FedGKTAPI(FederatedDataset.from_client_arrays(train, test,
                                                        CLASSES),
                    client, server, FedGKTConfig(**kw), device="cpu")
    api.client_vars = [flax_to_state_dict(
        jax.tree.map(lambda a: a[c], start_c), client) for c in range(C)]
    api.server_vars = flax_to_state_dict(start_s, server)
    got = [api.run_round(r, *orders[r]) for r in range(2)]
    assert api._have_server_logits
    for g, w in zip(got, want):
        for k in ("client_loss", "server_loss", "test_acc", "test_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    for c in range(C):
        w = flax_to_state_dict(jax.tree.map(lambda a: a[c], want_c), client)
        for k, v in w.items():
            np.testing.assert_allclose(api.client_vars[c][k], v,
                                       rtol=0, atol=ROUND_ATOL,
                                       err_msg=f"client {c} {k}")
    for k, v in flax_to_state_dict(want_s, server).items():
        np.testing.assert_allclose(api.server_vars[k], v, rtol=0,
                                   atol=ROUND_ATOL, err_msg=k)
    # client weights are never averaged
    assert not torch.equal(api.client_vars[0]["stem.weight"],
                           api.client_vars[1]["stem.weight"])


def _reference_named(state):
    """The port client's state dict under the reference resnet_client's
    names (conv1/bn1, layer1.i, downsample.0/1, fc), with
    ``num_batches_tracked`` entries, in a DataParallel checkpoint
    wrapper."""
    out = {}
    for k, v in state.items():
        k = (k.replace("blocks.", "layer1.").replace("shortcut_bn",
                                                     "downsample.1")
             .replace("shortcut", "downsample.0").replace("stem_bn", "bn1")
             .replace("stem", "conv1"))
        out[f"module.{k}"] = v
        if k.endswith("running_var"):
            out[f"module.{k[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(5)
    return {"epoch": 3, "state_dict": out}


def test_warm_start_gives_both_packages_the_same_client_weights(tmp_path):
    train, test = _federation(sizes=(8, 8), seed=4)
    gen = torch.Generator().manual_seed(5)
    src = resnet8_56(CLASSES)
    with torch.no_grad():
        for t in src.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.1 + 0.5)
    path = str(tmp_path / "best.pth")
    torch.save(_reference_named(src.state_dict()), path)
    kw = dict(comm_round=1, batch_size=8, pretrained_client_path=path)
    fc = flax_gkt.resnet8_56(CLASSES)
    fs = flax_gkt.ResNetServerGKT(stage_sizes=(1,), num_classes=CLASSES)
    # the client's own init: the JAX loader walks its variables in flax's
    # creation order, which a tree map would sort
    _, patch_s, _, _ = _drawn_inits(fc, fs, train[0][0],
                                    np.random.RandomState(6))
    with patch_s:
        ref = JaxFedGKTAPI(
            JaxFederatedDataset.from_client_arrays(train, test, CLASSES),
            fc, fs, JaxFedGKTConfig(**kw))
    client = resnet8_56(CLASSES)
    api = FedGKTAPI(FederatedDataset.from_client_arrays(train, test,
                                                        CLASSES),
                    client, ResNetServerGKT((1,), CLASSES),
                    FedGKTConfig(**kw), device="cpu")
    for c in range(2):
        want = flax_to_state_dict(jax.tree.map(
            lambda a: np.asarray(a)[c], ref.client_vars), client)
        for k, v in want.items():
            assert torch.equal(api.client_vars[c][k], v), (c, k)
            assert torch.equal(api.client_vars[c][k], src.state_dict()[k])
    # a head of another width does not load
    with pytest.raises(ValueError, match="fc.weight"):
        load_reference_client_state(load_torch_state_dict(path),
                                    resnet8_56(CLASSES + 1))
