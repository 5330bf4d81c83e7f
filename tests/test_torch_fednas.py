"""The port's FedNAS against the JAX package's: one search round under
``darts`` (the soft mixture) and ``gdas`` (the straight-through gumbel
sample, from the uniforms JAX drew); ``tests/test_torch_fednas_unrolled.py``
holds ``arch_unrolled``. Each round starts from the same weights and
alphas, with the batch orders JAX drew passed in. The aggregated weights,
BatchNorm statistics and both alphas are held to JAX's, and the alphas
and the weights must have moved.

A tiny search network (C 4, one node a cell) on 8x8 images, batch 4, in
float64 on both sides (a BatchNorm train step at batch 4): three cells (a
normal cell and two reductions) under ``darts``, one reduction cell under
``gdas`` (each cell costs the JAX side seconds of compile). Tolerance:
atol 1e-8 on the alphas, 1e-7 on the weights and statistics (the rounds
agree to ~1e-13). The JAX rounds' flax init is replaced by a numpy draw,
which each test overwrites anyway.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.algorithms.fednas import FedNASAPI as JaxFedNASAPI
from fedml_tpu.algorithms.fednas import FedNASConfig as JaxFedNASConfig
from fedml_tpu.data.base import FederatedDataset as JaxFederatedDataset
from fedml_tpu.models.darts import DartsNetwork as FlaxDartsNetwork
from fedml_tpu.models.darts import init_alphas
from fedml_tpu_torch.algorithms.fednas import FedNASAPI, FedNASConfig
from fedml_tpu_torch.data.base import FederatedDataset
from fedml_tpu_torch.models.darts import DartsNetwork
from fedml_tpu_torch.utils.convert import flax_to_state_dict

NET = dict(C=4, num_classes=3, steps=1, multiplier=1, stem_multiplier=1)
ALPHA_ATOL = 1e-8
WEIGHT_ATOL = 1e-7


def _federation():
    rng = np.random.RandomState(3)
    train, test = {}, {}
    for c, n in enumerate((6, 9, 4)):
        x = rng.rand(n, 8, 8, 3)
        y = rng.randint(0, 3, n).astype(np.int32)
        train[c], test[c] = (x, y), (x[:2], y[:2])
    return train, test


def _drawn_variables(model, x, alphas, rng):
    """float64 variables drawn with numpy over the flax abstract init (numpy
    arrays: the JAX round donates the device arrays it is given)."""
    w = [jax.nn.softmax(a, -1) for a in alphas]
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.asarray(x[:1]), *w, train=False))

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif leaf in ("scale", "var"):
            v = 1.0 + 0.3 * (rng.rand(*a.shape) - 0.5)
        else:
            v = 0.1 * rng.randn(*a.shape)
        return np.asarray(v, np.float64)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_draws(api, C, variant):
    """The orders and GDAS uniforms the JAX round draws: ``split(fold_in(
    key(seed), r), C)`` -> ``split(rng, epochs)`` -> ``kperm, kstep =
    split(key)``, ``permutation(kperm, n_pad)``; each step's key of
    ``split(kstep, nb)`` -> ``ka, kw = split``, and each of those ->
    ``kn, kr = split`` -> ``uniform(., [k, ops], 1e-20, 1)``."""
    cfg, n_pad = api.cfg, api._n_pad
    nb = n_pad // cfg.batch_size
    shape = api.alphas["normal"].shape
    rngs = jax.random.split(jax.random.fold_in(jax.random.key(cfg.seed), 0),
                            C)
    orders, uniforms = [], []
    for c in range(C):
        oc, uc = [], []
        for key in jax.random.split(rngs[c], cfg.epochs):
            kperm, kstep = jax.random.split(key)
            oc.append(np.asarray(jax.random.permutation(kperm, n_pad)))
            ue = []
            for skey in jax.random.split(kstep, nb):
                us = []
                for k in jax.random.split(skey):  # ka, kw
                    for kk in jax.random.split(k):  # normal, reduce
                        us.append(np.asarray(jax.random.uniform(
                            kk, shape, minval=1e-20, maxval=1.0)))
                ue.append(np.stack(us))
            uc.append(np.stack(ue))
        orders.append(np.stack(oc))
        uniforms.append(np.stack(uc))
    return np.stack(orders), (np.stack(uniforms) if variant == "gdas"
                              else None)


def search_round_matches_jax(variant, layers):
    """One round of ``variant`` (darts, gdas or unrolled) on a network of
    ``layers`` cells, the port's against JAX's."""
    net = dict(NET, layers=layers)
    train, test = _federation()
    C = len(train)
    kw = dict(comm_round=1, epochs=1, batch_size=4, lr=0.1, arch_lr=0.01,
              seed=0, variant="gdas" if variant == "gdas" else "darts",
              arch_unrolled=variant == "unrolled")
    flax_model = FlaxDartsNetwork(**net)
    with jax.enable_x64(True):
        start = _drawn_variables(
            flax_model, train[0][0],
            init_alphas(NET["steps"], np.random.RandomState(0)),
            np.random.RandomState(4))
        with mock.patch.object(FlaxDartsNetwork, "init",
                               lambda *a, **k: jax.tree.map(jnp.array,
                                                            start)):
            ref = JaxFedNASAPI(JaxFederatedDataset.from_client_arrays(
                train, test, 3), flax_model, JaxFedNASConfig(**kw))
        ref.alphas = {k: jnp.asarray(v, jnp.float64)
                      for k, v in ref.alphas.items()}
        start_alphas = {k: np.asarray(v) for k, v in ref.alphas.items()}
        orders, uniforms = _jax_draws(ref, C, variant)
        ref.run_round(0)
        want = jax.tree.map(np.asarray, ref.variables)
        want_alphas = {k: np.asarray(v) for k, v in ref.alphas.items()}
    model = DartsNetwork(**net).double()
    api = FedNASAPI(FederatedDataset.from_client_arrays(train, test, 3),
                    model, FedNASConfig(**kw), device="cpu")
    for k, v in start_alphas.items():
        np.testing.assert_array_equal(api.alphas[k].numpy(), v.astype(
            np.float32))
    api.variables = flax_to_state_dict(start, model)
    api.alphas = {k: torch.tensor(v) for k, v in start_alphas.items()}
    api.run_round(0, orders=orders, uniforms=uniforms)
    for k, v in want_alphas.items():
        np.testing.assert_allclose(api.alphas[k], v, rtol=0,
                                   atol=ALPHA_ATOL, err_msg=k)
        assert np.abs(v - start_alphas[k]).max() > 1e-3, k
    start_sd = flax_to_state_dict(start, model)
    moved = 0
    for k, v in flax_to_state_dict(want, model).items():
        np.testing.assert_allclose(api.variables[k], v, rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)
        moved += not torch.equal(v, start_sd[k])
    assert moved == len(start_sd)
    assert api.genotype() == ref.genotype()


@pytest.mark.parametrize("variant, layers", [("darts", 3), ("gdas", 1)])
def test_one_search_round_matches_jax(variant, layers):
    search_round_matches_jax(variant, layers)
