"""The port's decentralized online learning against the JAX package's:
the copied topologies give JAX's mixing matrices from the same seeds, and
the online DSGD and push-sum runs give JAX's regret and consensus distance
(atol 1e-5: f32, the order of the gossip products differs), plus the
behaviours the JAX tests pin.
"""

import numpy as np
import pytest

from fedml_tpu.algorithms.decentralized import \
    DecentralizedConfig as JaxDecentralizedConfig
from fedml_tpu.algorithms.decentralized import \
    DecentralizedOnlineAPI as JaxDecentralizedOnlineAPI
from fedml_tpu.core import topology as jax_topology
from fedml_tpu_torch.algorithms.decentralized import (DecentralizedConfig,
                                                      DecentralizedOnlineAPI)
from fedml_tpu_torch.core import topology
from fedml_tpu_torch.core.sampling import locked_global_numpy_rng

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _streams(n=8, T=120, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(dim)
    x = rng.randn(n, T, dim).astype(np.float32)
    return x, (x @ w_true > 0).astype(np.float32)


@pytest.mark.parametrize("directed", [False, True])
def test_topology_copy_matches_jax(directed):
    def make(mod):
        with locked_global_numpy_rng(3):
            mgr = (mod.AsymmetricTopologyManager(9, 4, 3) if directed
                   else mod.SymmetricTopologyManager(9, 4))
            W = mgr.generate_topology()
        return mgr, W
    (mgr, W), (jmgr, jW) = make(topology), make(jax_topology)
    assert np.array_equal(W, jW)
    np.testing.assert_allclose(W.sum(1), 1.0, rtol=1e-6)
    for i in range(9):
        assert mgr.get_in_neighbor_idx_list(i) == \
            jmgr.get_in_neighbor_idx_list(i)
        assert mgr.get_out_neighbor_idx_list(i) == \
            jmgr.get_out_neighbor_idx_list(i)
    assert np.array_equal(topology.ring_mixing_matrix(6),
                          jax_topology.ring_mixing_matrix(6))


@pytest.mark.parametrize("kw", [
    dict(mode="DOL"),
    dict(mode="PUSHSUM", b_symmetric=False),
    dict(mode="PUSHSUM", b_symmetric=False, time_varying=True),
    dict(mode="DOL", learning_rate=0.05, weight_decay=0.01)],
    ids=["dsgd", "pushsum", "pushsum-time-varying", "dsgd-wd"])
def test_online_run_matches_jax(kw):
    x, y = _streams(seed=1)
    cfg = dict(iteration_number=60, **kw)
    ref = JaxDecentralizedOnlineAPI(x, y, JaxDecentralizedConfig(**cfg))
    api = DecentralizedOnlineAPI(x, y, DecentralizedConfig(**cfg),
                                 device="cpu")
    assert np.array_equal(api.topologies, ref.topologies)
    np.testing.assert_allclose(api.train(), ref.train(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(api.consensus_distance(),
                               ref.consensus_distance(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(api.w.numpy(), np.asarray(ref.w), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(api.b.numpy(), np.asarray(ref.b), atol=1e-5,
                               rtol=0)


def test_dsgd_regret_decreases_and_gossip_reaches_consensus():
    x, y = _streams(T=200)
    short = DecentralizedOnlineAPI(x, y, DecentralizedConfig(
        iteration_number=20), device="cpu")
    long = DecentralizedOnlineAPI(x, y, DecentralizedConfig(
        iteration_number=200), device="cpu")
    assert long.train() < short.train()
    gossip = DecentralizedOnlineAPI(*_streams(T=150, seed=2),
                                    DecentralizedConfig(
                                        iteration_number=150,
                                        learning_rate=0.05), device="cpu")
    gossip.train()
    assert gossip.consensus_distance() < 0.5


def test_pushsum_directed_graph_learns():
    x, y = _streams(T=200, seed=1)
    api = DecentralizedOnlineAPI(x, y, DecentralizedConfig(
        mode="PUSHSUM", iteration_number=200, b_symmetric=False),
        device="cpu")
    regret = api.train()
    assert np.isfinite(regret) and regret < 0.7, regret


@pytest.mark.parametrize("kw, match", [
    (dict(mode="DOL", b_symmetric=False), "b_symmetric"),
    (dict(mode="GOSSIP"), "mode"),
    (dict(iteration_number=500), "iteration_number")])
def test_refusals(kw, match):
    x, y = _streams()
    with pytest.raises(ValueError, match=match):
        DecentralizedOnlineAPI(x, y, DecentralizedConfig(**kw), device="cpu")
    with pytest.raises(RuntimeError, match="train"):
        DecentralizedOnlineAPI(x, y, DecentralizedConfig(),
                               device="cpu").regret()
