"""The port's secure aggregation against the JAX package's: the copied MPC
toolbox gives the JAX package's arrays on the same inputs and generator
states, the share protocol gives JAX's secure mean bit for bit (exact
field arithmetic on the same float64 products), and the secure FedAvg
round stays within fixed-point round-off of the plain weighted mean.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.turboaggregate import \
    SecureAggregator as JaxSecureAggregator
from fedml_tpu.core import mpc as jax_mpc
from fedml_tpu.core import pytree as jax_pt
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.algorithms.turboaggregate import (SecureAggregator,
                                                       SecureFedAvgAPI,
                                                       TurboAggregateConfig,
                                                       coded_share_exchange)
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.data.synthetic import make_blob_federated
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.functional import TrainConfig

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = mpc.DEFAULT_PRIME


def _both(fn_name, *args, seed=0, **kw):
    """Call the port's and JAX's function with generators in one state."""
    out = []
    for mod in (mpc, jax_mpc):
        extra = ({"rng": np.random.RandomState(seed)}
                 if "rng" in getattr(mod, fn_name).__code__.co_varnames
                 else {})
        out.append(getattr(mod, fn_name)(*args, **kw, **extra))
    return out


@pytest.mark.parametrize("fn, args", [
    ("gen_lagrange_coeffs", (np.arange(5, 11), np.arange(1, 5), P)),
    ("bgw_encoding", (np.arange(24).reshape(4, 6), 5, 2, P)),
    ("lcc_encoding", (np.arange(30).reshape(6, 5), 6, 2, 2, P)),
    ("gen_additive_ss", (np.arange(17), 5, P)),
    ("quantize", (np.linspace(-3, 3, 101), P, 16)),
    ("dequantize", (np.arange(0, P, P // 97), P, 16)),
])
def test_mpc_copy_matches_jax(fn, args):
    got, want = _both(fn, *args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("subset", [[0, 1, 2], [1, 3, 4], [0, 2, 4]])
def test_bgw_roundtrip(subset):
    rng = np.random.RandomState(0)
    secret = rng.randint(0, P, size=(4, 6)).astype(np.int64)
    shares = mpc.bgw_encoding(secret, N=5, T=2, p=P, rng=rng)
    np.testing.assert_array_equal(
        mpc.bgw_decoding(shares[subset], subset, P), secret)
    assert not np.array_equal(mpc.bgw_decoding(shares[subset[:2]],
                                               subset[:2], P), secret)


@pytest.mark.parametrize("K, T", [(2, 0), (2, 1), (3, 2)])
def test_lcc_roundtrip(K, T):
    rng = np.random.RandomState(2)
    N = K + T + 2
    X = rng.randint(0, P, size=(2 * K * 3, 5)).astype(np.int64)
    coded = mpc.lcc_encoding(X, N, K, T, P, rng)
    surviving = list(range(1, K + T + 1))
    np.testing.assert_array_equal(
        mpc.lcc_decoding(coded[surviving], N, K, T, surviving, P), X)


def test_quantization_roundtrip_and_coded_exchange():
    x = np.random.RandomState(5).randn(1000) * 10
    back = mpc.dequantize(mpc.quantize(x, frac_bits=16), frac_bits=16)
    assert np.max(np.abs(back - x)) <= 2.0 ** -16
    block = np.random.RandomState(7).randint(0, P, size=(6, 4)).astype(
        np.int64)
    _, reconstruct = coded_share_exchange(block, K=2, T=1, n_workers=6,
                                          prime=P,
                                          rng=np.random.RandomState(8))
    np.testing.assert_array_equal(reconstruct([0, 2, 5]), block)


def test_secure_mean_equals_jax_bit_for_bit_and_the_plain_mean():
    rng = np.random.RandomState(6)
    w = rng.randn(4, 3, 2).astype(np.float32)
    b = rng.randn(4, 2).astype(np.float32)
    weights = np.asarray([10.0, 20.0, 5.0, 15.0], np.float32)
    port = SecureAggregator().aggregate(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        torch.from_numpy(weights), round_idx=3)
    want = JaxSecureAggregator().aggregate(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, weights, round_idx=3)
    for k in want:
        assert np.array_equal(port[k].numpy(), np.asarray(want[k])), k
    plain = jax_pt.tree_weighted_mean({"w": jnp.asarray(w),
                                       "b": jnp.asarray(b)},
                                      jnp.asarray(weights))
    for k in plain:
        # fixed point: 2**-17 of round-off a client, weighted
        np.testing.assert_allclose(port[k].numpy(), np.asarray(plain[k]),
                                   atol=2.0 ** -16)


def test_masks_change_with_the_round_and_the_sum_does_not():
    agg = SecureAggregator(TurboAggregateConfig(seed=1))
    x = np.linspace(-1, 1, 50)
    a = agg.client_shares(x, 4, np.random.RandomState(0))
    b = agg.client_shares(x, 4, np.random.RandomState(1))
    assert not np.array_equal(a, b)
    assert np.array_equal(a.sum(0) % P, b.sum(0) % P)
    stacked = {"w": torch.from_numpy(np.stack([x, -x]).astype(np.float32))}
    r0 = agg.aggregate(stacked, torch.tensor([1.0, 3.0]), round_idx=0)
    r1 = agg.aggregate(stacked, torch.tensor([1.0, 3.0]), round_idx=1)
    assert torch.equal(r0["w"], r1["w"])


def test_secure_fedavg_rounds_stay_near_fedavg():
    ds = make_blob_federated(client_num=6, seed=0)
    tc = TrainConfig(epochs=1, batch_size=16, lr=0.1, shuffle=False)
    cfg = FedAvgConfig(comm_round=3, client_num_per_round=4, train=tc,
                       frequency_of_the_test=100)
    model = create_model("lr", ds.class_num, input_shape=(20,))
    sec = SecureFedAvgAPI(ds, model, config=cfg, device="cpu")
    avg = FedAvgAPI(ds, model, config=cfg, device="cpu")
    for r in range(3):
        sec.run_round(r)
        avg.run_round(r)
    for k in avg.variables:
        # fixed-point round-off a round, carried through local training
        np.testing.assert_allclose(sec.variables[k].numpy(),
                                   avg.variables[k].numpy(), atol=1e-4)
    assert sec.train()["test_acc"] > 0.8


def test_secure_fedavg_cannot_fuse_rounds():
    ds = make_blob_federated(client_num=4, seed=0)
    api = SecureFedAvgAPI(ds, create_model("lr", ds.class_num,
                                           input_shape=(20,)), device="cpu")
    with pytest.raises(TypeError, match="cannot fuse"):
        api.fused_rounds()


def test_jax_tree_order_does_not_change_the_secure_mean():
    """The port ravels a state dict in its own leaf order, JAX in flax's;
    the protocol is elementwise, so the masks' order changes nothing."""
    rng = np.random.RandomState(9)
    leaves = {k: rng.randn(3, 4).astype(np.float32) for k in "ab"}
    fwd = SecureAggregator().aggregate(
        {k: torch.from_numpy(v) for k, v in leaves.items()},
        torch.tensor([1.0, 2.0, 3.0]))
    rev = SecureAggregator().aggregate(
        {k: torch.from_numpy(leaves[k]) for k in "ba"},
        torch.tensor([1.0, 2.0, 3.0]))
    for k in "ab":
        assert torch.equal(fwd[k], rev[k])
