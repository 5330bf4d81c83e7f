"""Byte-identical sampling, data and packing: the port against the JAX
package on the same seeds."""

import numpy as np
import pytest

from fedml_tpu.core import sampling as jax_sampling
from fedml_tpu.data.flagship_gen import \
    build_femnist_federation as jax_femnist
from fedml_tpu.data.synthetic import make_blob_federated as jax_blob
from fedml_tpu_torch.core import sampling
from fedml_tpu_torch.core.partition import partition_data
from fedml_tpu_torch.data.flagship_gen import build_femnist_federation
from fedml_tpu_torch.data.registry import DEFAULT_MODEL_AND_TASK, load_data
from fedml_tpu_torch.data.synthetic import make_blob_federated


@pytest.mark.parametrize("total, per_round", [(10, 3), (100, 10), (7, 7),
                                              (50, 60), (3400, 10)])
@pytest.mark.parametrize("delete_client", [None, 2])
def test_sample_clients_byte_identical(total, per_round, delete_client):
    for r in (0, 1, 5, 123):
        got = sampling.sample_clients(r, total, per_round, delete_client)
        want = jax_sampling.sample_clients(r, total, per_round,
                                           delete_client)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("delete_client", [None, 4])
def test_virtual_sampling_byte_identical_below_and_above_threshold(
        delete_client):
    for threshold in (50, 10_000):  # 50 < 200 clients: the O(k) path
        for r in range(4):
            got = sampling.sample_clients_virtual(r, 200, 9, delete_client,
                                                  threshold=threshold)
            want = jax_sampling.sample_clients_virtual(
                r, 200, 9, delete_client, threshold=threshold)
            assert got.tobytes() == want.tobytes()
            assert len(set(got.tolist())) == 9
            if delete_client is not None:
                assert delete_client not in got


@pytest.mark.parametrize("n, limit, seed", [(100, 30, 0), (100, None, 1),
                                            (10, 50, 2), (1000, 999, 3)])
def test_eval_subsample_byte_identical(n, limit, seed):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.int32)
    gx, gy = sampling.eval_subsample(x, y, limit, seed)
    wx, wy = jax_sampling.eval_subsample(x, y, limit, seed)
    assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


def test_round_keys_are_a_pure_distinct_chain():
    _, seeds, agg = sampling.round_keys(0, 3, [5, 6, 7])
    _, again, agg2 = sampling.round_keys(0, 3, [7, 6, 5])
    assert seeds == again[::-1] and agg == agg2
    _, other, _ = sampling.round_keys(0, 4, [5, 6, 7])
    _, other_base, _ = sampling.round_keys(1, 3, [5, 6, 7])
    assert len({*seeds, agg, *other, *other_base}) == 10
    assert all(0 <= s < 2**63 for s in seeds + [agg])


def _assert_same_federation(got, want):
    assert got.client_num == want.client_num
    assert got.class_num == want.class_num
    assert got.train_data_local_num_dict == want.train_data_local_num_dict
    for c in range(want.client_num):
        for part in ("train_data_local_dict", "test_data_local_dict"):
            gx, gy = getattr(got, part)[c]
            wx, wy = getattr(want, part)[c]
            assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
            assert gx.tobytes() == wx.tobytes()
            assert gy.tobytes() == wy.tobytes()
    for part in ("train_data_global", "test_data_global"):
        for a, b in zip(getattr(got, part), getattr(want, part)):
            assert a.tobytes() == b.tobytes()


def test_femnist_gen_bit_identical():
    got = build_femnist_federation(client_num=20, seed=0)
    _assert_same_federation(got, jax_femnist(client_num=20, seed=0))
    assert got.train_data_global[0].shape[1:] == (28, 28, 1)
    assert got.class_num == 62


@pytest.mark.parametrize("method", ["hetero", "homo"])
def test_blob_bit_identical(method):
    got = make_blob_federated(client_num=6, partition_method=method, seed=3)
    want = jax_blob(client_num=6, partition_method=method, seed=3)
    _assert_same_federation(got, want)


def test_registry_pairs_the_main_path_with_the_cnn():
    assert DEFAULT_MODEL_AND_TASK["femnist_gen"] == ("cnn", "classification")
    ds = load_data("blob", client_num_in_total=4)
    _assert_same_federation(ds, jax_blob(client_num=4))
    with pytest.raises(ValueError, match="unknown dataset"):
        load_data("cifar10")


def test_partition_rejects_too_few_samples():
    with pytest.raises(ValueError, match="cannot give"):
        partition_data(np.zeros(20, np.int32), "hetero", 5, class_num=2)


@pytest.mark.parametrize("pack", ["cohort", "global"])
def test_pack_clients_identical(pack):
    ds = build_femnist_federation(client_num=12, seed=1)
    ref = jax_femnist(client_num=12, seed=1)
    for r in range(3):
        idxs = sampling.sample_clients(r, 12, 4)
        n_pad = (ds.cohort_padded_len(idxs, 20) if pack == "cohort"
                 else ds.padded_len(20))
        assert n_pad == (ref.cohort_padded_len(idxs, 20) if pack == "cohort"
                         else ref.padded_len(20))
        got = ds.pack_clients(idxs, 20, n_pad=n_pad)
        want = ref.pack_clients(idxs, 20, n_pad=n_pad)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        assert (ds.client_weights(idxs).tobytes()
                == ref.client_weights(idxs).tobytes())


def test_pack_clients_rejects_oversized_client():
    ds = make_blob_federated(client_num=4, seed=0)
    with pytest.raises(ValueError, match="n_pad"):
        ds.pack_clients([0], 8, n_pad=8)
