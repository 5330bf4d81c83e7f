"""The port's aggregation kernel wrapper against the JAX Pallas kernel.

On the CPU the wrapper runs its plain version; these tests hold that
version (and the state-dict front end) against ``fedml_tpu.ops``'s kernel
in interpret mode and its jnp oracle, on the same numpy inputs. Tolerance
rtol=1e-5, atol=1e-6 (as tests/test_ops.py): the reduction order over the
client axis differs between the implementations.

The ``gpu`` test holds the CUDA kernel against the plain version on the
card and skips where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops import (tree_weighted_mean_pallas, weighted_mean_flat as
                           jax_weighted_mean_flat,
                           weighted_mean_flat_reference as jax_reference)
from fedml_tpu_torch.core.pytree import tree_weighted_mean
from fedml_tpu_torch.ops.aggregate import (flatten_stack,
                                           tree_weighted_mean_fused,
                                           weighted_mean_flat,
                                           weighted_mean_flat_reference)

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(c, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(c, d).astype(np.float32),
            rng.uniform(1, 100, size=c).astype(np.float32))


@pytest.mark.parametrize("c", [1, 3, 7, 50])
@pytest.mark.parametrize("d", [5000, 4096, 1000])
def test_flat_matches_jax_kernel_and_oracle(c, d):
    x, w = _inputs(c, d, seed=c * 10000 + d)
    got = weighted_mean_flat(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (d,)
    kernel = jax_weighted_mean_flat(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True)
    oracle = jax_reference(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


def test_flat_accepts_row_padded_view():
    # the front end's buffer: rows padded to a multiple of 4 floats
    x, w = _inputs(3, 1001, seed=5)
    buf = torch.zeros(3, 1004)
    buf[:, :1001] = torch.from_numpy(x)
    got = weighted_mean_flat(buf[:, :1001], torch.from_numpy(w))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_reference(jnp.asarray(x),
                                              jnp.asarray(w))), **TOL)


def _mixed_tree(c, seed):
    rng = np.random.RandomState(seed)
    return {
        "conv.weight": rng.randn(c, 5, 3, 3, 3).astype(np.float32),
        "dense.kernel": rng.randn(c, 17, 33).astype(np.float32),
        "dense.bias": rng.randn(c, 33).astype(np.float32),
        "scalar": rng.randn(c).astype(np.float32),
    }


def test_tree_front_end_matches_jax_front_end():
    tree = _mixed_tree(4, seed=2)
    w = np.asarray([10.0, 20.0, 30.0, 40.0], np.float32)
    got = tree_weighted_mean_fused({k: torch.from_numpy(v)
                                    for k, v in tree.items()},
                                   torch.from_numpy(w))
    want = tree_weighted_mean_pallas({k: jnp.asarray(v)
                                      for k, v in tree.items()},
                                     jnp.asarray(w), interpret=True)
    assert list(got) == list(tree)
    for k in tree:
        assert tuple(got[k].shape) == tree[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)


def test_tree_front_end_matches_per_leaf_mean():
    tree = {k: torch.from_numpy(v) for k, v in _mixed_tree(3, 4).items()}
    w = torch.tensor([3.0, 1.0, 7.0])
    got = tree_weighted_mean_fused(tree, w)
    want = tree_weighted_mean(tree, w)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL)


def test_flatten_stack_pads_rows_to_16_bytes():
    tree = {k: torch.from_numpy(v) for k, v in _mixed_tree(2, 6).items()}
    flat = flatten_stack(tree)
    d = sum(v[0].numel() for v in tree.values())
    assert tuple(flat.shape) == (2, d)
    assert flat.stride(0) % 4 == 0 and flat.stride(0) >= d
    assert torch.equal(flat[1, :135], tree["conv.weight"][1].reshape(-1))


@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16,
                                   torch.float64])
def test_wrapper_rejects_other_dtypes(dtype):
    x = torch.ones(3, 8, dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        weighted_mean_flat(x, torch.ones(3))


@pytest.mark.parametrize("x, w", [
    (torch.ones(3, 8), torch.ones(2)),       # weights of the wrong length
    (torch.ones(3, 8, 2), torch.ones(3)),    # not a [C, D] stack
    (torch.ones(8), torch.ones(8)),          # not a [C, D] stack
])
def test_wrapper_rejects_bad_shapes(x, w):
    with pytest.raises(ValueError):
        weighted_mean_flat(x, w)


def test_cpu_plain_version_takes_any_strides():
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3).t()
    w = torch.tensor([1.0, 1.0, 2.0])
    np.testing.assert_allclose(weighted_mean_flat(x, w).numpy(),
                               weighted_mean_flat(x.contiguous(), w).numpy(),
                               **TOL)


def test_cpu_tensor_does_not_count_a_launch():
    before = weighted_mean_flat.launches
    weighted_mean_flat(torch.ones(2, 4), torch.ones(2))
    assert weighted_mean_flat.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c, d", [(10, 1_206_590), (1, 4099), (50, 5001)])
def test_cuda_kernel_matches_plain_version(cuda_device, c, d):
    x, w = _inputs(c, d, seed=7)
    # the row-padded layout of the front end, and the contiguous layout
    buf = torch.zeros(c, -(-d // 4) * 4, device=cuda_device)
    buf[:, :d] = torch.from_numpy(x).to(cuda_device)
    xs = torch.from_numpy(x).to(cuda_device)
    wt = torch.from_numpy(w).to(cuda_device)
    before = weighted_mean_flat.launches
    for stacked in (buf[:, :d], xs):
        got = weighted_mean_flat(stacked, wt)
        torch.cuda.synchronize()
        want = weighted_mean_flat_reference(stacked, wt)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)
    assert weighted_mean_flat.launches == before + 2


def test_state_dict_algebra_matches_jax_pytree():
    from fedml_tpu.core import pytree as jpt
    from fedml_tpu_torch.core import pytree as tpt

    # sorted keys: jax orders dict leaves by key, state dicts by insertion
    tree = dict(sorted(_mixed_tree(3, seed=8).items()))
    flat = tpt.tree_ravel({k: torch.from_numpy(v) for k, v in tree.items()})
    want = jpt.tree_ravel({k: jnp.asarray(v) for k, v in tree.items()})
    assert flat.numpy().tobytes() == np.asarray(want).tobytes()
    assert tpt.tree_size({k: torch.from_numpy(v) for k, v in tree.items()}) \
        == jpt.tree_size(tree) == flat.numel()
    back = tpt.tree_unravel({k: torch.from_numpy(v) for k, v in tree.items()},
                            flat)
    assert all(torch.equal(back[k], torch.from_numpy(tree[k])) for k in tree)
    stacked = {k: torch.from_numpy(v) for k, v in tree.items()}
    w = np.asarray([2.0, 5.0, 1.0], np.float32)
    got = tpt.tree_weighted_mean(stacked, torch.from_numpy(w))
    ref = jpt.tree_weighted_mean({k: jnp.asarray(v) for k, v in tree.items()},
                                 jnp.asarray(w))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL)
    pair = tpt.tree_stack([tpt.tree_unravel(back, flat)] * 2)
    assert all(tuple(v.shape) == (2,) + tuple(back[k].shape)
               for k, v in pair.items())
