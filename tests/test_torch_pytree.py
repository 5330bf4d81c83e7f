"""The port's state-dict algebra against the JAX package's pytree algebra,
on the same numpy inputs.

The port's state dict is keyed by dotted module paths; the JAX side holds
the same arrays in a dict whose keys sort in the same order, so the leaf
orders agree. Elementwise helpers are held bit for bit; the reductions
(``tree_dot``, ``tree_norm``, ``tree_mean``) at rtol 1e-6, since XLA and
torch sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import pytree as jpt
from fedml_tpu.core.robust import is_weight_param as jax_is_weight_param
from fedml_tpu_torch.core import pytree as pt
from fedml_tpu_torch.core.robust import is_weight_param

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"bn.running_mean": (6,), "bn.weight": (6,),
          "conv1.weight": (6, 1, 3, 3), "fc.bias": (4,),
          "fc.weight": (4, 6)}


def _trees(seed, lead=()):
    rng = np.random.RandomState(seed)
    arrays = {k: rng.randn(*(lead + s)).astype(np.float32)
              for k, s in SHAPES.items()}
    return ({k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def _same(got, want, **tol):
    assert list(got) == sorted(want)
    for k in got:
        g, w = got[k], np.asarray(want[k])
        assert tuple(g.shape) == w.shape, k
        if tol:
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32), **tol)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("op", ["zeros_like", "scale", "axpy", "cast_f16"])
def test_elementwise_helpers_match_jax(op):
    (ta, ja), (tb, jb) = _trees(1), _trees(2)
    got, want = {
        "zeros_like": lambda: (pt.tree_zeros_like(ta),
                               jpt.tree_zeros_like(ja)),
        "scale": lambda: (pt.tree_scale(ta, 0.37), jpt.tree_scale(ja, 0.37)),
        "axpy": lambda: (pt.tree_axpy(-1.5, ta, tb),
                         jpt.tree_axpy(-1.5, ja, jb)),
        "cast_f16": lambda: (pt.tree_cast(ta, torch.float16),
                             jpt.tree_cast(ja, jnp.float16)),
    }[op]()
    _same(got, want)


@pytest.mark.parametrize("op", ["dot", "norm"])
def test_reductions_match_jax(op):
    (ta, ja), (tb, jb) = _trees(3), _trees(4)
    if op == "dot":
        got, want = pt.tree_dot(ta, tb), jpt.tree_dot(ja, jb)
    else:
        got, want = pt.tree_norm(ta), jpt.tree_norm(ja)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_unstack_index_and_mean_match_jax():
    ts, js = _trees(5, lead=(3,))
    got, want = pt.tree_unstack(ts, 3), jpt.tree_unstack(js, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    _same(pt.tree_index(ts, 1), jpt.tree_index(js, 1))
    _same(pt.tree_mean(ts), jpt.tree_mean(js), rtol=1e-6, atol=1e-7)


def test_path_filter_on_dotted_names_matches_jax_on_slash_paths():
    # the port's names are dotted; the JAX filter joins flax's key path
    # with '/': the same tree nested by parts gives the same selection
    ta, _ = _trees(6)
    nested = {}
    for k, v in ta.items():
        mod, leaf = k.split(".")
        nested.setdefault(mod, {})[leaf] = jnp.asarray(v.numpy())
    got = pt.tree_map_with_path_filter(lambda t: t * 2.0, ta,
                                       is_weight_param)
    want = jpt.tree_map_with_path_filter(lambda t: t * 2.0, nested,
                                         jax_is_weight_param)
    flat = {f"{m}.{leaf}": v for m, sub in want.items()
            for leaf, v in sub.items()}
    _same(got, flat)
    assert torch.equal(got["bn.running_mean"], ta["bn.running_mean"])
    assert not torch.equal(got["bn.weight"], ta["bn.weight"])
    assert jax.tree.structure(want) == jax.tree.structure(nested)
