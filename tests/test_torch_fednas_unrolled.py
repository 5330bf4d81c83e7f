"""The port's second-order FedNAS (``arch_unrolled``: the alphas' gradient
taken through the virtual weight step ``w - lr * grad_w L_train``,
``create_graph=True`` in the port, ``jax.grad`` through the step in the JAX
package) against the JAX package's round, on one reduction cell (its
program is the largest of the three variants to compile); the set-up and
tolerances of ``tests/test_torch_fednas.py``. Also the alphas' optimizer,
``add_decayed_weights`` then Adam with ``b1 = 0.5``, against optax's over
a few steps in float32 and float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu_torch.trainer.functional import decayed_adam
from test_torch_fednas import search_round_matches_jax


def test_unrolled_search_round_matches_jax():
    search_round_matches_jax("unrolled", 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decayed_adam_matches_optax(dtype):
    rng = np.random.RandomState(12)
    params = [rng.randn(4, 8).astype(dtype) for _ in range(2)]
    grads = [[rng.randn(4, 8).astype(dtype) * 10.0 ** -s for _ in range(2)]
             for s in range(4)]
    with jax.enable_x64(dtype == np.float64):
        tx = optax.chain(optax.add_decayed_weights(1e-3),
                         optax.adam(3e-4, b1=0.5, b2=0.999))
        p = [jnp.asarray(a) for a in params]
        state = tx.init(p)
        for g in grads:
            u, state = tx.update([jnp.asarray(a) for a in g], state, p)
            p = optax.apply_updates(p, u)
        want = [np.asarray(a) for a in p]
    opt = decayed_adam(3e-4, 1e-3, b1=0.5, b2=0.999)
    got = [torch.tensor(a) for a in params]
    state = opt.init(got)
    for g in grads:
        u, state = opt.update([torch.tensor(a) for a in g], state, got)
        got = torch._foreach_add(got, u)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol)
