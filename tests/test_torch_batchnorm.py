"""The port's flax-semantics BatchNorm (models/common.BatchNorm) in the
train step, against flax's ``mutable=["batch_stats"]`` apply through the
JAX package's local trainer.

Cases run a small CifarResNet (one bottleneck block a stage) from the same
converted weights and statistics, shuffle off, on batches that hold
padding rows: the statistics are those of the whole padded batch, the
variance the biased one, and the running statistics move by 0.9/0.1.
Tolerances: rtol=1e-4, atol=1e-5 for params and statistics (torch and XLA
sum a convolution's terms in another order); a gated padding-only step
leaves params and statistics bit for bit as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from fedml_tpu.models.resnet import CifarResNet as FlaxCifarResNet
from fedml_tpu.trainer.functional import TrainConfig as JaxTrainConfig
from fedml_tpu.trainer.functional import make_local_train as jax_local_train
from fedml_tpu_torch.models.common import BatchNorm, collect_batch_stats
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.trainer.functional import (TrainConfig, make_eval,
                                                make_local_train,
                                                make_train_step)
from fedml_tpu_torch.utils.convert import flax_to_state_dict

TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(n_pad=8, real=6, classes=5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n_pad, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, classes, n_pad).astype(np.int32)
    mask = np.zeros(n_pad, np.float32)
    mask[:real] = 1.0
    x[real:] = 0.0  # padding rows as pack_clients lays them
    y[real:] = 0
    flax_model = FlaxCifarResNet(stage_sizes=[1, 1, 1], num_classes=classes)
    variables = jax.tree.map(np.asarray, flax_model.init(
        jax.random.key(2), jnp.asarray(x)))
    # running statistics away from their init, so the 0.9 term shows
    variables["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.rand(*a.shape)).astype(np.float32),
        variables["batch_stats"])
    model = CifarResNet([1, 1, 1], classes)
    return flax_model, model, variables, x, y, mask


def _port_local(model, variables, x, y, mask, **cfg):
    local = make_local_train(model, "classification", TrainConfig(
        shuffle=False, **cfg))
    out, stats = local(flax_to_state_dict(variables, model),
                       torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(mask), seed=0)
    return out, stats


def _jax_local(flax_model, model, variables, x, y, mask, **cfg):
    local = jax_local_train(flax_model, "classification", JaxTrainConfig(
        shuffle=False, **cfg))
    out, stats = local(variables, jnp.asarray(x), jnp.asarray(y),
                       jnp.asarray(mask), jax.random.key(0))
    return flax_to_state_dict(jax.tree.map(np.asarray, out), model), stats


@pytest.mark.parametrize("cfg", [
    dict(batch_size=8, lr=0.1),                        # one padded step
    dict(batch_size=4, lr=0.1, epochs=2),              # a padding-only batch
    dict(batch_size=4, lr=0.05, momentum=0.9, epochs=2)])
def test_train_steps_match_flax_mutable_batch_stats(cfg):
    flax_model, model, variables, x, y, mask = _setup(
        real=3 if cfg.get("epochs") == 2 and cfg["lr"] == 0.1 else 6)
    got, got_stats = _port_local(model, variables, x, y, mask, **cfg)
    want, want_stats = _jax_local(flax_model, model, variables, x, y, mask,
                                  **cfg)
    start = flax_to_state_dict(variables, model)
    assert list(got) == list(start)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)
    # the JAX statistics moved, and so did the port's
    moved = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(moved) == 2 * sum(isinstance(m, BatchNorm)
                                 for m in model.modules())
    for k in moved:
        assert not np.allclose(want[k].numpy(), start[k].numpy()), k
    for k in want_stats:
        np.testing.assert_allclose(float(got_stats[k]),
                                   float(want_stats[k]), rtol=1e-5)


def test_batch_stats_use_the_biased_variance_of_the_padded_batch():
    bn = BatchNorm(3)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 3, 2, 2).astype(np.float32))
    x[-1] = 0.0  # a padding row counts in the statistics
    with collect_batch_stats() as sink:
        y = bn(x, train=True)
    mean, var = sink[bn]
    xs = x.permute(1, 0, 2, 3).reshape(3, -1).double()
    np.testing.assert_allclose(mean.numpy(), 0.1 * xs.mean(1).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        var.numpy(), 0.9 + 0.1 * xs.var(1, unbiased=False).numpy(),
        rtol=1e-6)
    # nothing was written into the buffers
    assert not bn.running_mean.any() and torch.equal(bn.running_var,
                                                     torch.ones(3))
    want = (xs - xs.mean(1, keepdim=True)) / torch.sqrt(
        xs.var(1, unbiased=False, keepdim=True) + 1e-5)
    np.testing.assert_allclose(
        y.detach().permute(1, 0, 2, 3).reshape(3, -1).numpy(), want.numpy(),
        atol=1e-5)
    with pytest.raises(RuntimeError, match="collect_batch_stats"):
        bn(x, train=True)


def test_gated_padding_only_step_leaves_params_and_stats_unchanged():
    _, model, variables, x, y, mask = _setup()
    start = flax_to_state_dict(variables, model)
    pnames = [n for n, _ in model.named_parameters()]
    init, step = make_train_step(model, "classification",
                                 TrainConfig(lr=0.1, momentum=0.9))
    params = [start[n] for n in pnames]
    colls = {k: v for k, v in start.items() if k not in pnames}
    xb, yb, mb = (torch.from_numpy(a[:4]) for a in (x, y, mask))
    for gate, same in ((False, True), (True, False)):
        p, c, _, stats = step(pnames, params, colls, init(params), xb, yb,
                              mb, 3, has_real=torch.tensor(gate))
        assert all(torch.equal(a, b) for a, b in zip(p, params)) == same
        assert all(torch.equal(c[k], colls[k]) for k in colls) == same
        assert (float(stats["count"]) == 0) == same


def test_eval_reads_the_running_statistics():
    flax_model, model, variables, x, y, mask = _setup()
    want = flax_model.apply(variables, jnp.asarray(x))
    got = make_eval(model, "classification")(
        flax_to_state_dict(variables, model), torch.from_numpy(x),
        torch.from_numpy(y), torch.from_numpy(mask))
    logits = np.asarray(want)
    per = -jax.nn.log_softmax(logits)[np.arange(len(y)), y]
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float((np.asarray(per) * mask).sum()),
                               rtol=1e-5)
