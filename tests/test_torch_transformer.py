"""The port's TransformerLM against the flax model, from converted weights.

Eval forward at rtol = atol = 2e-4 (the tolerance of
tests/test_flash_attention.py's transformer check: attention and the
dense layers sum in another order in torch than in XLA, and the flash
path's online softmax in yet another), with both the plain attention and
the flash attention's CPU path; the gradient of the masked nwp loss at
rtol 1e-4 (atol 1e-6 for entries near zero); the nwp head's sums at
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.transformer import TransformerLM as FlaxLM
from fedml_tpu.trainer.tasks import nwp_head as jax_nwp_head
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops.flash_attention import make_flash_attention
from fedml_tpu_torch.trainer.functional import make_forward
from fedml_tpu_torch.trainer.tasks import PAD_TOKEN, nwp_head
from fedml_tpu_torch.utils.convert import flax_to_state_dict

CFG = dict(vocab_size=40, width=32, depth=2, num_heads=2, max_len=32)


def _case():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 40, (3, 32)).astype(np.int32)
    y = rng.randint(0, 40, (3, 32)).astype(np.int32)
    y[:, -5:] = PAD_TOKEN  # pad tokens inside real rows
    mask = np.array([1.0, 1.0, 0.0], np.float32)  # a padding row
    flax_model = FlaxLM(**CFG)
    # the variables' tree from flax (traced, not run), their values from
    # numpy: LayerNorm scales and biases are random too
    shapes = jax.eval_shape(flax_model.init, jax.random.key(1),
                            jnp.asarray(x))
    variables = jax.tree.map(
        lambda sd: (0.3 * rng.randn(*sd.shape)).astype(np.float32), shapes)
    want = np.asarray(jax.jit(flax_model.apply)(variables, jnp.asarray(x)))
    return flax_model, variables, x, y, mask, want


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.mark.parametrize("attn", ["plain", "flash"])
def test_eval_forward_matches_flax(case, attn):
    _, variables, x, _, _, want = case
    model = TransformerLM(**CFG, attn_fn=(make_flash_attention(16, 16)
                                          if attn == "flash" else None))
    state = flax_to_state_dict(variables, model)
    got = make_forward(model)(state, torch.from_numpy(x), False)
    assert got.shape == (3, 32, 40)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=2e-4)


def test_masked_nwp_gradient_matches_flax(case):
    flax_model, variables, x, y, mask, _ = case

    def loss(v):
        stats = jax_nwp_head(flax_model.apply(v, jnp.asarray(x)),
                             jnp.asarray(y), jnp.asarray(mask))
        return stats["loss_sum"] / jnp.maximum(stats["count"], 1.0)

    model = TransformerLM(**CFG, attn_fn=make_flash_attention(16, 16))
    grads = jax.jit(jax.grad(loss))(variables)
    want = flax_to_state_dict(jax.tree.map(np.asarray, grads), model)
    state = flax_to_state_dict(variables, model)
    leaves = {k: v.requires_grad_(True) for k, v in state.items()}
    out = make_forward(model)(leaves, torch.from_numpy(x), False)
    stats = nwp_head(out, torch.from_numpy(y), torch.from_numpy(mask))
    got = torch.autograd.grad(stats["loss_sum"] / stats["count"].clamp(min=1),
                              list(leaves.values()))
    for k, g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_nwp_head_sums_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(4, 9, 11).astype(np.float32)
    y = rng.randint(0, 11, (4, 9)).astype(np.int32)
    y[:, -3:] = PAD_TOKEN
    y[1, 0] = PAD_TOKEN
    mask = np.array([1, 1, 0, 1], np.float32)
    got = nwp_head(*map(torch.from_numpy, (logits, y, mask)))
    want = jax.jit(jax_nwp_head)(*map(jnp.asarray, (logits, y, mask)))
    assert set(got) == set(want)
    assert float(got["count"]) == ((y != PAD_TOKEN) * mask[:, None]).sum()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def test_factory_and_parameter_count_match_flax(case):
    variables = case[1]
    model = create_model("transformer", output_dim=40, width=32, depth=2,
                         num_heads=2, max_len=32)
    assert isinstance(model, TransformerLM)
    n_flax = sum(a.size for a in jax.tree.leaves(variables))
    assert sum(p.numel() for p in model.parameters()) == n_flax


def test_converter_rejects_wrong_shape(case):
    variables = case[1]
    params = jax.tree.map(lambda a: a, variables)
    blk = params["params"]["TransformerBlock_0"]
    blk["Dense_0"]["kernel"] = blk["Dense_0"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="TransformerBlock_0/Dense_0/kernel"):
        flax_to_state_dict(params, TransformerLM(**CFG))


@pytest.mark.parametrize("drop", ["TransformerBlock_1/LayerNorm_1",
                                  "pos_embed/embedding"])
def test_converter_rejects_missing_key(case, drop):
    variables = case[1]
    params = jax.tree.map(lambda a: a, variables)
    *path, last = drop.split("/")
    node = params["params"]
    for p in path:
        node = node[p]
    del node[last]
    with pytest.raises(KeyError):
        flax_to_state_dict(params, TransformerLM(**CFG))


@pytest.mark.parametrize("kw", [dict(moe_experts=4), dict(remat=True),
                                dict(attn_fn="auto")])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerLM(**CFG, **kw)


def test_sequence_longer_than_max_len_raises():
    model = TransformerLM(**{**CFG, "max_len": 8})
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros(1, 9, dtype=torch.int32))


def test_dropout_draws_from_the_generator():
    torch.manual_seed(0)
    model = TransformerLM(**CFG, dropout=0.5)
    x = torch.randint(0, 40, (2, 16), dtype=torch.int32)
    a = model(x, True, torch.Generator().manual_seed(3))
    b = model(x, True, torch.Generator().manual_seed(3))
    c = model(x, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(model(x), model(x))  # eval: no dropout
