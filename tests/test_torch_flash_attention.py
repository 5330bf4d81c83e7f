"""The port's flash attention against the JAX package's Pallas kernels.

The JAX kernels run in interpret mode, as tests/test_flash_attention.py
runs them; the port runs its plain versions (the CPU path of every
wrapper), on the same numpy inputs and at the JAX tests' sizes. Forward
rtol = atol = 2e-5 (the online softmax sums its blocks in another order
than the dense plain version), gradients 2e-4 (the backward sums over
blocks in yet another order, as tests/test_flash_attention.py allows),
bf16 inputs against the f32 oracle 5e-2. The CUDA kernels are held to the
same plain versions on the card (the ``gpu`` tests and chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _fwd_pallas
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu.parallel.sequence import reference_attention as jax_ref
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.ops import flash_attention as fa
from fedml_tpu_torch.parallel.sequence import reference_attention

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _qkv(b=2, s=64, h=2, d=16, seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.cache
def _jax_fwd(s, causal, bq, bk):
    q, k, v = _qkv(s=s)
    out, lse = _fwd_pallas(*map(jnp.asarray, (q, k, v)), causal, bq, bk,
                           True)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("s, causal, bq, bk", [
    (64, False, 16, 16), (64, True, 16, 16),   # the JAX tests' oracle case
    (32, True, 32, 32),                        # a single block
    (64, True, 32, 16),                        # rectangular blocks
])
def test_fwd_reference_matches_pallas_out_and_lse(s, causal, bq, bk):
    want_out, want_lse = _jax_fwd(s, causal, bq, bk)
    out, lse = fa.fwd_reference(*_t(*_qkv(s=s)), causal)
    assert lse.shape == want_lse.shape and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, **FWD)
    np.testing.assert_allclose(lse.numpy(), want_lse, **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_pallas_and_oracle(causal):
    q, k, v = _t(*_qkv())
    got = fa.flash_attention(q, k, v, causal, 16, 16)
    np.testing.assert_allclose(got.numpy(), _jax_fwd(64, causal, 16, 16)[0],
                               **FWD)
    np.testing.assert_allclose(got.numpy(),
                               reference_attention(q, k, v, causal).numpy(),
                               **FWD)
    np.testing.assert_allclose(
        reference_attention(q, k, v, causal).numpy(),
        np.asarray(jax_ref(*map(jnp.asarray, _qkv()), causal)), **FWD)


def test_bfloat16_against_the_f32_oracle():
    q, k, v = _qkv()
    bf = [t.to(torch.bfloat16) for t in _t(q, k, v)]
    out = fa.flash_attention(*bf, True, 16, 16)
    assert out.dtype == torch.bfloat16
    want = reference_attention(*[t.float() for t in bf], True)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=5e-2,
                               atol=5e-2)


def test_indivisible_block_rejected():
    q, k, v = _t(*_qkv(s=48))
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(q, k, v, False, 32, 32)


def test_other_dtypes_rejected():
    q, k, v = _t(*_qkv(s=16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half(), True)


@functools.cache
def _jax_vjp(causal):
    """JAX flash_attention(..., interpret=True) at S=32, D=8: its output and
    the gradients that its custom VJP (_flash_bwd) gives for one dO."""
    q, k, v, do = map(jnp.asarray, _qkv(s=32, d=8, n=4))
    out, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, 16, 16,
                                                  True), q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_references_match_pallas_backward(causal):
    q, k, v, do = _t(*_qkv(s=32, d=8, n=4))
    out, lse = fa.fwd_reference(q, k, v, causal)
    want_out, want = _jax_vjp(causal)
    np.testing.assert_allclose(out.numpy(), want_out, **FWD)
    delta = fa.attention_delta(out, do)
    dk, dv = fa.bwd_dkdv_reference(q, k, v, do, lse, delta, causal)
    dq = fa.bwd_dq_reference(q, k, v, do, lse, delta, causal)
    for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **GRAD)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_through_flash_attention_matches_jax_vjp(causal):
    q, k, v, do = _t(*_qkv(s=32, d=8, n=4))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal, 16, 16)
    got = torch.autograd.grad(out, leaves, grad_outputs=do)
    for g, w in zip(got, _jax_vjp(causal)[1]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD)


def test_strided_views_of_one_projection_match_contiguous():
    """q, k, v as the transformer makes them (views of one qkv tensor with
    row stride 3 * width) give what contiguous copies give."""
    rng = np.random.RandomState(4)
    qkv = torch.from_numpy(rng.randn(2, 32, 3 * 32).astype(np.float32))
    views = [t.view(2, 32, 2, 16) for t in qkv.split(32, dim=-1)]
    assert views[0].stride() == (32 * 96, 96, 16, 1)
    got = fa.flash_attention(*views, True, 16, 16)
    want = fa.flash_attention(*[t.contiguous() for t in views], True, 16, 16)
    assert torch.equal(got, want)


def test_wrappers_take_the_plain_version_on_cpu():
    q, k, v, do = _t(*_qkv(s=16, n=4))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkdv.launches,
              fa.flash_bwd_dq.launches)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.attention_delta(out, do)
    fa.flash_bwd_dkdv(q, k, v, do, lse, delta, True)
    fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkdv.launches,
            fa.flash_bwd_dq.launches) == before


def test_auto_blocks_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.make_flash_attention("auto", 128)
    with pytest.raises(NotImplementedError, match="autotune"):
        TransformerLM(vocab_size=8, width=16, depth=1, num_heads=2,
                      max_len=8, attn_fn="auto")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, by bit masking: the kernels' hi part."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32: what the tensor core reads of an f32 register
    (the kernels pass the lo part unrounded)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b on TF32 operands in f32: one pass (hi * hi), or 3xTF32 (lo *
    hi + hi * lo + hi * hi, with lo = x - hi as the tensor core reads it)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_backward(q, k, v, do, lse, delta, passes):
    """The tensor-core backward of one causal head ([S, D] operands) with
    every product in TF32: the transposed scores K Q^T and V dO^T, P and dS
    from them, dV = P^T dO, dK = dS^T Q, dQ = dS K."""
    s, d = q.shape
    scale = 1.0 / d ** 0.5
    pos = torch.arange(s)
    future = pos[None, :] < pos[:, None]  # [key, query]: query before key
    pt = torch.exp(_mm_tf32(k, q.T, passes) * scale - lse[None, :])
    pt = torch.where(future, torch.zeros_like(pt), pt)
    dst = pt * (_mm_tf32(v, do.T, passes) - delta[None, :]) * scale
    return (_mm_tf32(dst, q, passes), _mm_tf32(pt, do, passes),
            _mm_tf32(dst.T.contiguous(), k, passes))


def test_3xtf32_backward_keeps_f32_tolerance_where_tf32_does_not():
    """Why the backward kernels take three TF32 passes a product: on one
    head at S = 2048, D = 64 (the LM path's), the 3xTF32 dK, dV and dQ
    hold the card's f32 tolerance (rtol = atol = 1e-4) against the plain
    versions, and one TF32 pass errs at least 10x more."""
    q, k, v, do = _t(*_qkv(b=1, s=2048, h=1, d=64, seed=7, n=4))
    out, lse = fa.fwd_reference(q, k, v, True)
    delta = fa.attention_delta(out, do)
    want_dk, want_dv = fa.bwd_dkdv_reference(q, k, v, do, lse, delta, True)
    want_dq = fa.bwd_dq_reference(q, k, v, do, lse, delta, True)
    wants = [w[0, :, 0] for w in (want_dk, want_dv, want_dq)]
    heads = [t[0, :, 0] for t in (q, k, v, do)]
    errs = {}
    for passes in (3, 1):
        got = _emulated_backward(*heads, lse[0, 0], delta[0, 0], passes)
        errs[passes] = max(float((g - w).abs().max())
                           for g, w in zip(got, wants))
        if passes == 3:
            for g, w, name in zip(got, wants, ("dk", "dv", "dq")):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4,
                                           msg=name)
    print(f"max abs error against the plain versions: 3xTF32 {errs[3]:.3g},"
          f" one TF32 pass {errs[1]:.3g}")
    assert errs[1] >= 10 * errs[3], errs


def _emulated_forward(q, k, v, causal, passes, tile=64):
    """The tensor-core forward of one head ([S, D] operands), tile by tile
    as the kernel runs it: 64-query tiles sweeping 64-key tiles (key tiles
    wholly in the future skipped), S = Q K^T and O += P V in TF32, scores
    in log2 units with the scale folded into the exponent, the running max
    from -1e30; ``(out [S, D], lse [S])`` in natural-log units."""
    s_len, d = q.shape
    scale_log2 = (1.0 / d ** 0.5) * float(np.log2(np.e))
    out, lse = torch.empty_like(q), torch.empty(s_len)
    for q0 in range(0, s_len, tile):
        qt = q[q0:q0 + tile]
        rows = torch.arange(q0, q0 + len(qt))
        m = torch.full((len(qt),), -1e30)
        l = torch.zeros(len(qt))
        acc = torch.zeros(len(qt), d)
        k_end = min(s_len, q0 + tile) if causal else s_len
        for k0 in range(0, k_end, tile):
            kt, vt = k[k0:k0 + tile], v[k0:k0 + tile]
            s = _mm_tf32(qt, kt.T.contiguous(), passes)
            if causal:
                future = rows[:, None] < torch.arange(k0, k0 + len(kt))[None]
                s = torch.where(future, torch.full_like(s, -1e30), s)
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[:, None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[:, None] + _mm_tf32(p, vt, passes)
            m = m_new
        lc = l.clamp(min=1e-30)
        out[q0:q0 + tile] = acc / lc[:, None]
        lse[q0:q0 + tile] = m * float(np.log(2.0)) + torch.log(lc)
    return out, lse


@pytest.mark.parametrize("s, causal", [
    (2048, True),    # the LM path's head shape
    (1000, True),    # a ragged S: the last tiles end inside a warp's rows
    (200, False),
])
def test_3xtf32_forward_keeps_f32_tolerance_where_tf32_does_not(s, causal):
    """The tensor-core forward's arithmetic on one head at D = 64: with
    three TF32 passes a product its out and lse hold the card's f32
    tolerance (rtol = atol = 1e-4) against the plain version, and with one
    pass they do not, erring at least 10x more."""
    q, k, v = _t(*_qkv(b=1, s=s, h=1, d=64, seed=11))
    want_out, want_lse = fa.fwd_reference(q, k, v, causal)
    want = (want_out[0, :, 0], want_lse[0, 0])
    heads = [t[0, :, 0] for t in (q, k, v)]
    errs, close = {}, {}
    for passes in (3, 1):
        got = _emulated_forward(*heads, causal, passes)
        errs[passes] = max(float((g - w).abs().max())
                           for g, w in zip(got, want))
        close[passes] = all(torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                            for g, w in zip(got, want))
        if passes == 3:
            for g, w, name in zip(got, want, ("out", "lse")):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4,
                                           msg=name)
    print(f"max abs error against the plain version: 3xTF32 {errs[3]:.3g},"
          f" one TF32 pass {errs[1]:.3g}")
    assert not close[1], errs
    assert errs[1] >= 10 * errs[3], errs


@pytest.fixture
def cuda_device():
    """Decided inside the test, never at import (the xdist workers must
    collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s, d, causal, dtype, strided", [
    (2048, 64, True, torch.float32, False),
    (256, 64, False, torch.float32, False),
    (32, 128, True, torch.float32, False),
    (48, 16, True, torch.float32, False),
    (128, 32, True, torch.bfloat16, False),
    (256, 64, True, torch.float32, True),
    # the tensor-core backward's risky tilings: D = 128 streams 32-row q
    # tiles in dK/dV; a ragged S ends inside a tile and a 16-row warp
    # slice; bf16 takes fewer 3xTF32 passes, at the LM path's S and layout
    (2048, 128, True, torch.float32, False),
    (1000, 64, True, torch.float32, False),
    (2048, 64, True, torch.bfloat16, True),
])
def test_kernels_match_plain_versions_on_card(cuda_device, s, d, causal,
                                              dtype, strided):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    b, h = 2, 4
    if strided:
        qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=cuda_device)
        q, k, v = (t.view(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=cuda_device)
                   for _ in range(3))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    do = torch.randn(b, s, h, d, generator=gen, device=cuda_device).to(dtype)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else dict(rtol=1e-4, atol=1e-4))
    out, lse = fa.flash_fwd(q, k, v, causal)
    want_out, want_lse = fa.fwd_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), want_out.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **tol)
    delta = fa.attention_delta(want_out, do)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, want_lse, delta, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, want_lse, delta, causal)
    want_dk, want_dv = fa.bwd_dkdv_reference(q, k, v, do, want_lse, delta,
                                             causal)
    want_dq = fa.bwd_dq_reference(q, k, v, do, want_lse, delta, causal)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.gpu
def test_backward_kernels_scalar_copy_path_on_card(cuda_device):
    """Inputs whose rows are not 16-byte aligned (views one element into a
    buffer) take the backward kernels' scalar copy path, and agree."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    b, s, h, d = 2, 200, 4, 64
    q, k, v, do = (torch.randn(b * s * h * d + 1, generator=gen,
                               device=cuda_device)[1:].view(b, s, h, d)
                   for _ in range(4))
    assert not fa.takes_async_copies(q, k, v, do)
    assert fa.takes_async_copies(*(t.clone() for t in (q, k, v, do)))
    out, lse = fa.fwd_reference(q, k, v, True)
    delta = fa.attention_delta(out, do)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    want_dk, want_dv = fa.bwd_dkdv_reference(q, k, v, do, lse, delta, True)
    want_dq = fa.bwd_dq_reference(q, k, v, do, lse, delta, True)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_forward_kernel_scalar_copy_path_on_card(cuda_device):
    """q, k, v whose rows are not 16-byte aligned (views one element into a
    buffer) take the forward kernel's scalar copy path, and its out and
    lse agree with the plain version."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    b, s, h, d = 2, 200, 4, 64
    q, k, v = (torch.randn(b * s * h * d + 1, generator=gen,
                           device=cuda_device)[1:].view(b, s, h, d)
               for _ in range(3))
    assert not fa.takes_async_copies(q, k, v)
    for causal in (True, False):
        out, lse = fa.flash_fwd(q, k, v, causal)
        want_out, want_lse = fa.fwd_reference(q, k, v, causal)
        torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_unbuilt_head_dim(cuda_device):
    q = torch.zeros(1, 16, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, True)
