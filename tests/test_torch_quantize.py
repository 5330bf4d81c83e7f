"""The port's int8 quantizer against the JAX package's Pallas kernels.

The plain quantize and dequantize (what a CPU tensor runs) must equal
``fedml_tpu.ops.quantize.quantize_int8`` / ``dequantize_int8`` in interpret
mode BIT FOR BIT: both sides get the same random bits, drawn here exactly
as the JAX wrapper draws them (``jax.random.bits(key, (rows + row_pad,
512), uint32)``, the first D of them flat). The ``gpu`` tests hold the CUDA
kernels against the plain versions, bit for bit, and skip without a card.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.quantize import _pad_rows
from fedml_tpu.ops.quantize import dequantize_int8 as jax_dequantize
from fedml_tpu.ops.quantize import quantize_int8 as jax_quantize
from fedml_tpu_torch.ops import quantize as tq

DS = [1, 511, 512, 513, 2570, 70000]


def jax_bits(key, d):
    """The uint32 bits ``quantize_int8`` draws from ``key`` for a
    ``d``-vector, flat, first ``d``."""
    rows, pad = _pad_rows(d)
    bits = jax.random.bits(key, (rows + pad, tq.BLOCK), jnp.uint32)
    return np.asarray(bits).reshape(-1)[:d]


def as_bits(bits_u32):
    return torch.from_numpy(bits_u32.view(np.int32).copy())


def values(kind, d, seed):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        x = rng.randn(d)
    else:  # magnitudes spanning 1e-30..1e30, both signs
        x = np.sign(rng.randn(d)) * 10.0 ** rng.uniform(-30, 30, d)
    x = x.astype(np.float32)
    if d >= 1024:
        x[512:1024] = 0.0  # an all-zero block
    return x


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.view(np.uint8) == b.view(np.uint8)).all()


@pytest.mark.parametrize("kind", ["normal", "wide_range"])
@pytest.mark.parametrize("d", DS)
def test_plain_quantizer_is_bit_exact_against_pallas(d, kind):
    x = values(kind, d, seed=d)
    key = jax.random.key(d + (0 if kind == "normal" else 7))
    bits = jax_bits(key, d)
    if d >= 8:
        assert (bits >> 31).any()  # the top bit is exercised
    jq, js = jax_quantize(jnp.asarray(x), key, interpret=True)
    jout = jax_dequantize(jq, js, d, interpret=True)
    q, s = tq.quantize_int8(torch.from_numpy(x), as_bits(bits))
    out = tq.dequantize_int8(q, s, d)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (tq.num_blocks(d),)
    assert same_bits(q.numpy(), jq)
    assert same_bits(s.numpy(), js)
    assert same_bits(out.numpy(), jout)


def test_scale_is_the_reciprocal_multiply_not_a_division():
    """XLA computes the TPU kernel's ``max(absmax, 1e-12) / 127`` as a
    multiply by f32(1/127); a division differs by an ulp on some blocks."""
    assert np.float32(tq.INV127).view(np.uint32) == 0x3C010204
    x = np.random.RandomState(0).randn(1_206_590).astype(np.float32)
    _, s = tq.quantize_int8(torch.from_numpy(x),
                            torch.zeros(x.size, dtype=torch.int32))
    absmax = np.abs(np.pad(x, (0, -x.size % 512))).reshape(-1, 512).max(1)
    assert same_bits(s.numpy(), absmax * np.float32(tq.INV127))
    assert not same_bits(s.numpy(), absmax / np.float32(127.0))


def test_random_bits_shift_is_logical():
    """bits = 0x80000000 is u = 0.5 (a logical shift), not -0.5 (an
    arithmetic shift of the int32 carrier, which would always round up)."""
    x = np.zeros(512, np.float32)
    x[0] = 127.0           # scale = 127 * f32(1/127), within an ulp of 1
    x[1:] = 10.25          # fraction ~0.25 < u = 0.5: rounds down
    bits = np.full(512, 0x80000000, np.uint32)
    q, s = tq.quantize_int8(torch.from_numpy(x), as_bits(bits))
    assert same_bits(s.numpy(), [np.float32(127.0) * np.float32(tq.INV127)])
    assert (q[1:].numpy() == 10).all()


def test_round_trip_error_is_below_one_step():
    x = values("normal", 5000, seed=3)
    bits = as_bits(np.random.RandomState(4).randint(
        0, 2**32, 5000, dtype=np.uint64).astype(np.uint32))
    q, s = tq.quantize_int8(torch.from_numpy(x), bits)
    out = tq.dequantize_int8(q, s, 5000).numpy()
    step = np.repeat(s.numpy(), 512)[:5000]
    assert (np.abs(out - x) <= step * (1 + 1e-6)).all()


def test_tree_front_end_matches_the_flat_kernel():
    rng = np.random.RandomState(5)
    tree = {"w": torch.from_numpy(rng.randn(40, 30).astype(np.float32)),
            "b": torch.from_numpy(rng.randn(30).astype(np.float32))}
    bits = as_bits(rng.randint(0, 2**32, 1230, dtype=np.uint64)
                   .astype(np.uint32))
    vals, scales, spec = tq.quantize_tree(tree, bits)
    q, s = tq.quantize_int8(torch.cat([tree["w"].reshape(-1), tree["b"]]),
                            bits)
    assert torch.equal(vals, q) and torch.equal(scales, s)
    back = tq.dequantize_tree(vals, scales, spec)
    assert list(back) == ["w", "b"]
    assert back["w"].shape == (40, 30)
    flat = tq.dequantize_int8(q, s, 1230)
    assert torch.equal(torch.cat([back["w"].reshape(-1), back["b"]]), flat)


def test_wrappers_check_their_inputs_and_never_fall_back():
    x = torch.zeros(10)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_int8(x, torch.zeros(9, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        tq.quantize_int8(x, torch.zeros(10, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32"):
        tq.quantize_int8(x.double(), torch.zeros(10, dtype=torch.int32))
    with pytest.raises(TypeError, match="scales"):
        tq.dequantize_int8(torch.zeros(10, dtype=torch.int8),
                           torch.zeros(2), 10)
    # a device that is neither the CPU nor CUDA raises: the plain version
    # runs only for CPU tensors
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quantize_int8(torch.zeros(10, device="meta"),
                         torch.zeros(10, dtype=torch.int32, device="meta"))
    before = (tq.quantize_int8.launches, tq.dequantize_int8.launches)
    q, s = tq.quantize_int8(x, torch.zeros(10, dtype=torch.int32))
    tq.dequantize_int8(q, s, 10)
    # the plain versions are not launches
    assert (tq.quantize_int8.launches, tq.dequantize_int8.launches) == before


def _nan_inf_input():
    x = values("normal", 2570, seed=7)
    x[3] = np.nan        # block 0
    x[1100] = np.inf     # block 2
    x[1700] = -np.inf    # block 3
    return torch.from_numpy(x)


def test_nan_and_inf_blocks_dequantize_to_nan():
    """A NaN keeps its block's scale NaN (the absmax keeps NaN) and the
    block's q at 0; an infinity gives an infinite scale and q = 0 (inf /
    inf is NaN). Either way the block dequantizes to NaN and the other
    blocks are untouched: a diverged silo ships NaN, not a finite step."""
    x = _nan_inf_input()
    bits = torch.zeros(2570, dtype=torch.int32)
    q, s = tq.quantize_int8(x, bits)
    assert torch.isnan(s[0]) and torch.isinf(s[2]) and torch.isinf(s[3])
    for b in (0, 2, 3):
        assert (q[512 * b:512 * (b + 1)] == 0).all()
    out = tq.dequantize_int8(q, s, 2570)
    bad = torch.zeros(2570, dtype=torch.bool)
    for b in (0, 2, 3):
        bad[512 * b:512 * (b + 1)] = True
    assert torch.isnan(out[bad]).all() and torch.isfinite(out[~bad]).all()
    clean = x.clone()
    clean[bad] = 0.0
    q2, s2 = tq.quantize_int8(clean, bits)
    assert torch.equal(q[~bad], q2[~bad])
    res = tq.dequantize_int8(q, s, 2570, subtract_from=x)
    assert torch.isnan(res[bad]).all() and torch.isfinite(res[~bad]).all()


def _round_once(exact: Fraction) -> np.float32:
    """The f32 nearest ``exact`` (ties to even), from exact arithmetic."""
    f = np.float32(float(exact))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        err = abs(Fraction(float(c)) - exact)
        key = (err, int(np.array(c).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


def test_dequantize_with_a_minuend_rounds_once():
    """``subtract_from - q * scale`` rounded once, against exact rational
    arithmetic, where it matters most: kept values far below their
    block's scale with q = +-1 (zero bits round every fraction up), next
    to values of every magnitude."""
    rng = np.random.RandomState(11)
    x = (rng.randn(2048) * 10.0 ** rng.uniform(-12, 0, 2048)).astype(
        np.float32)
    x[::512] = 1.0  # each block's absmax
    x[1:200] = np.sign(rng.randn(199)) * 10.0 ** rng.uniform(-30, -3, 199)
    xt = torch.from_numpy(x)
    q, s = tq.quantize_int8(xt, torch.zeros(2048, dtype=torch.int32))
    assert (q[1:200].abs() == 1).sum() > 50
    got = tq.dequantize_int8(q, s, 2048, subtract_from=xt).numpy()
    per = np.repeat(s.numpy(), 512)
    for i in range(2048):
        want = _round_once(Fraction(float(x[i]))
                           - int(q[i]) * Fraction(float(per[i])))
        assert got[i].view(np.int32) == np.float32(want).view(np.int32), i


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 511, 512, 513, 2570, 60_330, 1_206_590])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernels_equal_plain_versions_on_the_card(cuda, d, offset):
    """Bit for bit, on the 16-byte paths (offset 0) and on the scalar
    paths (offset 1: views one element into their buffers)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d)
    x = torch.randn(d + offset, generator=gen, device=cuda)[offset:]
    x[: min(d, 512)] *= 1e30
    bits = tq.random_bits(d + offset, gen)[offset:]
    q, s = tq.quantize_int8(x, bits)
    want_q, want_s = tq.quantize_int8_reference(x, bits)
    q_in = torch.empty(d + offset, dtype=torch.int8, device=cuda)[offset:]
    q_in.copy_(want_q)
    out = tq.dequantize_int8(q_in, want_s, d)
    want_out = tq.dequantize_int8_reference(want_q, want_s)
    res = tq.dequantize_int8(q_in, want_s, d, subtract_from=x)
    want_res = tq.dequantize_int8_reference(want_q, want_s, x)
    assert tq.takes_vec_paths(x, bits, q_in, out) == (offset == 0,
                                                    offset == 0)
    assert tq.takes_vec_paths(x, bits, q_in, res, x)[1] == (offset == 0)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q)
    assert torch.equal(s.view(torch.int32), want_s.view(torch.int32))
    assert torch.equal(out.view(torch.int32), want_out.view(torch.int32))
    assert torch.equal(res.view(torch.int32), want_res.view(torch.int32))


@pytest.mark.gpu
def test_kernels_keep_nan_and_inf_blocks_on_the_card(cuda):
    x = _nan_inf_input().to(cuda)
    bits = torch.zeros(2570, dtype=torch.int32, device=cuda)
    q, s = tq.quantize_int8(x, bits)
    want_q, want_s = tq.quantize_int8_reference(x, bits)
    out = tq.dequantize_int8(q, s, 2570)
    want_out = tq.dequantize_int8_reference(want_q, want_s)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q)
    for a, b in ((s, want_s), (out, want_out)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        keep = ~torch.isnan(a)
        assert torch.equal(a[keep].view(torch.int32),
                           b[keep].view(torch.int32))
