"""The port's int8 quantizer against the JAX package's Pallas kernels.

The plain quantize and dequantize (what a CPU tensor runs) must equal
``fedml_tpu.ops.quantize.quantize_int8`` / ``dequantize_int8`` in interpret
mode BIT FOR BIT: both sides get the same random bits, drawn here exactly
as the JAX wrapper draws them (``jax.random.bits(key, (rows + row_pad,
512), uint32)``, the first D of them flat). The ``gpu`` tests hold the CUDA
kernels against the plain versions, bit for bit, and skip without a card.
"""

import functools
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


@functools.partial(jax.jit, static_argnames=("d",))
def _jax_quantize_with_residual(x, key, d):
    """JAX's quantize and ``x - dequantize_int8(q, scales, d)`` in one jit,
    as the JAX package's ``topk_quantize`` composes them."""
    q, s = jax_quantize(x, key, interpret=True)
    return q, s, x - jax_dequantize(q, s, d, interpret=True)


def _residual_roundings(x, q, s):
    """``x - q * scale`` rounded once (through f64, exact but for the case
    ``dequantize_int8_reference`` documents) and rounded twice (the product
    first, then the difference), as f32 bit patterns."""
    per = np.repeat(np.asarray(s), tq.BLOCK)[:x.size]
    q = np.asarray(q)
    once = (x.astype(np.float64)
            - q.astype(np.float64) * per.astype(np.float64)).astype(
                np.float32)
    with np.errstate(invalid="ignore"):
        twice = x - q.astype(np.float32) * per
    return once.view(np.int32), twice.view(np.int32)


@pytest.mark.parametrize("kind", ["normal", "wide_range"])
@pytest.mark.parametrize("d", [1, 511, 512, 513, 2570, 60_330])
def test_fused_residual_matches_jax(d, kind):
    """``quantize_int8(..., residual=True)`` returns JAX's ``(q, scales)``
    bit for bit and the residual rounded once. XLA's CPU backend fuses
    JAX's ``x - dequantize(q)`` into one rounding at the smaller sizes
    (bit-identical here up to D = 2570), not at D = 60,330, where it
    rounds the product first: there the two differ only where JAX's value
    is that double rounding."""
    x = values(kind, d, seed=d + 1)
    key = jax.random.key(d + (3 if kind == "normal" else 5))
    bits = jax_bits(key, d)
    if d >= 8:
        assert (bits >> 31).any()  # the top bit is exercised
    jq, js, jres = _jax_quantize_with_residual(jnp.asarray(x), key, d)
    q, s, res = tq.quantize_int8(torch.from_numpy(x), as_bits(bits),
                                 residual=True)
    assert same_bits(q.numpy(), jq) and same_bits(s.numpy(), js)
    once, twice = _residual_roundings(x, jq, js)
    got, want = res.numpy().view(np.int32), np.asarray(jres).view(np.int32)
    assert (got == once).all()
    assert ((got == want) | (want == twice)).all()
    if d <= 2570:
        assert same_bits(res.numpy(), jres)
    # the residual is what the dequantize computes from a minuend
    assert same_bits(res.numpy(), tq.dequantize_int8(
        q, s, d, subtract_from=torch.from_numpy(x)).numpy())


def test_fused_residual_keeps_nan_and_inf_blocks():
    """A NaN or infinite block has a NaN residual (its scale is NaN or
    infinite and its q 0); the other blocks' residuals are JAX's, bit for
    bit. JAX's int8 codes in such blocks are undefined (the cast of NaN),
    so only the other blocks' codes are compared."""
    x = _nan_inf_input()
    d = x.numel()
    key = jax.random.key(9)
    jq, js, jres = _jax_quantize_with_residual(jnp.asarray(x.numpy()), key,
                                               d)
    q, s, res = tq.quantize_int8(x, as_bits(jax_bits(key, d)),
                                 residual=True)
    bad = torch.zeros(d, dtype=torch.bool)
    for b in (0, 2, 3):
        bad[512 * b:512 * (b + 1)] = True
    assert torch.isnan(res[bad]).all()
    keep = (~bad).numpy()
    assert same_bits(q.numpy()[keep], np.asarray(jq)[keep])
    assert same_bits(np.isnan(s.numpy()), np.isnan(np.asarray(js)))
    assert same_bits(s.numpy()[1:2], np.asarray(js)[1:2])
    assert same_bits(res.numpy()[keep], np.asarray(jres)[keep])


# -- the launchers' tiling, mirrored from csrc/quantize.cu -------------------

TILING_DS = [1, 511, 512, 513, 2570, 60_330, 1_206_590]
SMS = 132  # the H100's SMs


def dequant_plan(d, ctas_per_sm, sms=SMS):
    """``dequant_grid``, ``even_share`` and ``dequant_kernel``'s vector
    path: the grid, each block's run of whole scale blocks, each lane's
    accesses (warp w of a block takes the run's scale blocks w, w + 4, ...;
    lane l reads the char4 of int8 at 128 j + 4 l, j < 4, and writes the
    float4 of f32 and reads the minuend's there), and the value range the
    grid's last block converts one value at a time. Returns ``(grid, runs,
    accesses, scalar)``, each access ``(array, byte offset, bytes)``."""
    whole = d // tq.BLOCK
    grid = max(1, min(sms * ctas_per_sm, whole))
    runs, accesses = [], []
    base, extra = divmod(whole, grid)
    for c in range(grid):
        count = base + (c < extra)
        first = c * base + min(c, extra)
        runs.append((first, count))
        for w in range(4):
            for blk in range(first + w, first + count, 4):
                for j in range(4):
                    for lane in range(32):
                        i = blk * tq.BLOCK + 128 * j + 4 * lane
                        accesses += [("q", i, 4), ("minuend", 4 * i, 16),
                                     ("out", 4 * i, 16)]
    return grid, runs, accesses, (whole * tq.BLOCK, d)


def quant_plan(d):
    """``fedml_quantize_int8`` and ``quant_kernel``: one block of 128
    threads per scale block, 4 consecutive values a thread; the vector
    accesses of the full blocks (16-byte x, bits and residual, a char4 of
    q) and the masked values of the ragged one. Returns ``(grid, threads,
    accesses)``: each thread's value range and each vector access as
    ``(array, byte offset, bytes)``."""
    grid = tq.num_blocks(d)
    threads, accesses = [], []
    for blk in range(grid):
        full = (blk + 1) * tq.BLOCK <= d
        for t in range(128):
            i = blk * tq.BLOCK + 4 * t
            threads.append((i, min(i + 4, d)))
            if full:
                accesses += [("x", 4 * i, 16), ("bits", 4 * i, 16),
                             ("res", 4 * i, 16), ("q", i, 4)]
    return grid, threads, accesses


def _covered_once(ranges, d):
    hits = np.zeros(d, np.int64)
    for lo, hi in ranges:
        hits[lo:hi] += 1
    return (hits == 1).all()


@pytest.mark.parametrize("ctas_per_sm", [1, 4])
@pytest.mark.parametrize("d", TILING_DS)
def test_dequantize_tiling_covers_d_once_in_aligned_accesses(d,
                                                              ctas_per_sm):
    grid, runs, accesses, scalar = dequant_plan(d, ctas_per_sm)
    assert grid <= SMS * ctas_per_sm
    counts = [c for _, c in runs]
    assert max(counts) - min(counts) <= 1  # an even split
    outs = [(off // 4, off // 4 + 4) for a, off, _ in accesses
            if a == "out"]
    assert _covered_once(outs + [scalar], d)
    # every access is aligned to its size: with 16-byte aligned pointers
    # the vector path never straddles
    assert all(off % size == 0 for _, off, size in accesses)
    # the misaligned path walks the same runs one value at a time, the
    # grid's last block through to D
    tiles = [(f * tq.BLOCK, (f + c) * tq.BLOCK) for f, c in runs]
    assert _covered_once(tiles[:-1] + [(tiles[-1][0], d)], d)


@pytest.mark.parametrize("d", TILING_DS)
def test_quantize_tiling_covers_d_once_in_aligned_accesses(d):
    grid, threads, accesses = quant_plan(d)
    assert grid == tq.num_blocks(d)
    assert _covered_once([r for r in threads if r[0] < r[1]], d)
    assert all(off % size == 0 for _, off, size in accesses)
    if d >= tq.BLOCK:  # a full block takes the vector path
        assert accesses


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


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 511, 512, 513, 2570, 60_330, 1_206_590])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_residual_equals_plain_version_on_the_card(cuda, d, offset):
    """The quantize kernel's residual output, bit for bit, on its 16-byte
    path (offset 0) and its scalar path (offset 1), with random bits whose
    top bit is set half the time."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + 1)
    x = torch.randn(d + offset, generator=gen, device=cuda)[offset:]
    x[: min(d, 512)] *= 1e30
    bits = tq.random_bits(d + offset, gen)[offset:]
    q, s, res = tq.quantize_int8(x, bits, residual=True)
    want_q, want_s = tq.quantize_int8_reference(x, bits)
    want_res = tq.dequantize_int8_reference(want_q, want_s, x)
    assert tq.takes_vec_paths(x, bits, q, res, residual=res)[0] == (
        offset == 0)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q)
    assert torch.equal(s.view(torch.int32), want_s.view(torch.int32))
    assert torch.equal(res.view(torch.int32), want_res.view(torch.int32))


@pytest.mark.gpu
def test_fused_residual_keeps_nan_and_inf_blocks_on_the_card(cuda):
    x = _nan_inf_input().to(cuda)
    bits = torch.zeros(2570, dtype=torch.int32, device=cuda)
    q, s, res = tq.quantize_int8(x, bits, residual=True)
    want_q, want_s = tq.quantize_int8_reference(x, bits)
    want_res = tq.dequantize_int8_reference(want_q, want_s, x)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q)
    assert torch.equal(torch.isnan(res), torch.isnan(want_res))
    keep = ~torch.isnan(res)
    assert torch.equal(res[keep].view(torch.int32),
                       want_res[keep].view(torch.int32))
