"""The graph-safe dropout key: masks from a counter hash of (step seed,
dropout site, element index) in plain int64 torch ops, so they are the same
on the CPU, on the card and inside a replayed CUDA graph, and do not depend
on the padded length a batch was cut from. ``mix32`` is held against the
same hash written with numpy's wrapping uint32 arithmetic."""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.core.sampling import counter_bits, fold32, mix32
from fedml_tpu_torch.models.common import DropoutKey, dropout


def _lowbias32_numpy(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x = x * np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x = x * np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def test_mix32_is_lowbias32_in_wrapping_uint32():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**32, size=10_000, dtype=np.uint64)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    got = mix32(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  _lowbias32_numpy(x))
    assert mix32(12345) == int(mix32(torch.tensor(12345)))


def test_masks_are_a_function_of_seed_and_site_only():
    x = torch.ones(64, 50)

    def masks(seed):
        key = DropoutKey(torch.tensor(seed))
        return [dropout(x, 0.5, True, key) != 0 for _ in range(2)]

    a, b, c = masks(3), masks(3), masks(4)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], a[1])  # each site draws its own mask
    assert not torch.equal(a[0], c[0])
    # a 63-bit seed's high half matters too
    hi = masks(3 + (5 << 40))
    assert not torch.equal(a[0], hi[0])


def test_masks_do_not_depend_on_the_padded_length():
    """A full batch of the real rows, and the same rows followed by
    padding: every site's mask on the real rows is the same."""
    real, padded = torch.ones(13, 7, 3), torch.ones(32, 7, 3)
    ka, kb = DropoutKey(torch.tensor(9)), DropoutKey(torch.tensor(9))
    for _ in range(3):
        a = dropout(real, 0.25, True, ka)
        b = dropout(padded, 0.25, True, kb)
        assert torch.equal(a, b[:13])


@pytest.mark.parametrize("p", [0.25, 0.5, 0.9])
def test_keep_rate_is_one_minus_p(p):
    n = 400_000
    kept = dropout(torch.ones(n), p, True, DropoutKey(torch.tensor(11))) != 0
    rate = kept.double().mean().item()
    # five standard deviations of a binomial mean
    assert abs(rate - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    out = dropout(torch.ones(n), p, True, DropoutKey(torch.tensor(11)))
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / (1 - p)))


def test_counter_bits_broadcast_over_keys():
    keys = torch.tensor([[1, 2], [3, 4]])
    bits = counter_bits(keys, 5, "cpu")
    assert bits.shape == (2, 2, 5)
    assert torch.equal(bits[1, 0], counter_bits(torch.tensor(3), 5, "cpu"))
    assert int(fold32(torch.tensor(7), 2)) == fold32(7, 2)


@pytest.mark.parametrize("key", [0, 2**32 - 1, 987654321,
                                 np.array([[3, 2**31 + 7], [0, 2**32 - 1]])])
def test_counter_bits_are_lowbias32_of_the_weyl_counters(key):
    """The cached per-size counters and the in-place hash give the bits of
    the formula, on the first call of a size and on every later one."""
    n = 1237
    want = _lowbias32_numpy(
        (np.arange(n, dtype=np.uint64) * 0x9E3779B9
         + np.asarray(key, np.uint64)[..., None]) % 2**32)
    if isinstance(key, np.ndarray):
        key = torch.from_numpy(key.astype(np.int64))
    for _ in range(2):
        got = counter_bits(key, n, "cpu")
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_generator_form_still_draws_from_its_generator():
    x = torch.ones(1000)
    g = torch.Generator().manual_seed(5)
    a = dropout(x, 0.25, True, g)
    b = dropout(x, 0.25, True, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.25, True, None)


@pytest.mark.gpu
def test_masks_are_the_same_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (compares the card's masks with "
                    "the CPU's)")
    x = torch.ones(20, 64, 12, 12)
    cpu = dropout(x, 0.25, True, DropoutKey(torch.tensor(77)))
    card = dropout(x.cuda(), 0.25, True,
                   DropoutKey(torch.tensor(77, device="cuda")))
    assert torch.equal(cpu, card.cpu())
