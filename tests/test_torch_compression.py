"""The port's wire codec, top-k and policy against the JAX package's.

Top-k: the stable-sort selection equals the numpy oracle bit for bit
(indices, values, residual), planted ties and signed zeros included, and
``topk_quantize`` equals JAX's given the bits JAX draws from the same key.
Codec: on a state dict of 1-D leaves whose names sort the same in flax and
torch (so the flat layouts coincide), ``compress_delta``, ``compress_topk``
and ``decompress`` give the JAX package's ``q`` / ``s`` / ``i`` / ``v``,
residual and rebuilt model, bit for bit, with the same bits. No tolerance
anywhere in this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm import compression as jc
from fedml_tpu.comm.policy import resolve_compression as jax_resolve
from fedml_tpu.ops.quantize import _pad_rows
from fedml_tpu.ops.sparsify import topk_quantize as jax_topk_quantize
from fedml_tpu_torch.comm import compression as tc
from fedml_tpu_torch.ops import quantize as tq
from fedml_tpu_torch.ops import sparsify as tsp
from fedml_tpu_torch.comm import serialization
from fedml_tpu_torch.comm.policy import (ENV_VAR, CompressionPolicy,
                                         parse_policy, resolve_compression)
from fedml_tpu_torch.ops.sparsify import (k_for, topk_densify,
                                          topk_dequantize, topk_quantize,
                                          topk_sparsify,
                                          topk_sparsify_reference)


def jax_bits(key, n):
    """The uint32 bits ``quantize_int8`` draws from ``key`` for an
    ``n``-vector, as an int32 tensor of their bit patterns."""
    rows, pad = _pad_rows(n)
    bits = np.asarray(jax.random.bits(key, (rows + pad, 512), jnp.uint32))
    return torch.from_numpy(bits.reshape(-1)[:n].view(np.int32).copy())


def same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.view(np.uint8) == b.view(np.uint8)).all()


def planted(d, seed):
    """A delta with exact magnitude ties (across signs) and signed zeros."""
    rng = np.random.RandomState(seed)
    x = rng.randn(d).astype(np.float32)
    x[rng.choice(d, d // 5, replace=False)] = 0.5
    x[rng.choice(d, d // 10, replace=False)] = -0.5
    x[rng.choice(d, d // 10, replace=False)] = -0.0
    x[rng.choice(d, d // 10, replace=False)] = 0.0
    return x


@pytest.mark.parametrize("d, k", [(1, 1), (100, 7), (1000, 300),
                                  (2570, 26), (5000, 4900)])
def test_topk_sparsify_matches_the_oracle(d, k):
    x = planted(d, seed=d + k)
    idx, vals, res = topk_sparsify(torch.from_numpy(x), k)
    want = topk_sparsify_reference(x, k)
    assert same(idx, want[0]) and same(vals, want[1]) and same(res, want[2])
    # inplace writes the same residual into the input
    flat = torch.from_numpy(x.copy())
    _, _, res2 = topk_sparsify(flat, k, inplace=True)
    assert res2.data_ptr() == flat.data_ptr() and same(res2, want[2])


@pytest.mark.parametrize("d, k", [(3000, 150), (5000, 700), (900, 900)])
def test_topk_quantize_matches_jax(d, k):
    x = planted(d, seed=k)
    key = jax.random.key(k)
    jidx, jq, js, jres = jax_topk_quantize(jnp.asarray(x), key, k,
                                           interpret=True)
    idx, q, s, res = topk_quantize(torch.from_numpy(x), jax_bits(key, k), k)
    assert same(idx, jidx) and same(q, jq) and same(s, js)
    assert same(res, jres)
    dense = topk_dequantize(idx, q, s, d)
    assert same(dense, np.asarray(
        jax.numpy.zeros(d).at[jidx].set(
            np.asarray(q, np.float32) * np.repeat(np.asarray(js), 512)[:k])))


def test_topk_quantize_kept_signed_zero_becomes_plus_zero():
    """Keeping more entries than there are non-zeros keeps -0.0 slots; the
    residual there is 0.0 + (-0.0 - 0.0) = +0.0, as JAX's scatter-add."""
    x = np.array([3.0, -0.0, 1.0, -0.0, 0.0], np.float32)
    key = jax.random.key(0)
    *_, jres = jax_topk_quantize(jnp.asarray(x), key, 5, interpret=True)
    *_, res = topk_quantize(torch.from_numpy(x), jax_bits(key, 5), 5)
    assert same(res, jres)
    assert not np.signbit(res.numpy()).any()


def test_topk_quantize_encodes_in_one_quantize_call(monkeypatch):
    """The kept values' quantization error comes from the quantize call
    itself (``residual=True``): an encode runs no dequantize."""
    calls = []

    def quantize(*args, **kwargs):
        calls.append(kwargs)
        return tq.quantize_int8(*args, **kwargs)

    def dequantize(*args, **kwargs):
        raise AssertionError("topk_quantize ran a dequantize")
    monkeypatch.setattr(tsp, "quantize_int8", quantize)
    monkeypatch.setattr(tsp, "dequantize_int8", dequantize)
    x = planted(3000, seed=150)
    key = jax.random.key(150)
    *_, jres = jax_topk_quantize(jnp.asarray(x), key, 150, interpret=True)
    *_, res = topk_quantize(torch.from_numpy(x), jax_bits(key, 150), 150)
    assert calls == [{"residual": True}]
    assert same(res, jres)


def test_k_for_and_densify():
    assert k_for(1_206_590, 0.05) == 60_330
    assert k_for(10, 0.01) == 1 and k_for(10, 1.0) == 10
    with pytest.raises(ValueError):
        k_for(10, 0.0)
    out = topk_densify(torch.tensor([2, 0], dtype=torch.int32),
                       torch.tensor([1.5, -2.0]), 4)
    assert out.tolist() == [-2.0, 0.0, 1.5, 0.0]


# -- the codec against the JAX package ---------------------------------------

SIZES = {"a": 700, "b": 1300, "c": 37}


def trees(seed):
    rng = np.random.RandomState(seed)
    base = {k: rng.randn(n).astype(np.float32) for k, n in SIZES.items()}
    new = {k: v + 0.05 * rng.randn(v.size).astype(np.float32)
           for k, v in base.items()}
    return base, new


def torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_compress_delta_and_decompress_match_jax():
    base, new = trees(0)
    key = jax.random.key(11)
    d = sum(SIZES.values())
    jp = jc.compress_delta(jax_tree(new), jax_tree(base), key,
                           interpret=True)
    p = tc.compress_delta(torch_tree(new), torch_tree(base), jax_bits(key, d))
    assert p["d"] == jp["d"] == d
    assert same(p["q"], jp["q"]) and same(p["s"], jp["s"])
    assert tc.is_compressed(p) and p[tc.COMPRESSED_FLAG]
    got = tc.decompress(p, torch_tree(base))
    want = jc.decompress(jp, jax_tree(base), interpret=True)
    assert list(got) == list(SIZES)
    for k in SIZES:
        assert same(got[k], want[k])


@pytest.mark.parametrize("quantize", [True, False])
def test_compress_topk_with_error_feedback_matches_jax(quantize):
    """Two rounds, the second carrying the first's residual."""
    base, new = trees(1)
    d = sum(SIZES.values())
    frac = 0.05
    k = k_for(d, frac)
    jres = res = None
    for r in range(2):
        key = jax.random.key(100 + r)
        jp, jres = jc.compress_topk(jax_tree(new), jax_tree(base), jres, key,
                                    frac=frac, quantize=quantize,
                                    interpret=True)
        p, res = tc.compress_topk(torch_tree(new), torch_tree(base), res,
                                  jax_bits(key, k), frac=frac,
                                  quantize=quantize)
        assert same(p["i"], jp["i"]) and same(res, jres)
        if quantize:
            assert same(p["q"], jp["q"]) and same(p["s"], jp["s"])
        else:
            assert same(p["v"], jp["v"])
        got = tc.decompress(p, torch_tree(base))
        want = jc.decompress(jp, jax_tree(base), interpret=True)
        for name in SIZES:
            assert same(got[name], want[name])


@pytest.mark.parametrize("policy", ["delta_int8", "topk_ef_int8:0.05",
                                    "topk_ef:0.05"])
def test_frame_arrays_match_jax_lengths_and_dtypes(policy):
    base, new = trees(2)
    jpol, pol = jax_resolve(policy), resolve_compression(policy)
    key = jax.random.key(5)
    jp, _ = jc.compress_for_policy(jax_tree(new), jax_tree(base), None, key,
                                   jpol, interpret=True)
    gen = torch.Generator()
    gen.manual_seed(5)
    p, _ = tc.compress_for_policy(torch_tree(new), torch_tree(base), None,
                                  gen, pol)
    arrays = {k: v for k, v in jp.items() if isinstance(v, np.ndarray)}
    assert set(arrays) == {k for k, v in p.items()
                           if isinstance(v, np.ndarray)}
    for name, arr in arrays.items():
        assert p[name].dtype == arr.dtype and p[name].shape == arr.shape
    assert tc.wire_bytes(p) == len(serialization.dumps(p))


def test_uncompressed_policy_ships_the_model_as_numpy():
    base, new = trees(3)
    p, res = tc.compress_for_policy(torch_tree(new), torch_tree(base), None,
                                    torch.Generator(),
                                    resolve_compression("none"))
    assert res is None and not tc.is_compressed(p)
    assert all(same(p[k], new[k]) for k in SIZES)


def test_skew_guards_refuse_to_rebuild():
    base, new = trees(4)
    p = tc.compress_delta(torch_tree(new), torch_tree(base),
                          torch.Generator())
    short = dict(torch_tree(base), c=torch.zeros(36))
    with pytest.raises(ValueError, match="parameters"):
        tc.decompress(p, short)
    # the same count, another shape: only the fingerprint sees it
    reshaped = dict(torch_tree(base), b=torch.zeros(2, 650))
    with pytest.raises(ValueError, match="fingerprint"):
        tc.decompress(p, reshaped)
    pt_, _ = tc.compress_topk(torch_tree(new), torch_tree(base), None,
                              torch.Generator(), frac=0.01)
    pt_["i"] = pt_["i"].copy()
    pt_["i"][0] = sum(SIZES.values())
    with pytest.raises(ValueError, match="outside"):
        tc.decompress(pt_, torch_tree(base))
    pt_["i"][0] = -1
    with pytest.raises(ValueError, match="outside"):
        tc.decompress(pt_, torch_tree(base))


def test_fingerprint_is_the_same_for_tensors_and_their_numpy_copy():
    base, _ = trees(5)
    t = torch_tree(base)
    assert tc.tree_fingerprint(t) == tc.tree_fingerprint(tc.to_numpy(t))
    assert tc.tree_fingerprint(t) != tc.tree_fingerprint(
        dict(t, a=t["a"].double()))


def test_precomputed_bits_must_cover_the_quantizer():
    base, new = trees(6)
    with pytest.raises(ValueError, match="random words"):
        tc.compress_delta(torch_tree(new), torch_tree(base),
                          torch.zeros(10, dtype=torch.int32))


# -- the frame codec --------------------------------------------------------

def test_frame_codec_round_trips_and_shares_one_encode():
    payload = {"q": np.arange(5, dtype=np.int8), "s": np.float32([0.5]),
               "d": 5, "fp": "abc", "flag": True, "none": None,
               "nested": [np.zeros((2, 3), np.float32), (1, 2.5)],
               "raw": b"\x00\x01", "scalar": np.float32(1.5),
               "empty": np.zeros(0, np.int32), 7: "int key"}
    back = serialization.loads(serialization.dumps(payload))
    assert list(back) == list(payload)
    assert same(back["q"], payload["q"]) and back["d"] == 5
    assert back["nested"][0].shape == (2, 3)
    assert back["nested"][1] == (1, 2.5)
    assert back["raw"] == b"\x00\x01" and back[7] == "int key"
    assert back["scalar"] == 1.5 and back["empty"].shape == (0,)
    shared = serialization.SharedPayload(payload)
    frames = [serialization.dumps({"env": i, "m": shared}) for i in range(3)]
    assert shared.encode_count == 1
    assert frames[1] == serialization.dumps({"env": 1, "m": payload})
    with pytest.raises(TypeError, match="unserializable"):
        serialization.dumps({"t": torch.zeros(2)})


# -- the policy ladder ------------------------------------------------------

@pytest.mark.parametrize("text", ["none", "delta_int8", "topk_ef",
                                  "topk_ef_int8", "topk_ef:0.05",
                                  " topk_ef_int8:0.2 "])
def test_policy_parse_matches_jax(text):
    got, want = parse_policy(text), jax_resolve(text)
    for f in ("name", "topk_frac", "downlink", "enabled", "uplink_topk",
              "uplink_int8", "downlink_enabled"):
        assert getattr(got, f) == getattr(want, f)


def test_policy_env_override_and_legacy_flag(monkeypatch):
    assert resolve_compression(None).name == "none"
    legacy = resolve_compression(None, compress=True)
    assert legacy.name == "delta_int8" and not legacy.downlink_enabled
    explicit = CompressionPolicy("topk_ef", topk_frac=0.5)
    monkeypatch.setenv(ENV_VAR, "topk_ef_int8:0.1")
    assert ENV_VAR == "FEDML_TPU_TORCH_COMPRESSION"
    env = resolve_compression("delta_int8")
    assert (env.name, env.topk_frac) == ("topk_ef_int8", 0.1)
    assert resolve_compression(None, compress=True).name == "topk_ef_int8"
    assert resolve_compression(explicit) is explicit
    with pytest.raises(ValueError):
        parse_policy("gzip")
    with pytest.raises(ValueError):
        parse_policy("topk_ef:1.5")
