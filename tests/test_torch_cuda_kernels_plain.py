"""The plain PyTorch versions of the wire kernels
(``horovod_tpu_torch/ops/cuda_kernels.py``) against the JAX package's
Pallas functions (``horovod_tpu/ops/pallas_kernels.py``, interpret mode
on the CPU), on inputs made from one numpy seed.

- ``scale_cast``: bitwise for fp32 output, within one rounding for bf16.
- ``int8_quantize`` and ``int8_block_quantize``: the JAX interpret path
  draws its rounding bits from ``jax.random`` and the port from Philox,
  so they agree by contract: scales bitwise; every value ``floor`` or
  ``floor + 1`` of ``x / scale``; the mean over 64 seeds unbiased within
  4σ; a ragged tail's zero padding never sets a scale. Blocks 1, 3, 512
  and 1000 on sizes 1, 511, 513 and 100 003; the row form against
  ``traced._stochastic_round_blocks``, the fused wire's quantizer.
- The plain Philox against Random123's known-answer vectors, the target
  the kernel's Philox is held to on the card (bitwise there).
- ``adasum_pair`` against JAX ``adasum_pair`` within 1e-6 relative, on
  the cases of tests/test_adasum.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import cuda_kernels as ck

SIZES = [1, 511, 513, 100_003]
# max(absmax, 1e-30) / 127 is computed, by XLA and by the port, as a
# product with the fp32 reciprocal
INV_127 = np.float32(1.0) / np.float32(127.0)
BLOCKS = [1, 3, 512, 1000]


def _x(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x[: n // 3] *= 1e-3  # mixed magnitudes
    return x


# ------------------------------------------------------------ scale_cast


@pytest.mark.parametrize("in_dtype", ["int8", "float32", "bfloat16"])
def test_scale_cast_matches_jax(in_dtype):
    x = _x(4097) * 60
    if in_dtype == "int8":
        x = np.clip(np.round(x), -128, 127)
    jx = jnp.asarray(x).astype(in_dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, in_dtype))
    s = 0.0371
    got = ck.scale_cast(tx, s, torch.float32)
    want = np.asarray(pk.scale_cast(jx, s, jnp.float32))
    assert np.array_equal(got.numpy(), want)
    got16 = ck.scale_cast(tx, s, torch.bfloat16).float().numpy()
    want16 = np.asarray(pk.scale_cast(jx, s, jnp.bfloat16).astype(
        jnp.float32))
    # one bf16 rounding of the same fp32 product
    np.testing.assert_allclose(got16, want16, rtol=2 ** -8, atol=0)
    assert ck.int8_dequantize is not None


# ------------------------------------------------------ int8 quantizers


def _check_contract(x, vals, scale_per_elem):
    """Each value is floor or floor + 1 of x / scale (fp32), clipped."""
    scaled = (x.astype(np.float32) / scale_per_elem.astype(np.float32))
    floor = np.floor(scaled)
    v = vals.astype(np.float32)
    ok = (v == np.clip(floor, -128, 127)) | (v == np.clip(floor + 1, -128,
                                                          127))
    assert ok.all(), np.argwhere(~ok)[:5]


@pytest.mark.parametrize("n", SIZES)
def test_int8_quantize_contract_against_jax(n):
    x = _x(n)
    vals, scale = ck.int8_quantize(torch.from_numpy(x), seed=3)
    jvals, jscale = pk.int8_quantize(jnp.asarray(x), seed=3)
    assert scale.dtype == torch.float32
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    _check_contract(x, vals.numpy(), np.full(n, float(scale), np.float32))
    _check_contract(x, np.asarray(jvals), np.full(n, float(scale),
                                                  np.float32))
    back = ck.int8_dequantize(vals, scale, torch.float32)
    assert np.abs(back.numpy() - x).max() <= float(scale) * 1.0001


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", SIZES)
def test_int8_block_quantize_contract_against_jax(n, block):
    x = _x(n)
    vals, scales = ck.int8_block_quantize(torch.from_numpy(x), block, seed=9)
    jvals, jscales = pk.int8_block_quantize(jnp.asarray(x), block_size=block,
                                            seed=9)
    nb = -(-n // block)
    assert scales.shape == (nb,) and vals.shape == (n,)
    assert np.array_equal(scales.numpy(), np.asarray(jscales))
    per = np.repeat(scales.numpy(), block)[:n]
    _check_contract(x, vals.numpy(), per)
    _check_contract(x, np.asarray(jvals), per)
    # the tail block's scale is its own elements' absmax: the zero
    # padding never sets it
    tail = x[(nb - 1) * block:]
    assert scales[-1].item() == np.float32(
        max(np.abs(tail).max(), np.float32(1e-30))) * INV_127
    back = ck.int8_block_dequantize(vals, scales, block)
    assert np.all(np.abs(back.numpy() - x) <= per * 1.0001)


def test_block_rows_match_traced_stochastic_round_blocks():
    """The row form is the fused wire's per-peer chunk quantizer: scales
    bitwise against ``traced._stochastic_round_blocks``, blocks never
    crossing a row, padding values never written."""
    from horovod_tpu.ops import traced

    x = _x(4 * 1301).reshape(4, 1301)
    vals, scales = ck.int8_block_quantize(torch.from_numpy(x), 512, seed=2,
                                          stream=5, rows=True)
    jq, js = traced._stochastic_round_blocks(jnp.asarray(x), 512,
                                             jax.random.PRNGKey(2))
    assert vals.shape == (4, 1301) and scales.shape == (4, 3)
    assert np.array_equal(scales.numpy(), np.asarray(js))
    per = np.repeat(scales.numpy(), 512, axis=1)[:, :1301]
    _check_contract(x, vals.numpy(), per)
    _check_contract(x, np.asarray(jq).reshape(4, -1)[:, :1301], per)


@pytest.mark.parametrize("which", ["tensor", "block"])
def test_rounding_is_unbiased_over_seeds(which):
    """The mean of 64 seeds' dequantized values sits within 4σ of x,
    σ² = Σ scale² · frac · (1 − frac) / 64 over the elements; the JAX
    quantizer, on the same input, likewise."""
    x = _x(4096, seed=4)
    tx = torch.from_numpy(x)
    seeds = range(64)
    if which == "tensor":
        outs = [ck.int8_dequantize(*ck.int8_quantize(tx, seed=s))
                for s in seeds]
        jouts = [pk.int8_dequantize(*pk.int8_quantize(jnp.asarray(x),
                                                      seed=s))
                 for s in seeds]
        _, scale = ck.int8_quantize(tx)
        per = np.full(4096, float(scale))
    else:
        outs = [ck.int8_block_dequantize(
            *ck.int8_block_quantize(tx, 512, seed=s), 512) for s in seeds]
        jouts = [pk.int8_block_dequantize(
            *pk.int8_block_quantize(jnp.asarray(x), 512, seed=s), 512)
            for s in seeds]
        _, scales = ck.int8_block_quantize(tx, 512)
        per = np.repeat(scales.numpy(), 512)
    frac = x / per - np.floor(x / per)
    sigma = np.sqrt((per ** 2 * frac * (1 - frac)).sum() / 64)
    for got in (np.mean([o.numpy() for o in outs], 0),
                np.mean([np.asarray(o) for o in jouts], 0)):
        assert abs((got - x).sum()) <= 4 * sigma
        # and per element, never more than one quantum off
        assert np.all(np.abs(got - x) <= per)


def test_zero_pad_blocks_quantize_to_exact_zero():
    """As tests/test_fusion_quantized.py's pad contract: a block of
    zeros gets the floor scale and exact-zero values."""
    x = np.zeros(1024, np.float32)
    x[:100] = np.linspace(-3, 3, 100)
    vals, scales = ck.int8_block_quantize(torch.from_numpy(x), 512)
    assert np.all(vals.numpy()[512:] == 0)
    assert scales[1].item() == np.float32(1e-30) * INV_127
    back = ck.int8_block_dequantize(vals, scales, 512).numpy()
    assert np.all(back[512:] == 0.0)
    assert np.abs(back[:100] - x[:100]).max() <= 6 / 127.0 * 1.01


# ---------------------------------------------------------------- Philox

KAT = [
    # Random123's kat_vectors, philox4x32_10: counter, key, output
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, want", KAT)
def test_philox_known_answers(counter, key, want):
    c = [torch.tensor([v], dtype=torch.int64) for v in counter]
    got = ck.philox4x32_10(*c, *key)
    assert tuple(int(g) for g in got) == want


def test_random_words_follow_the_counter_layout():
    """Element i takes word i % 4 of Philox at counter i // 4: a prefix
    of a longer draw is the shorter draw."""
    long = ck.random_words(103, seed=7, stream=2, device="cpu")
    assert torch.equal(long[:41], ck.random_words(41, 7, 2, "cpu"))
    out = ck.philox4x32_10(*(torch.tensor([v]) for v in (5, 0, 0, 0)), 7, 2)
    assert [int(w) for w in out] == long[20:24].tolist()
    assert not torch.equal(long, ck.random_words(103, 7, 3, "cpu"))


# ---------------------------------------------------------------- adasum


def _rng_vec(seed, n=8):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


ADASUM_CASES = {
    "identical": (_rng_vec(0, 16), _rng_vec(0, 16)),
    "orthogonal": (np.array([1.0, 0, 0, 0], np.float32),
                   np.array([0, 2.0, 0, 0], np.float32)),
    "parallel": (np.array([2.0, 4.0], np.float32),
                 np.array([4.0, 8.0], np.float32)),
    "zero-a": (np.zeros(4, np.float32),
               np.array([1.0, 2, 3, 4], np.float32)),
    "zero-b": (np.array([1.0, 2, 3, 4], np.float32),
               np.zeros(4, np.float32)),
    "random": (_rng_vec(1), _rng_vec(2)),
    "scaled": (3.0 * _rng_vec(1), 3.0 * _rng_vec(2)),
    "long": (_rng_vec(3, 100_003), _rng_vec(4, 100_003)),
}


@pytest.mark.parametrize("case", sorted(ADASUM_CASES))
def test_adasum_pair_matches_jax(case):
    a, b = ADASUM_CASES[case]
    got = ck.adasum_pair(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(pk.adasum_pair(jnp.asarray(a), jnp.asarray(b)))
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= 1e-6 * scale
    # the kernel's two passes, separately, give the same
    dots = ck.adasum_dots(torch.from_numpy(a), torch.from_numpy(b))
    again = ck.adasum_apply(torch.from_numpy(a), torch.from_numpy(b), dots)
    assert np.array_equal(again.numpy(), got)


def test_adasum_pair_keeps_bf16():
    a = torch.ones(8, dtype=torch.bfloat16)
    out = ck.adasum_pair(a, a.clone())
    want = pk.adasum_pair(jnp.ones(8, jnp.bfloat16), jnp.ones(8,
                                                               jnp.bfloat16))
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert np.array_equal(out.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
