"""The port's Transformer (horovod_tpu_torch/models/) against the JAX
model it was ported from: the same Flax parameters carried across by
``params_from_flax``, the same token inputs from a numpy seed. Covers
the uncached forward, and the cache-threaded forward on the paged pool
(prefill chunk, then per-token decode) and on the slab, for
learned-position MHA and RoPE GQA. fp32 on both sides; tolerances are
fp32 reassociation (different matmul and softmax sum orders), and the
greedy argmax must agree exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax

ATOL = 1e-5
VARIANTS = {
    "learned-pos-mha": dict(),
    "rope-gqa": dict(rope=True, num_kv_heads=2),
}


def _cfgs(**kw):
    base = dict(vocab_size=61, num_layers=2, d_model=32, num_heads=4,
                d_ff=64, max_len=64)
    base.update(kw)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **base)
    return jcfg, tcfg


def _models(variant):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32), train=False
    )
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tt.Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params, tcfg))
    return jmodel, params, tmodel


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_uncached_logits_match(variant):
    jmodel, params, tmodel = _models(variant)
    tokens = np.random.default_rng(1).integers(0, 61, size=(3, 23))
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens), train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("paged_attn", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_prefill_and_decode_match(variant, paged_attn):
    """A 13-token prefill chunk at an unaligned start over two slots
    with scrambled tables, then four per-token decode steps, each against
    the JAX model on the same pool layout."""
    jmodel, params, tmodel = _models(variant)
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    num_pages, pt = 12, 8
    table = np.array([[3, 7, 1, 12, 12, 12, 12, 12],
                      [5, 0, 11, 9, 12, 12, 12, 12]], np.int32)
    jcache = jt.init_cache(jcfg, num_pages, pt)
    tcache = tt.init_cache(tcfg, num_pages, pt)
    rng = np.random.default_rng(2)
    seqs = rng.integers(0, 61, size=(2, 40))
    apply = jax.jit(jmodel.apply, static_argnames=("train", "paged_attn"))
    steps = [(0, 3), (3, 13)] + [(16 + i, 1) for i in range(4)]
    for start, t in steps:
        toks = seqs[:, start:start + t]
        index = np.full(2, start, np.int32)
        want, jcache = apply(
            params, jnp.asarray(toks), train=False, cache=jcache,
            cache_index=jnp.asarray(index), pages=jnp.asarray(table),
            paged_attn=paged_attn,
        )
        with torch.no_grad():
            got = tmodel(torch.from_numpy(toks), cache=tcache,
                         cache_index=index, pages=table,
                         paged_attn=paged_attn)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        assert (got.numpy().argmax(-1) == want.argmax(-1)).all()
    # the pool holds the same k/v wherever the model wrote
    np.testing.assert_allclose(
        tcache[1]["k"].numpy(), np.asarray(jcache[1]["k"]), atol=ATOL
    )


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_slab_cache_matches_full_forward(variant):
    """The slab layout: prefill then decode through per-slot rows gives
    the logits of the uncached forward over the whole sequence."""
    _, _, tmodel = _models(variant)
    _, tcfg = _cfgs(**VARIANTS[variant])
    cache = tt.init_cache(tcfg, 2, 32)
    seqs = torch.from_numpy(np.random.default_rng(3).integers(0, 61, (2, 12)))
    with torch.no_grad():
        tmodel(seqs[:, :9], cache=cache, cache_index=[0, 0])
        for pos in range(9, 12):
            got = tmodel(seqs[:, pos:pos + 1], cache=cache,
                         cache_index=[pos, pos])
        want = tmodel(seqs)[:, -1:]
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_rope_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 5, 3, 8)).astype(np.float32)
    offset = np.array([0, 7], np.int32)
    want = np.asarray(jt.apply_rope(jnp.asarray(x), 10000.0, offset))
    got = tt.apply_rope(torch.from_numpy(x), 10000.0, torch.from_numpy(offset))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="even head_dim"):
        tt.apply_rope(torch.zeros(1, 2, 1, 3))


def test_unported_paths_raise():
    _, tcfg = _cfgs()
    # the MoE banks are ported (tests/test_torch_moe.py holds them to Flax)
    moe = tt.Transformer(dataclasses.replace(tcfg, moe_experts=2),
                         device="cpu")
    assert isinstance(moe.blocks[0].moe, tt.MoEFFN)
    with pytest.raises(ValueError, match="position"):
        tt.init_cache(tcfg, 1, 128)
    # the sliding window is ported on the cached path too: the slab read
    # gives the uncached forward's logits (tolerance ATOL); only the
    # paged kernel, which has no window, refuses it
    windowed = tt.Transformer(dataclasses.replace(tcfg, sliding_window=4),
                              device="cpu")
    seq = torch.from_numpy(np.random.default_rng(5).integers(0, 61, (1, 9)))
    with torch.no_grad():
        want = windowed(seq)[:, -1:]
        cache = tt.init_cache(tcfg, 1, 16)
        windowed(seq[:, :8], cache=cache, cache_index=[0])
        got = windowed(seq[:, 8:], cache=cache, cache_index=[8])
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
        with pytest.raises(ValueError, match="sliding_window"):
            windowed(seq[:, :2], cache=tt.init_cache(tcfg, 4, 4),
                     cache_index=[0], pages=np.zeros((1, 4), np.int32),
                     paged_attn=True)


def test_default_device_needs_a_card():
    """device=None means the CUDA card: without one the model raises
    instead of building its parameters on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Transformer(tcfg)


def test_gpt2_medium_shapes():
    cfg = tt.TransformerConfig.gpt2_medium()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff) == (
        24, 1024, 16, 4096
    )
    assert cfg.head_dim == 64 and cfg.dtype == torch.bfloat16
    assert cfg.vocab_size == 50257 and cfg.max_len == 1024
