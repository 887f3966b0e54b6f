"""The serving engine's prefill tiers (``horovod_tpu_torch/serving/
engine.py``: bucket and exact entries, promotion after ``promote_after``
sightings in a background thread, the forced exact entry when a bucket
would overrun the slot, the LRU of ``exact_capacity`` entries and the
sightings map bounded at four times that) against the JAX engine's
(``horovod_tpu/serving/engine.py:583-705``), on the paged pool and on
the slab.

One prompt-length sequence goes through both engines, with the same Flax
weights (2 layers, d 64, fp32). After every prefill (background
promotions joined on both sides) the tier counters, the entry counts and
the size of the sightings map are equal, and so are the greedy tokens;
the port's logits at the last real position agree with the JAX model's
full forward within 1e-5. The sequence covers several buckets, lengths
repeated past ``promote_after``, prompts past the chunk ceiling, prefix
cache hits, a bucket that would overrun the slot's room, and more
distinct lengths than the sightings map keeps.

The port's own pool is also held against its eager exact-width prefill
(the engine with the tiers off, each chunk at its exact width): every
page bitwise, since a pad row never reaches one and both paths run
their products at the ceiling's rows (the model's ``product_rows``
argument). The one
exception is a row written by a one-token piece: the exact run's
attention for a single query is a matrix-vector product, whose rounding
on the CPU differs from the same row of a wider product (on the card
such a piece takes the decode kernel), so those rows agree within 1e-6
instead. The JAX engine's own outputs are held to tolerance and tokens only
(ROADMAP, caveats on the reference)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jt
from horovod_tpu.serving.engine import InferenceEngine as JaxEngine
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serving import InferenceEngine

BASE = dict(vocab_size=97, num_layers=2, d_model=64, num_heads=4, d_ff=128,
            max_len=64)
# max_len 60 with a ceiling of 16 leaves a 12-token room after three
# full chunks, where a bucket of 16 would overrun the slot
ENGINE_KW = dict(slots=3, max_len=60, prefill_ceiling=16, page_tokens=4,
                 min_bucket=4, promote_after=2, exact_capacity=1)
COUNTERS = ("prefills", "prefill_compiles", "prefill_bucket_hits",
            "prefill_exact_hits", "prefill_promotions",
            "prefill_bg_promotions", "prefill_pad_tokens",
            "prefill_exact_entries", "prefill_bucket_entries",
            "chunked_prefill_chunks", "prefill_chunks_skipped",
            "prefill_tokens_skipped")


@pytest.fixture(scope="module")
def models():
    jmodel = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **BASE))
    params = jmodel.init(jax.random.PRNGKey(3), jnp.ones((1, 4), jnp.int32),
                         train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = tt.TransformerConfig(dtype=torch.float32, **BASE)
    state = params_from_flax(params, cfg)
    return jmodel, params, cfg, state


def _port(models, paged, tiers=True):
    _, _, cfg, state = models
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(state)
    eng = InferenceEngine(model, None, device="cpu", paged=paged,
                          **ENGINE_KW)
    eng._tiers = tiers
    return eng


def _prompts():
    """Prompts in order: buckets 4/8/16, a length seen past
    promote_after, chunked prompts, a shared two-page prefix, the
    overrun, and enough distinct lengths to cycle the sightings map."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 97, 8)

    def p(n):
        return rng.integers(1, 97, n)

    seq = [p(3), p(5), p(5), p(5), p(33), np.concatenate([shared, p(5)]),
           np.concatenate([shared, p(5)]), p(59), p(17), p(7), p(9), p(10)]
    return seq


def _alloc(eng, owner):
    slot = eng.manager.alloc(owner)
    if slot is None:
        eng.manager.free(eng.manager.active_slots()[0])
        slot = eng.manager.alloc(owner)
    return slot


def _stats(eng):
    s = eng.stats()
    return {k: int(s.get(k, 0)) for k in COUNTERS}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_tiers_match_the_jax_engine(models, paged):
    jmodel, params, _, _ = models
    jeng = JaxEngine(jmodel, params, paged=paged, **ENGINE_KW)
    teng = _port(models, paged)
    assert teng.prefill_ceiling == jeng.prefill_ceiling == 16
    for i, prompt in enumerate(_prompts()):
        js, ts = _alloc(jeng, i), _alloc(teng, i)
        assert js == ts
        want = jeng.prefill(js, prompt)
        got = teng.prefill(ts, prompt)
        assert jeng.drain_promotions(60) and teng.drain_promotions(60)
        assert got == want, (i, prompt.size)
        assert _stats(teng) == _stats(jeng), (i, prompt.size)
        assert len(teng._seen) == len(jeng._seen) <= 4
        full = np.asarray(jmodel.apply(params, jnp.asarray(prompt[None]),
                                       train=False))[0, -1]
        np.testing.assert_allclose(teng._last_logits.numpy(), full,
                                   rtol=1e-5, atol=1e-5)
    s = teng.stats()
    # every path was taken: pads, promotions in the background, the
    # forced exact entry (promotions past the background ones), exact
    # hits, chunking, prefix skips, and the sightings map's bound
    assert s["prefill_pad_tokens"] and s["prefill_exact_hits"]
    assert 0 < s["prefill_bg_promotions"] < s["prefill_promotions"]
    assert s["chunked_prefill_chunks"] and len(teng._seen) == 4
    assert s["prefill_chunks_skipped"] == (2 if paged else 0)
    assert s["prefill_exact_entries"] == ENGINE_KW["exact_capacity"]


def _one_token_row(prompt):
    """The position an exact-width run writes with a one-token piece
    (the final piece after full chunks), or None."""
    n = prompt.size
    return n - 1 if n > 1 and n % ENGINE_KW["prefill_ceiling"] == 1 else None


def test_pool_pages_equal_the_eager_exact_width_run(models):
    """The whole pool after the sequence (freed slots' pages included),
    the tiered engine's against the exact-width run's: bitwise but for
    the rows written by one-token pieces."""
    prompts = _prompts()
    pools, one_rows = [], []
    for tiers in (True, False):
        eng = _port(models, True, tiers)
        for i, prompt in enumerate(prompts):
            slot = _alloc(eng, i)
            eng.prefill(slot, prompt)
            assert eng.drain_promotions(60)
            pos = _one_token_row(prompt)
            if tiers and pos is not None:
                pt = eng.manager.page_tokens
                one_rows.append((eng.manager.table_row(slot)[pos // pt],
                                 pos % pt))
        pools.append(eng.manager.cache)
    assert one_rows  # the sequence has such pieces
    for layer_t, layer_e in zip(*pools):
        for name in ("k", "v"):
            a, b = layer_t[name], layer_e[name]
            mask = torch.ones(a.shape[:2], dtype=torch.bool)
            for page, row in one_rows:
                mask[page, row] = False
            assert torch.equal(a[mask], b[mask]), name
            torch.testing.assert_close(a[~mask], b[~mask], rtol=1e-6,
                                       atol=1e-6)


def test_spare_rows_cover_the_ceiling(models):
    """The paged pool's spare rows hold a ceiling-wide chunk's pads and
    every slot's inactive decode write; a decode worker keeps one row a
    slot."""
    eng = _port(models, True)
    mgr = eng.manager
    spare = (mgr.spare_pages * mgr.page_tokens)
    assert spare >= max(mgr.slots, eng.prefill_ceiling)
    _, _, cfg, state = models
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(state)
    dec = InferenceEngine(model, None, device="cpu", role="decode",
                          **ENGINE_KW)
    assert dec.manager.spare_pages == -(-dec.slots // dec.manager.page_tokens)
    with pytest.raises(RuntimeError, match="decode-role"):
        dec.prefill(0, [1, 2])


def test_product_rows_rounds_as_the_wider_product():
    """``DenseGeneral``'s ``rows`` (the model's ``product_rows``): a
    product of fewer rows gives, bitwise, the rows of the same product
    over ``rows`` rows, whatever the other rows hold (the prefill
    entries' products, whose tokens must not depend on the entry's
    width); a product of at least ``rows`` rows is the plain one."""
    layer = tt.DenseGeneral((64,), (3, 4, 16), torch.float32, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 16, 64, generator=g)
    wide = layer(x)
    for rows in (1, 3, 11):
        assert torch.equal(layer(x[:, :rows], 16), wide[:, :rows]), rows
    assert torch.equal(layer(x, 8), wide)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_a_new_entry_writes_no_live_row(models, paged):
    """A new entry's body run on the static inputs it was made with, as
    its warm-up runs it on the card, while slots hold prompts: every
    live row of the pool or the slab keeps its bits (the paged writes
    go to spare rows, the slab's to its spare slot row)."""
    eng = _port(models, paged)
    rng = np.random.default_rng(12)
    for owner, n in enumerate((30, 9)):
        eng.prefill(_alloc(eng, owner), rng.integers(1, 97, n))
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in eng.manager.cache]
    with torch.no_grad():
        for width in (4, 16, 13):
            eng._prefill_body(eng._make_entry(width, "exact"))
    for old, new in zip(before, eng.manager.cache):
        for name in old:
            assert torch.equal(old[name], new[name]), name
    if not paged:
        assert eng.manager.spare_slot == eng.slots
        assert eng.manager.full_cache[0]["k"].shape[0] == eng.slots + 1
