"""B5, B6 and B7 as ``torch.library`` custom operators
(``hvd_torch::flash_fwd``, ``flash_bwd_delta``, ``flash_bwd_dq``,
``flash_bwd_dkv``, ``paged_attention``), and the decode step a CUDA
graph can capture.

On the CPU, where each operator's implementation is its plain version:
``torch.library.opcheck`` of every operator (schema, fake, autograd
registration, AOT dispatch); ``torch.compile(backend="aot_eager",
fullgraph=True)`` of a tiny transformer's training step (through the
flash operators and their autograd formula) and of its cached decode
forward (through the paged operator, with the write rows built on the
device) bitwise the eager result; the operators against the JAX
package's ``flash_attention`` and ``paged_attention`` (Pallas in
interpret mode) within 1e-5 in fp32; and the device-built cache step
(``CacheStep.on_device``, what the engine's graph captures) bitwise the
host-built one, in the model and in the engine."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.ops.paged_attention import paged_attention as jax_paged
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.serving import InferenceEngine

OPS = torch.ops.hvd_torch
ATOL = 1e-5


def _flash_inputs(b=2, t=12, h=4, kvh=2, d=8, seed=0, grad=False):
    rng = np.random.default_rng(seed)
    shapes = ((b, t, h, d), (b, t, kvh, d), (b, t, kvh, d), (b, t, h, d))
    q, k, v, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in shapes)
    if grad:
        for x in (q, k, v):
            x.requires_grad_(True)
    return q, k, v, w


FLASH_KW = {
    "causal": dict(lengths=None, causal=True, window=None),
    "lengths-window": dict(lengths=[12, 7], causal=True, window=5),
    "bidirectional": dict(lengths=None, causal=False, window=None),
}


@pytest.mark.parametrize("name", sorted(FLASH_KW))
def test_opcheck_flash(name):
    kw = FLASH_KW[name]
    q, k, v, _ = _flash_inputs(grad=True)
    lens = (None if kw["lengths"] is None
            else torch.tensor(kw["lengths"], dtype=torch.int32))
    fwd = (q, k, v, lens, kw["causal"], kw["window"])
    torch.library.opcheck(OPS.flash_fwd.default, fwd)
    with torch.no_grad():
        o, lse = OPS.flash_fwd(*fwd)
    do = torch.randn_like(o)
    torch.library.opcheck(OPS.flash_bwd_delta.default, (o, do))
    delta = OPS.flash_bwd_delta(o, do)
    bwd = (q.detach(), k.detach(), v.detach(), o, lse, do, delta, lens,
           kw["causal"], kw["window"])
    torch.library.opcheck(OPS.flash_bwd_dq.default, bwd)
    torch.library.opcheck(OPS.flash_bwd_dkv.default, bwd)


def _paged_inputs(b=3, t=1, h=4, kvh=2, d=8, pt=4, n_logical=5, seed=0):
    """Pools, a scrambled table (the sentinel past each slot's live
    pages) and queries, from numpy."""
    rng = np.random.default_rng(seed)
    num_pages = b * n_logical + 2
    k = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
    v = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
    lengths = np.asarray([0, 7, 16][:b], np.int32)
    table = np.full((b, n_logical), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, n in enumerate(lengths):
        live = min(-(-(int(n) + t) // pt), n_logical)
        table[i, :live] = perm[used:used + live]
        used += live
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, table, lengths)]


@pytest.mark.parametrize("t", [1, 5])
def test_opcheck_paged(t):
    q, k, v, table, lengths = _paged_inputs(t=t)
    torch.library.opcheck(OPS.paged_attention.default,
                          (q, k, v, table, lengths, True))


# --------------------------------------------------- against the JAX kernels


@pytest.mark.parametrize("name", sorted(FLASH_KW))
def test_flash_ops_match_jax(name):
    """The forward operator's o, and the gradients its autograd formula
    gives (the three backward operators), against the JAX function and
    ``jax.vjp`` of it, Pallas in interpret mode."""
    kw = FLASH_KW[name]
    q, k, v, w = _flash_inputs(grad=True)
    lens = (None if kw["lengths"] is None
            else np.asarray(kw["lengths"], np.int32))

    def jf(q, k, v):
        return jfa.flash_attention(
            q, k, v, causal=kw["causal"], window=kw["window"],
            lengths=None if lens is None else jnp.asarray(lens))

    jo, vjp = jax.vjp(jf, *(jnp.asarray(x.detach().numpy())
                            for x in (q, k, v)))
    want = [np.asarray(x) for x in (jo, *vjp(jnp.asarray(w.numpy())))]
    o = fa.flash_attention(q, k, v, causal=kw["causal"], window=kw["window"],
                           lengths=None if lens is None
                           else torch.from_numpy(lens))
    (o * w).sum().backward()
    for got, ref in zip((o, q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("t", [1, 5])
def test_paged_op_matches_jax(t):
    q, k, v, table, lengths = _paged_inputs(t=t)
    want = np.asarray(jax_paged(*(jnp.asarray(x.numpy())
                                  for x in (q, k, v, table, lengths))))
    got = OPS.paged_attention(q, k, v, table, lengths, True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


# ------------------------------------------------------ compiled, bitwise


def _tiny(**kw):
    cfg = tt.TransformerConfig(
        vocab_size=61, num_layers=2, d_model=32, num_heads=4, d_ff=64,
        max_len=64, dtype=torch.float32, **kw)
    return tt.Transformer(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))


def _train_loss(model, tokens, labels):
    logits = model(tokens)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def test_compiled_training_step_bitwise_eager():
    """A training step through the flash operators (their autograd
    formula inside, under remat), compiled with ``fullgraph=True`` (no
    graph break), gives the eager loss and gradients bit for bit."""
    torch._dynamo.reset()
    model = _tiny(flash_attention=True, remat=True)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 61, (2, 16), generator=gen)
    labels = torch.randint(0, 61, (2, 16), generator=gen)
    twin = copy.deepcopy(model)
    before = fa.flash_fwd.launches
    loss = _train_loss(model, tokens, labels)
    loss.backward()
    compiled = torch.compile(_train_loss, backend="aot_eager", fullgraph=True)
    closs = compiled(twin, tokens, labels)
    closs.backward()
    assert torch.equal(loss, closs)
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad), name
    assert fa.flash_fwd.launches == before  # CPU tensors launch nothing


def _decode(model, cache, tokens, lengths, tables, spare_row0):
    step = tt.CacheStep.on_device(cache, lengths, tables, 1, spare_row0)
    return model(tokens, cache=cache, step=step, paged_attn=True)


def _pool(model, num_pages, spare, pt, seed=2):
    cache = tt.init_cache(model.cfg, num_pages + spare, pt)
    gen = torch.Generator().manual_seed(seed)
    for layer in cache:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return cache


def _decode_state(slots=3, n_logical=4, pt=4, num_pages=10):
    lengths = torch.tensor([5, 0, 15], dtype=torch.int32)[:slots]
    tables = torch.full((slots, n_logical), num_pages, dtype=torch.int32)
    tables[0, :2] = torch.tensor([7, 2])
    tables[2, :4] = torch.tensor([0, 9, 4, 5])
    tokens = torch.tensor([[3], [8], [11]])[:slots]
    return tokens, lengths, tables


def test_compiled_cached_decode_bitwise_eager():
    """The cached decode forward through the paged operator, its write
    rows built on the device, compiled with ``fullgraph=True``: the
    eager logits and cache bit for bit."""
    torch._dynamo.reset()
    model = _tiny().eval()
    pt, num_pages = 4, 10
    tokens, lengths, tables = _decode_state(pt=pt, num_pages=num_pages)
    cache = _pool(model, num_pages, 1, pt)
    twin = copy.deepcopy(cache)
    with torch.no_grad():
        want = _decode(model, cache, tokens, lengths, tables,
                       num_pages * pt)
        got = torch.compile(_decode, backend="aot_eager", fullgraph=True)(
            model, twin, tokens, lengths, tables, num_pages * pt)
    assert torch.equal(got, want)
    for a, b in zip(cache, twin):
        for name in a:
            assert torch.equal(a[name], b[name])


# --------------------------------------------------- the device-built step


@pytest.mark.parametrize("rope", [False, True])
def test_device_step_equals_host_step(rope):
    """The device-built step writes every kept row where the host-built
    one does, sends the dropped rows (a slot without pages, a sentinel
    page) to spare rows of their own, and gives bitwise the same logits
    and live pages. An inactive slot's logits are junk on both paths (it
    attends a sentinel page, which the host-built path clamps to the
    last live page), so the active slots are compared."""
    model = _tiny(rope=rope, num_kv_heads=2 if rope else None).eval()
    pt, num_pages, slots = 4, 10, 3
    tokens, lengths, tables = _decode_state(pt=pt, num_pages=num_pages)
    full = _pool(model, num_pages, 1, pt)
    host_full = copy.deepcopy(full)
    live = [{n: leaf[:num_pages] for n, leaf in layer.items()}
            for layer in host_full]
    with torch.no_grad():
        want = model(tokens, cache=live, cache_index=lengths.numpy(),
                     pages=tables.numpy(), paged_attn=True)
        step = tt.CacheStep.on_device(full, lengths, tables, 1,
                                      num_pages * pt)
        got = model(tokens, cache=full, step=step, paged_attn=True)
    active = [0, 2]
    assert torch.equal(got[active], want[active])
    rows = step.dst.tolist()
    assert rows[1] == num_pages * pt + 1  # slot 1 has no page: a spare row
    assert len(set(rows)) == slots
    for a, b in zip(full, host_full):
        for name in a:
            assert torch.equal(a[name][:num_pages], b[name][:num_pages])
    with pytest.raises(ValueError, match="spare"):
        tt.CacheStep.on_device(full, lengths, tables, 2, num_pages * pt)


def test_engine_graph_body_equals_eager_step():
    """The engine's decode step off the card is the body a card
    captures (static inputs, device-built step, the whole pool): its
    logits against an eager forward of the same step with the host-built
    rows on a copy of the live pages, on the active slots, and the live
    pages it leaves bit for bit."""
    model = _tiny()
    eng = InferenceEngine(model, None, slots=3, max_len=32, device="cpu",
                          page_tokens=4, paged_attn="on")
    mgr = eng.manager
    assert [mgr.alloc(i) for i in range(3)] == [0, 1, 2]
    mgr.free(1)  # slot 1 inactive: no pages, length 0
    for slot, prompt in ((0, [1, 2, 3, 4, 5]), (2, list(range(9)))):
        eng.prefill(slot, prompt)
    assert eng.prepare_decode() == []
    toks = np.asarray([7, 0, 9], np.int32)
    live = copy.deepcopy(mgr.cache)
    with torch.no_grad():
        want = eng.model(torch.as_tensor(toks[:, None]), cache=live,
                         cache_index=mgr.lengths_array(),
                         pages=mgr.tables_array(), paged_attn=True)[:, 0, :]
        got = eng._decode_logits(toks)
    assert torch.equal(got[[0, 2]], want[[0, 2]])
    for a, b in zip(mgr.cache, live):
        for name in a:
            assert torch.equal(a[name], b[name])
    assert eng.stats()["decode_compiles"] == 0
    assert eng.graph_launches()["captures"] == 0
