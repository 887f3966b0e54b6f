"""The decode kernel's split over keys, on the CPU.

The CUDA kernel (``paged_decode_kernel`` in
horovod_tpu_torch/ops/csrc/paged_attention.cu) cannot run here, so its
arithmetic is emulated in torch and held against
:func:`paged_attention_plain` (itself held against the JAX package's
Pallas kernel in tests/test_torch_paged_attention.py): each block takes
one split of ``split_pages`` pages of a slot's table; inside it, key
``j`` of the split falls to partial state ``j % ROUND`` (the key-row
groups of the block's four warps); each partial keeps m, l and an
unnormalised accumulator over its keys, a masked key adding nothing;
the block merges its partials, a split past the slot's live keys
writes nothing, and the slot's live splits are merged with weights
exp(mᵢ − M) and the denominator floored at 1e-30. fp32 on both sides,
within 1e-5 (the order of fp32 sums differs). The cases put slot
lengths at every split boundary (0, one below a split, exactly one,
one above, the full table), the sentinel slot, GQA groups and
multi-row decode whose causal rows straddle a boundary, and a page
size that divides no split.

Also the wrapper's host side, with the library replaced by a recorder:
the split plan comes from the table's width alone at the decode,
gqa-decode and serving shapes, no call reads ``lengths`` (or any tensor)
on the host, and a geometry is checked once."""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import paged_attention as pa

NEG = -1e30


def _case(b, t, h, kvh, d, pt, n_logical, lengths, sentinel_rows=(),
          seed=0):
    rng = np.random.default_rng(seed)
    num_pages = b * n_logical + 3
    k = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
    v = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
    table = np.full((b, n_logical), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    used = 0
    for i, n in enumerate(lengths):
        if i in sentinel_rows:
            continue
        live = min(-(-(int(n) + t) // pt), n_logical)
        table[i, :live] = perm[used:used + live]
        used += live
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return [torch.from_numpy(x) for x in
            (q, k, v, table, np.asarray(lengths, np.int32))]


def _group_lanes(d, esize=4):
    """The kernel's G for a row of d elements of esize bytes."""
    chunks = d * esize // 16
    return min(32, 1 << max(0, (chunks - 1).bit_length()))


def _merge(states):
    """Merge (m, l, acc) states: weights exp(mᵢ − M)."""
    m = torch.stack([s[0] for s in states])
    big = m.max(dim=0).values
    w = torch.exp(m - big)
    den = sum(s[1] * wi for s, wi in zip(states, w))
    num = sum(s[2] * wi[:, None] for s, wi in zip(states, w))
    return big, den, num


def emulate_split_decode(q, k_pool, v_pool, page_table, lengths,
                         causal=True):
    """The kernel's split-and-merge arithmetic, row by row in fp32."""
    b, t, h, d = q.shape
    num_pages, pt, kvh, _ = k_pool.shape
    n_logical = page_table.shape[1]
    split_pages, n_splits = pa.split_plan(n_logical, pt)
    split_keys = split_pages * pt
    r = h // kvh
    rows = t * r
    rnd = 128 // _group_lanes(d)  # the block's partial states: 4 warps
    out = torch.empty(b, t, h, d)
    for slot in range(b):
        start = int(lengths[slot])
        n_keys = min(start + t, n_logical * pt)
        for kv in range(kvh):
            qs = torch.stack([q[slot, g // r, kv * r + g % r]
                              for g in range(rows)])  # [rows, d]
            splits = []
            for sp in range(n_splits):
                key0 = sp * split_keys
                if key0 >= n_keys:
                    continue  # past the live keys: no state
                key_end = min(key0 + split_keys, n_keys)
                partials = []
                for pid in range(rnd):
                    keys = list(range(key0 + pid, key_end, rnd))
                    m = torch.full((rows,), NEG)
                    l = torch.zeros(rows)
                    acc = torch.zeros(rows, d)
                    for key in keys:
                        lp = key // pt
                        page = min(max(int(page_table[slot, lp]), 0),
                                   num_pages - 1)
                        kr = k_pool[page, key - lp * pt, kv]
                        vr = v_pool[page, key - lp * pt, kv]
                        s = (qs @ kr) / np.float32(np.sqrt(d))
                        ok = torch.tensor([
                            not causal or key <= start + g // r
                            for g in range(rows)])
                        s = torch.where(ok, s, torch.full_like(s, NEG))
                        big = torch.maximum(m, s)
                        alpha = torch.exp(m - big)
                        p = torch.where(ok, torch.exp(s - big),
                                        torch.zeros_like(s))
                        l = l * alpha + p
                        acc = acc * alpha[:, None] + p[:, None] * vr
                        m = big
                    partials.append((m, l, acc))
                splits.append(_merge(partials))
            _, den, num = _merge(splits)
            o = num / den.clamp_min(1e-30)[:, None]
            for g in range(rows):
                out[slot, g // r, kv * r + g % r] = o[g]
    return out


# split width 64 keys (4 pages of 16): live keys at 1, 63, 64, 65, 66,
# 128 and the whole 64-page table, and a sentinel slot
EDGE = [0, 62, 63, 64, 65, 127, 64 * 16 - 1]
CASES = {
    "mha-edges": dict(b=8, t=1, h=2, kvh=2, d=8, pt=16, n_logical=64,
                      lengths=EDGE + [40], sentinel_rows=(7,)),
    "gqa4-edges": dict(b=7, t=1, h=8, kvh=2, d=16, pt=16, n_logical=64,
                       lengths=EDGE),
    # two and four query rows whose causal bounds straddle a boundary
    "t2-r2": dict(b=3, t=2, h=4, kvh=2, d=8, pt=16, n_logical=24,
                  lengths=[62, 63, 255]),
    "t4-r1": dict(b=3, t=4, h=2, kvh=2, d=8, pt=16, n_logical=24,
                  lengths=[61, 63, 253]),
    # 5-token pages: 12 pages, 60 keys a split
    "pt5": dict(b=4, t=1, h=2, kvh=1, d=24, pt=5, n_logical=60,
                lengths=[0, 59, 60, 299]),
    # pages wider than a split: one page a split
    "pt256": dict(b=2, t=1, h=2, kvh=2, d=8, pt=256, n_logical=3,
                  lengths=[255, 700]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_plain(name):
    args = _case(**CASES[name])
    want = pa.paged_attention_plain(*args)
    got = emulate_split_decode(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_split_merge_not_causal():
    args = _case(**CASES["t2-r2"])
    want = pa.paged_attention_plain(*args, causal=False)
    got = emulate_split_decode(*args, causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n_logical, pt, want", [
    # chip_smoke.py's decode and gqa-decode shapes, and GPT-2 medium
    # serving (max_len 1024 in 16-token pages)
    (64, 16, (4, 16)),
    (8, 16, (4, 2)),     # the tiny serving config: max_len 128
    (60, 5, (12, 5)),
    (3, 256, (1, 3)),
    (1, 1, (64, 1)),
])
def test_split_plan_from_table_width(n_logical, pt, want):
    assert pa.split_plan(n_logical, pt) == want


class _Recorder:
    """Stands in for the built library: records each decode launch's
    integer parameters."""

    def __init__(self):
        self.decode_params = []

    def hvd_paged_decode(self, *args):
        self.decode_params.append(list(args[8]))
        return 0

    def hvd_paged_attention(self, *args):
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    loads = []
    monkeypatch.setattr(pa, "_on_cuda", lambda t: True)
    monkeypatch.setattr(pa._build, "load",
                        lambda name, declare: loads.append(name) or rec)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(pa, "_plans", {})
    monkeypatch.setattr(pa, "_ticket_words", {})
    rec.loads = loads
    return rec


@pytest.mark.parametrize("shape", [
    # chip_smoke.py's decode and the serving burst's decode step: 8
    # slots of GPT-2 medium, 16 heads of 64, a 64-page table
    dict(b=8, t=1, h=16, kvh=16, d=64, n_logical=64, splits=16),
    # gqa-decode: 32 query heads on 8 KV heads of 128
    dict(b=8, t=1, h=32, kvh=8, d=128, n_logical=64, splits=16),
    # a short table: two splits, the second of one page
    dict(b=3, t=1, h=2, kvh=2, d=40, n_logical=5, splits=2),
])
def test_wrapper_plans_from_table_width_without_host_reads(recorder,
                                                           monkeypatch,
                                                           shape):
    b, t, h, kvh, d = (shape[k] for k in ("b", "t", "h", "kvh", "d"))
    n_logical = shape["n_logical"]
    q = torch.zeros(b, t, h, d)
    pool = torch.zeros(b * n_logical, 16, kvh, d)
    table = torch.zeros(b, n_logical, dtype=torch.int32)
    lengths = torch.arange(b, dtype=torch.int32)

    def no_host_read(*a, **k):
        raise AssertionError("the wrapper read a tensor on the host")

    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, no_host_read)
    before = pa.paged_attention.launches
    for _ in range(3):
        out = pa.paged_attention(q, pool, pool, table, lengths)
    monkeypatch.undo()
    assert out.shape == q.shape
    assert pa.paged_attention.launches == before + 3
    assert len(recorder.decode_params) == 3
    params = recorder.decode_params[0]
    assert params[:8] == [b, t, h, kvh, d, b * n_logical, 16, n_logical]
    assert params[8:12] == [4, shape["splits"], 1,
                            pa.DTYPE_CODES[torch.float32]]
    assert recorder.loads == [pa.LIBRARY]  # one geometry, checked once


def test_wrapper_converts_table_and_lengths_once_needed(recorder):
    q = torch.zeros(2, 1, 2, 8)
    pool = torch.zeros(8, 16, 2, 8)
    table = torch.zeros(2, 4, dtype=torch.int64)
    lengths = torch.zeros(2, dtype=torch.int64)
    pa.paged_attention(q, pool, pool, table, lengths)
    assert recorder.decode_params[0][8:10] == list(pa.split_plan(4, 16))
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, pool.transpose(0, 1), pool.transpose(0, 1),
                           table, lengths)
