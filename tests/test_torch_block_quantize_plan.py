"""The block quantizer's (B3's) work partition, on the CPU.

The CUDA kernels (``block_quantize_{warp,lanes,cta}_kernel`` in
horovod_tpu_torch/ops/csrc/cuda_kernels.cu) cannot run here, so their
partition of the work is emulated in numpy and held to three things:

- every element of a ``[rows, cols]`` tensor is written exactly once,
  by the block that owns it, and no block writes or loads past its own
  elements; the warp and staged CTA variants load each element once
  (x is read once), 16 bytes at a time only from an aligned base;
- each written element takes word ``i % 4`` of Philox quad ``i // 4`` of
  its flat index ``i``, whatever the block's start;
- rounding through the partition (each block's scale from the values
  its threads loaded, each element from its slot's quad) equals
  :func:`int8_block_quantize_plain` bit for bit.

The variant comes from :func:`block_quantize_variant` (the block size
alone). In the warp variant lane ``l`` takes the block's 16-byte vectors
``l, l + 32, ...`` from the vector holding its first element, ``K - 1``
slots a lane hold an aligned whole block, and a block that starts inside
a vector touches one vector more, which lane 0 holds and rounds in a
round of its own. Blocks of a row whose start is not a multiple of the
vector share their first and last vector with their neighbours.

Also the wrapper's host side, with the library replaced by a recorder:
the variant by the stated rule, the aligned flag from the base address,
no tensor read on the host, and a raise with no second launch when the
library returns an error."""

import functools

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import cuda_kernels as ck

CTA_THREADS = 256  # kCtaThreads
WARP_SLOTS = (2, 3, 5, 9, 17)  # the warp kernel's instantiated K


def _vec(esize):
    """Elements in a 16-byte vector."""
    return 16 // esize


def warp_slots(block, n_vec):
    """The warp kernel's K: K - 1 slots a lane cover an aligned whole
    block, rounded up to an instantiated K."""
    want = -(-(-(-block // n_vec)) // 32) + 1
    return next(k for k in WARP_SLOTS if k >= want)


@functools.lru_cache(maxsize=None)
def block_plan(variant, head, length, block, esize, aligned):
    """What one block's threads load and write: ``loads`` counts the
    loads of each local element (offset 0 .. length-1 from the block's
    first element), ``vec_loads`` the 16-byte loads, and ``writes`` is
    ``(offset, quad, word)`` arrays, one entry a store, the quad counted
    from the block's first quad (that of its first vector, or of its
    first element in the lanes variant). ``head`` is the block's first
    element's place in that vector (quad for ``lanes``)."""
    loads = np.zeros(length, np.int64)
    offs, quads, words = [], [], []
    vec_loads = 0
    if variant == "lanes":
        g = 1 << max(0, (min(block, 32) - 1).bit_length())
        for lane in range(g):  # absmax: elements s + lane, step g
            loads[lane::g] += 1
        n_quads = -(-(head + length) // 4)
        for lane in range(g):
            for qi in range(lane, n_quads, g):  # rounding: x read again
                for j in range(4):
                    off = 4 * qi + j - head
                    if 0 <= off < length:
                        loads[off] += 1
                        offs.append(off)
                        quads.append(qi)
                        words.append(j)
        return loads, vec_loads, (np.array(offs), np.array(quads),
                                  np.array(words))
    n = _vec(esize)
    span = head + length
    nv = -(-span // n)
    if variant == "warp":
        k = warp_slots(block, n)
        assert nv <= 32 * (k - 1) + 1  # at most one vector past the slots
        width, n_slots = 32, k
    else:
        width, n_slots = CTA_THREADS, -(-nv // CTA_THREADS)
    extra = 0
    for slot in range(n_slots):
        for lane in range(width):
            v = lane + width * slot
            if v >= nv:
                continue
            lo = v * n
            if variant == "warp" and slot == n_slots - 1:
                assert lane == 0 and v == nv - 1  # lane 0's extra round
                extra += 1
            if aligned and lo >= head and lo + n <= span:
                vec_loads += 1
            for j in range(n):
                off = lo + j - head
                if 0 <= off < length:
                    loads[off] += 2 if variant == "cta_reread" else 1
                    offs.append(off)
                    quads.append(v * (n // 4) + j // 4)
                    words.append(j % 4)
    assert extra <= 1
    return loads, vec_loads, (np.array(offs), np.array(quads),
                              np.array(words))


def _period(variant, esize):
    """Blocks' plans repeat with their start modulo this."""
    return 4 if variant == "lanes" else _vec(esize)


def _blocks(rows, cols, block):
    """(first element, length) of every block, as numpy arrays."""
    nb = -(-cols // block)
    jb = np.arange(nb, dtype=np.int64)
    length = np.minimum(block, cols - jb * block)
    start = (np.arange(rows, dtype=np.int64)[:, None] * cols
             + jb[None] * block).reshape(-1)
    return start, np.tile(length, rows)


def _classes(rows, cols, block, period):
    """The distinct (start modulo ``period``, length) of a tensor's
    blocks, from the first ``period`` blocks and the last of each row
    (jb · block modulo ``period`` repeats within ``period`` blocks)."""
    nb = -(-cols // block)
    out = set()
    for row in range(rows):
        for jb in list(range(min(nb - 1, period))) + [nb - 1]:
            length = block if jb < nb - 1 else cols - jb * block
            out.add(((row * cols + jb * block) % period, length))
    return out


COLS = [1, 3, 2501, 4_194_304 + 3]
BLOCKS = [1, 3, 31, 32, 33, 512, 1000, ck.WARP_MAX_BLOCK,
          ck.WARP_MAX_BLOCK + 1, 4096]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_partition_writes_each_element_once_by_its_block(cols, block,
                                                         dtype):
    """Every block writes each of its own elements once and nothing
    else, with the Philox word of the element's flat index; the warp and
    staged CTA variants load each element once, in 16-byte loads only
    from an aligned base. A block's plan depends on its start's place in
    a vector and its length alone, so each distinct pair is emulated, for
    rows of 1 and 4 and bases aligned and one element past."""
    esize = torch.finfo(dtype).bits // 8
    variant = ck.block_quantize_variant(block)
    period = _period(variant, esize)
    for rows in (1, 4):
        classes = _classes(rows, cols, block, period)
        if rows * cols < 100_000:  # the shortcut, against every block
            start, length = _blocks(rows, cols, block)
            assert length.sum() == rows * cols and (length > 0).all()
            assert (start[1:] == start[:-1] + length[:-1]).all()
            assert classes == set(zip((start % period).tolist(),
                                      length.tolist()))
        for offset in (0, 1):  # elements the base sits past 16 bytes
            aligned = offset * esize % 16 == 0
            for head, length in classes:
                loads, vec_loads, (offs, quads, words) = block_plan(
                    variant, head, length, block, esize, aligned)
                assert np.array_equal(np.sort(offs), np.arange(length))
                # each element takes word i % 4 of quad i // 4 of its flat
                # index i, counted from the block's first quad
                assert np.array_equal(4 * quads + words, head + offs)
                once = variant in ("warp", "cta")
                assert (loads == (1 if once else 2)).all()
                if not aligned or variant == "lanes":
                    assert vec_loads == 0
                elif length >= 3 * _vec(esize):
                    assert vec_loads >= length // _vec(esize) - 1


def _emulate(x, block, rows, seed, stream):
    """Values and scales through the partition: each block's scale from
    the values its threads loaded, each value rounded as the kernel
    rounds it, with the word its slot takes from its quad."""
    r, c = (x.shape if rows else (1, x.numel()))
    flat = x.reshape(-1).to(torch.float32)
    esize = x.element_size()
    variant = ck.block_quantize_variant(block)
    period = _period(variant, esize)
    aligned = x.data_ptr() % 16 == 0
    start, length = _blocks(r, c, block)
    absx = flat.abs().numpy()
    absmax = np.empty(len(start), np.float32)
    elems, quads, words, owner = [], [], [], []
    for b, (s, ln) in enumerate(zip(start.tolist(), length.tolist())):
        head = s % period
        loads, _, (offs, qs, ws) = block_plan(variant, head, ln, block,
                                              esize, aligned)
        absmax[b] = absx[s:s + ln][loads > 0].max()
        elems.append(s + offs)
        quads.append((s - head) // 4 + qs)
        words.append(ws)
        owner.append(np.full(len(offs), b))
    elems, quads, words, owner = (torch.from_numpy(np.concatenate(a))
                                  for a in (elems, quads, words, owner))
    assert (torch.bincount(elems, minlength=r * c) == 1).all()
    scales = ck._scale_plain(torch.from_numpy(absmax))
    zero = torch.zeros_like(quads)
    bits = torch.stack(ck.philox4x32_10(quads & 0xFFFFFFFF, quads >> 32,
                                        zero, zero, seed, stream), 1)
    u = (bits[torch.arange(len(words)), words] >> 8).to(torch.float32) * (
        2.0 ** -24)
    q = torch.empty(r * c, dtype=torch.int8)
    q[elems] = ck._round_plain(flat[elems], scales[owner], u)
    return (q.reshape(x.shape),
            scales.reshape(r, -1) if rows else scales)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS[:3])
def test_rounding_through_partition_equals_plain(cols, block, dtype):
    """The emulated kernel equals the plain version bit for bit, values
    and scales, flat and as rows, from an aligned base and from a view
    three elements in."""
    rng = np.random.default_rng(cols * 7 + block)
    for rows in (1, 4):
        base = rng.normal(size=rows * cols + 3).astype(np.float32)
        base[: base.size // 3] *= 1e-3
        full = torch.from_numpy(base).to(dtype)
        for x in (full[: rows * cols], full[3:]):
            as_rows = rows > 1
            x = x.view(rows, cols) if as_rows else x
            q, s = _emulate(x, block, as_rows, seed=11, stream=5)
            qp, sp = ck.int8_block_quantize_plain(x, block, seed=11,
                                                  stream=5, rows=as_rows)
            assert torch.equal(s, sp)
            assert torch.equal(q, qp)


@pytest.mark.parametrize("block, variant", [
    (1, "lanes"), (3, "lanes"), (31, "lanes"), (32, "warp"),
    (512, "warp"), (1000, "warp"), (2048, "warp"), (2049, "cta"),
    (4096, "cta"), (8192, "cta"), (8193, "cta_reread"),
    (1 << 20, "cta_reread"),
])
def test_variant_by_block_size(block, variant):
    assert ck.block_quantize_variant(block) == variant
    assert variant in ck.BLOCK_VARIANTS


def test_warp_slots_hold_every_block():
    """At the register limit the warp variant holds 17 vectors a lane
    (68 registers of fp32 data); every block size up to it fits its
    slots from any start."""
    assert warp_slots(ck.WARP_MAX_BLOCK, 4) == 17
    for esize in (4, 2):
        n_vec = _vec(esize)
        for block in range(ck.WARP_MIN_BLOCK, ck.WARP_MAX_BLOCK + 1):
            k = warp_slots(block, n_vec)
            most = -(-(n_vec - 1 + block) // n_vec)  # vectors touched
            assert most <= 32 * (k - 1) + 1


class _Recorder:
    """Stands in for the built library: records each block-quantize
    launch's arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def hvd_int8_block_quantize(self, *args):
        self.calls.append(args)
        return self.err

    def hvd_wire_error_string(self, code):
        return b"an injected launch failure"


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(ck, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ck._build, "load", lambda name, declare: rec)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return rec


def _no_host_reads(monkeypatch):
    def no_host_read(*a, **k):
        raise AssertionError("the wrapper read a tensor on the host")

    for name in ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
                 "__bool__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, no_host_read)


@pytest.mark.parametrize("block", [1, 31, 32, 512, 1000, 2049, 8193])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_picks_variant_by_rule(recorder, monkeypatch, block,
                                       dtype):
    base = torch.zeros(4 * 2503 + 1, dtype=dtype)
    cases = [(base[: 4 * 2503], False, 1, 4 * 2503, 1),
             (base[1:].view(4, 2503), True, 4, 2503, 0)]
    _no_host_reads(monkeypatch)
    before = ck.int8_block_quantize.launches
    outs = [ck.int8_block_quantize(x, block, seed=7, stream=3, rows=rows)
            for x, rows, *_ in cases]
    monkeypatch.undo()
    assert ck.int8_block_quantize.launches == before + 2
    for (x, rows, r, c, aligned), call, (q, s) in zip(cases, recorder.calls,
                                                       outs):
        assert call[1:7] == (ck.DTYPE_CODES[dtype], r, c, block,
                             ck.BLOCK_VARIANTS.index(
                                 ck.block_quantize_variant(block)),
                             aligned)
        assert call[0] == x.data_ptr() and call[9:11] == (7, 3)
        assert q.shape == x.shape and q.dtype == torch.int8
        assert s.shape == ((r, -(-c // block)) if rows
                           else (-(-c // block),))


def test_wrapper_raises_on_error_without_a_second_launch(recorder):
    recorder.err = 700
    before = ck.int8_block_quantize.launches
    with pytest.raises(RuntimeError, match="injected launch failure"):
        ck.int8_block_quantize(torch.zeros(1000), 512)
    assert len(recorder.calls) == 1
    assert ck.int8_block_quantize.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(recorder):
    with pytest.raises(ValueError, match="block_size"):
        ck.int8_block_quantize(torch.zeros(10), 0)
    with pytest.raises(ValueError, match="takes"):
        ck.int8_block_quantize(torch.zeros(10, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="rows=True"):
        ck.int8_block_quantize(torch.zeros(10), 4, rows=True)
    assert recorder.calls == []
