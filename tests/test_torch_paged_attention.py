"""Paged attention in the PyTorch port (horovod_tpu_torch/ops/):
the plain PyTorch version against the JAX package's Pallas kernel
(interpret mode on the CPU), the Hopper rungs of the fallback ladder,
and the no-quiet-fallback dispatch. The CUDA kernel itself runs only on
a card: tests/test_torch_kernels_cuda.py and phase 2 of chip_smoke.py
hold it against the plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.ops.paged_attention import paged_attention as jax_paged
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import paged_attention as pa

# fp32 on both sides; the two differ only in the order of fp32 sums
ATOL = RTOL = 1e-5


def _case(b, t, h, kvh, d, pt, n_logical, lengths, sentinel_rows=(),
          seed=0):
    """Pools, a scrambled page table (sentinel past each slot's live
    pages, whole rows for ``sentinel_rows``) and queries, from numpy."""
    rng = np.random.default_rng(seed)
    num_pages = b * n_logical + 3
    k_pool = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
    v_pool = rng.normal(size=(num_pages, pt, kvh, d)).astype(np.float32)
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
    return q, k_pool, v_pool, table, np.asarray(lengths, np.int32)


CASES = {
    # decode: staggered lengths, a zero-length slot, a full row
    "mha-decode": dict(b=4, t=1, h=2, kvh=2, d=8, pt=8, n_logical=4,
                       lengths=[0, 5, 17, 31]),
    "gqa-decode": dict(b=4, t=1, h=4, kvh=2, d=8, pt=8, n_logical=4,
                       lengths=[3, 0, 9, 24]),
    # prefill chunks at starts off a page boundary
    "mha-chunk": dict(b=3, t=5, h=2, kvh=2, d=16, pt=4, n_logical=6,
                      lengths=[0, 3, 13]),
    "gqa-chunk": dict(b=3, t=5, h=4, kvh=2, d=8, pt=8, n_logical=4,
                      lengths=[7, 0, 19]),
    # an inactive slot whose whole table row is the sentinel
    "sentinel-row": dict(b=3, t=1, h=2, kvh=2, d=8, pt=8, n_logical=4,
                         lengths=[10, 0, 4], sentinel_rows=(1,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name):
    q, k, v, table, lengths = _case(**CASES[name])
    want = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(lengths),
    ))
    got = pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lengths),
    )
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_cpu_dispatch_counts_no_launch():
    q, k, v, table, lengths = _case(**CASES["mha-decode"])
    before = pa.paged_attention.launches
    pa.paged_attention(*map(torch.from_numpy, (q, k, v, table, lengths)))
    assert pa.paged_attention.launches == before


def test_unsupported_reason_hopper_rungs(monkeypatch):
    # GPT-2 medium's head_dim 64 and any page size pass (the TPU ladder
    # refused head_dim 64 on its 128-lane floor)
    assert pa.unsupported_reason(64, 16, dtype=torch.bfloat16) is None
    assert pa.unsupported_reason(128, 1, dtype=torch.float16) is None
    assert pa.unsupported_reason(256, 5, dtype=torch.float32) is None
    assert "multiple of 8" in pa.unsupported_reason(60, 16)
    assert "outside" in pa.unsupported_reason(264, 16)
    assert "outside" in pa.unsupported_reason(4, 16)
    assert "page_tokens" in pa.unsupported_reason(64, 0)
    assert "dtype" in pa.unsupported_reason(64, 16, dtype=torch.int8)
    # the CPU needs no build: tensors there take the plain version
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    assert pa.unsupported_reason(64, 16, device="cpu") is None
    # on a CUDA device: the missing-build rung, then the sm_90a rung
    monkeypatch.setattr(_build, "available", lambda name: False)
    assert "not built" in pa.unsupported_reason(64, 16, device="cuda")
    monkeypatch.setattr(_build, "available", lambda name: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    assert "sm_80" in pa.unsupported_reason(64, 16, device="cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    assert pa.unsupported_reason(64, 16, device="cuda") is None


def test_cuda_call_without_kernel_raises(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no library and
    no nvcc the call fails loudly instead of taking the plain version."""
    q, k, v, table, lengths = _case(**CASES["mha-decode"])
    monkeypatch.setattr(pa, "_on_cuda", lambda t: True)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    before = pa.paged_attention.launches
    with pytest.raises(RuntimeError, match="no nvcc"):
        pa.paged_attention(*map(torch.from_numpy, (q, k, v, table, lengths)))
    assert pa.paged_attention.launches == before


def test_shape_errors():
    q, k, v, table, lengths = map(
        torch.from_numpy, _case(**CASES["gqa-decode"])
    )
    with pytest.raises(ValueError, match="head_dim mismatch"):
        pa.paged_attention(q[..., :4], k, v, table, lengths)
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        pa.paged_attention(q[:, :, :3], k, v, table, lengths)
    with pytest.raises(ValueError, match="page_table"):
        pa.paged_attention(q, k, v, table[:2], lengths)
