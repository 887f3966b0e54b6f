"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports no JAX (the card's machine has none), so it runs there on
its own, without the repository's JAX-side conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Inputs come from a numpy seed. Both versions compute in fp32 and round
once to the output type, differing only in the order of fp32 sums, so
the tolerance is fp32 reassociation for fp32 outputs and one rounding
of the output type (``rtol`` 2 eps, ``atol`` eps / 4) otherwise."""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(b, t, h, kvh, d, pt, n_logical, lengths, sentinel_rows=(),
          seed=0):
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
    # decode kernel (t * h / kvh <= 4 rows per KV head)
    "decode-mha": dict(b=4, t=1, h=2, kvh=2, d=64, pt=16, n_logical=32,
                       lengths=[0, 5, 300, 511]),
    "decode-gqa2": dict(b=3, t=1, h=4, kvh=2, d=128, pt=16, n_logical=8,
                        lengths=[9, 0, 127]),
    "decode-gqa4": dict(b=2, t=1, h=8, kvh=2, d=32, pt=5, n_logical=20,
                        lengths=[44, 99]),
    "decode-t2-r2": dict(b=2, t=2, h=4, kvh=2, d=16, pt=8, n_logical=12,
                         lengths=[3, 70]),
    # a warp's whole chunk past row 0's causal bound
    "decode-t4-edge": dict(b=1, t=4, h=1, kvh=1, d=64, pt=16, n_logical=4,
                           lengths=[30]),
    "decode-d256": dict(b=2, t=1, h=2, kvh=2, d=256, pt=16, n_logical=4,
                        lengths=[20, 63]),
    "decode-sentinel": dict(b=3, t=1, h=2, kvh=2, d=64, pt=16,
                            n_logical=8, lengths=[10, 0, 4],
                            sentinel_rows=(1,)),
    # tiled kernel (prefill chunks, wide GQA groups)
    "chunk-t5": dict(b=3, t=5, h=2, kvh=2, d=64, pt=16, n_logical=8,
                     lengths=[0, 3, 100]),
    "chunk-gqa": dict(b=2, t=3, h=8, kvh=2, d=128, pt=16, n_logical=8,
                      lengths=[17, 60]),
    "chunk-t40": dict(b=2, t=40, h=2, kvh=2, d=64, pt=16, n_logical=16,
                      lengths=[0, 77]),
}


def _tolerance(dtype):
    if dtype == torch.float32:
        return dict(atol=1e-5, rtol=1e-5)
    eps = torch.finfo(dtype).eps
    return dict(atol=eps / 4, rtol=2 * eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda_card, name, dtype):
    q, k, v, table, lengths = _case(**CASES[name])
    args = [torch.from_numpy(x).to(cuda_card, dtype) for x in (q, k, v)]
    args += [torch.from_numpy(x).to(cuda_card) for x in (table, lengths)]
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got, pa.paged_attention_plain(*args),
                               **_tolerance(dtype))
