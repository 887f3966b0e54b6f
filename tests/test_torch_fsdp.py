"""The port's shard geometry (``horovod_tpu_torch/parallel/fsdp.py``)
against the JAX package's flat ZeRO layout (``horovod_tpu/parallel/
fsdp.py:44-121``), exactly: the same cols for every size 0–1000 and
every world 1–8, and the same pads, rows and values at every size to 64
and every 37th to 1000. The geometry is integers and copies, so nothing
here has a tolerance."""

import numpy as np
import pytest
import torch

SIZES = range(0, 1001)
# the tensor functions: every size to 64, then every 37th to 1000 (each
# new shape costs the JAX side a compile)
TENSOR_SIZES = sorted(set(range(65)) | set(range(65, 1001, 37)) | {1000})
WORLDS = range(1, 9)


def test_shard_cols_equal_jax():
    from horovod_tpu.parallel import fsdp as jfsdp
    from horovod_tpu_torch.parallel import fsdp

    for n in WORLDS:
        for size in SIZES:
            assert fsdp.shard_cols(size, n) == jfsdp.shard_cols(size, n)


@pytest.mark.parametrize("n", list(WORLDS))
def test_rows_shards_and_unshard_equal_jax(n):
    """``pad_to``, ``host_shard_rows``, ``host_shard``, ``dyn_shard`` and
    ``host_unshard`` give the JAX functions' shapes and values (the
    tensor ``arange(size) + 1``, so a padding zero cannot pass for a
    value), on 1-D and 2-D tensors and a 0-d one."""
    import jax.numpy as jnp

    from horovod_tpu.parallel import fsdp as jfsdp
    from horovod_tpu_torch.parallel import fsdp

    for size in TENSOR_SIZES:
        flat = np.arange(1, size + 1, dtype=np.float32)
        shape = (size,) if size % 3 else (size // 3, 3)
        x, jx = torch.from_numpy(flat).view(shape), jnp.asarray(
            flat.reshape(shape))
        np.testing.assert_array_equal(
            fsdp.pad_to(x.reshape(-1), n).numpy(),
            np.asarray(jfsdp.pad_to(jx.reshape(-1), n)))
        rows = fsdp.host_shard_rows(x, n)
        want = np.asarray(jfsdp.host_shard_rows(jx, n))
        assert tuple(rows.shape) == want.shape, (size, n)
        np.testing.assert_array_equal(rows.numpy(), want)
        for r in range(n):
            np.testing.assert_array_equal(
                fsdp.host_shard(x, n, r).numpy(), want[r])
            np.testing.assert_array_equal(
                fsdp.dyn_shard(x, n, r).numpy(), want[r])
        back = fsdp.host_unshard(rows, shape)
        assert tuple(back.shape) == shape
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jfsdp.host_unshard(want, shape)))
    s = torch.tensor(2.5)
    np.testing.assert_array_equal(fsdp.host_shard_rows(s, n).numpy(),
                                  np.asarray(jfsdp.host_shard_rows(
                                      jnp.asarray(2.5, jnp.float32), n)))
    assert fsdp.host_shard(s, n, 0) is s
    assert float(fsdp.host_unshard(fsdp.host_shard_rows(s, n), ())) == 2.5


@pytest.mark.parametrize("n", list(WORLDS))
def test_reshard_rows_equal_jax(n):
    """Rows of world ``n`` re-split for every other world 1–8 equal the
    JAX function's, and unshard to the original tensor bit for bit."""
    from horovod_tpu.parallel import fsdp as jfsdp
    from horovod_tpu_torch.parallel import fsdp

    for size in TENSOR_SIZES:
        flat = np.arange(1, size + 1, dtype=np.float32)
        rows = fsdp.host_shard_rows(torch.from_numpy(flat), n)
        for m in WORLDS:
            got = fsdp.reshard_rows(rows, size, m)
            want = np.asarray(jfsdp.reshard_rows(rows.numpy(), size, m))
            assert tuple(got.shape) == want.shape == (
                m, jfsdp.shard_cols(size, m))
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                fsdp.host_unshard(got, (size,)).numpy(), flat)
    got = fsdp.reshard_rows(np.ones((2, 3), np.float32), 5, 4,
                            torch.float64)
    assert got.dtype == torch.float64 and tuple(got.shape) == (4, 2)
