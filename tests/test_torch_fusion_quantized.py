"""The fusion manager's int8 wire (``horovod_tpu_torch/ops/fusion.py``,
``_allreduce_q``) in gloo worlds of 1, 2, 3 and 4 processes, held to the
contracts of tests/test_fusion_quantized.py and against the JAX
package's two-stage recipe on its CPU mesh.

Every rank runs ``_wire_worker`` on inputs made from one numpy seed,
rank r taking row r. The quantized result must sit within the two-stage
quantum budget of the exact reduction (one quantum of each rank's row at
stage 1, one of the reduced row at stage 2: ``_quantum_bound``), as JAX
``traced.quantized_allreduce`` (the recipe the JAX fused wire mirrors)
does on an n-device mesh for the same per-rank inputs. Also: the
residual reconstructs the wire value, the prescale fold matches
pre-multiplying bit for bit, a zero prescale gives a zero residual,
zero padding quantizes to exact zero, a process set reduces over its
own members, the wire byte counter drops about
4× (the JAX ``_hop_bytes`` model), Min/Max/Product and integers ride the
exact wire, a bad residual request raises at enqueue without stranding
a pending entry, and ``HOROVOD_FUSION_WIRE=int8`` applies without
``compression=`` while ``Compression.none`` opts out (and the bf16 wire
halves the bytes)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

WORLDS = [1, 2, 3, 4]
SIZES = [700, 260]


def _rows(n, size, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=size) * (r + 1)
                     for r in range(n)]).astype(np.float32)


def _wire_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init(device="cpu", store=file_store(outdir, n))
    fusion = basics.state().fusion
    int8 = hvd.Compression.int8
    out = {}
    xs = [torch.from_numpy(_rows(n, s, i)[rank]) for i, s in
          enumerate(SIZES)]
    hs = [hvd.allreduce_async(x, op=hvd.Sum, compression=int8) for x in xs]
    d0 = fusion.dispatched_batches
    out["sum"] = [h.wait() for h in hs]
    out["sum_batches"] = fusion.dispatched_batches - d0
    out["avg"] = hvd.grouped_allreduce(xs, op=hvd.Average, compression=int8)
    out["block"] = hvd.allreduce(
        xs[0], op=hvd.Sum,
        compression=hvd.Compression.int8_block.with_block_size(64))

    # residual: the error-feedback carry
    x = torch.from_numpy(_rows(n, 256, 7)[rank])
    out["res_out"], out["res"] = hvd.allreduce(
        x, op=hvd.Sum, compression=int8, return_residual=True)

    # the residual norm: published only while a metrics sink watches
    from horovod_tpu_torch.common.metrics import registry
    out["norm_unwatched"] = ("fusion.ef_residual_norm" in registry.snapshot(),
                             fusion.ef_residual_norm)
    registry.configure_export(str(Path(outdir) / f"metrics{rank}.jsonl"))
    try:
        _, r = hvd.allreduce(x, op=hvd.Sum, compression=int8,
                             return_residual=True)
        out["norm"] = (registry.snapshot().get("fusion.ef_residual_norm"),
                       fusion.ef_residual_norm,
                       float(torch.linalg.vector_norm(r.double())))
    finally:
        registry._path = None  # no sink outside this case

    # prescale fold: the same seed for both dispatches
    c = 0.125
    x = torch.from_numpy(_rows(n, 130, 8)[rank])
    fusion._seed_counter = 100
    out["two_pass"] = hvd.allreduce(x * c, op=hvd.Sum, compression=int8,
                                    return_residual=True)
    fusion._seed_counter = 100
    out["folded"] = hvd.allreduce(x, op=hvd.Sum, compression=int8,
                                  prescale_factor=c, return_residual=True)
    out["zero"] = hvd.allreduce(torch.ones(130), op=hvd.Sum,
                                compression=int8, prescale_factor=0.0,
                                return_residual=True)

    # zero padding inside a batch, and the byte counter
    base = torch.from_numpy(_rows(n, 300, 9)[rank])
    out["padded"] = hvd.grouped_allreduce(
        [base, torch.zeros(212)], op=hvd.Sum, compression=int8,
        return_residual=True)
    before = (fusion.dispatched_bytes, fusion.wire_bytes_saved,
              fusion.quant_blocks)
    hvd.allreduce(torch.ones(4096) * (rank + 1), op=hvd.Sum,
                  compression=int8)
    out["bytes"] = [a - b for a, b in zip(
        (fusion.dispatched_bytes, fusion.wire_bytes_saved,
         fusion.quant_blocks), before)]
    out["format"] = fusion.last_wire_format

    # ops and dtypes the int8 wire does not carry
    y = torch.arange(1.0, 6.0) + rank
    out["min"] = hvd.allreduce(y, op=hvd.Min, compression=int8)
    out["min_format"] = fusion.last_wire_format
    out["max"] = hvd.allreduce(y, op=hvd.Max, compression=int8)
    out["prod"] = hvd.allreduce(y, op=hvd.Product, compression=int8)
    out["ints"] = hvd.allreduce(torch.arange(5) + rank, op=hvd.Sum,
                                compression=int8)
    healthy = hvd.allreduce_async(torch.ones(16), op=hvd.Sum, name="ok")
    errors = []
    for kw in (dict(op=hvd.Min), dict(op=hvd.Adasum),
               dict(op=hvd.Sum, compression=hvd.Compression.bf16)):
        try:
            hvd.allreduce_async(torch.ones(8), return_residual=True, **kw)
        except ValueError as e:
            errors.append(str(e))
    try:
        hvd.allreduce_async(torch.ones(8, dtype=torch.int32), op=hvd.Sum,
                            return_residual=True)
    except ValueError as e:
        errors.append(str(e))
    out["errors"] = errors
    out["healthy"] = healthy.wait()

    # a process set of the first and last rank
    ps = hvd.add_process_set(sorted({0, n - 1}))
    if rank in (0, n - 1):
        out["set_avg"] = hvd.allreduce(xs[0], op=hvd.Average,
                                       compression=int8, process_set=ps)

    # the manager's knob, and Compression.none opting out of it
    fusion.wire = "int8"
    z = torch.full((1024,), float(rank + 1))
    s0 = fusion.wire_bytes_saved
    out["knob"] = hvd.allreduce(z, op=hvd.Sum)
    out["knob_saved"] = fusion.wire_bytes_saved - s0
    out["knob_format"] = fusion.last_wire_format
    out["opt_out"] = hvd.allreduce(z, op=hvd.Sum,
                                   compression=hvd.Compression.none)
    out["opt_out_format"] = fusion.last_wire_format
    fusion.wire = "bf16"
    s0 = fusion.wire_bytes_saved
    out["bf16"] = hvd.allreduce(z, op=hvd.Sum)
    out["bf16_saved"] = fusion.wire_bytes_saved - s0
    out["bf16_format"] = fusion.last_wire_format
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module", params=WORLDS)
def world(request, tmp_path_factory):
    n = request.param
    return n, _run(tmp_path_factory.mktemp(f"wire{n}"), n, Path(__file__),
                   "_wire_worker", 120, None)


def _quantum_bound(rows):
    """One quantum (absmax/127) of each rank's row at stage 1, plus one
    of the reduced row at stage 2 (tests/test_fusion_quantized.py)."""
    q1 = sum(np.abs(r).max() for r in rows) / 127.0
    return q1 + np.abs(np.sum(rows, axis=0)).max() / 127.0


def _batch_rows(n, sizes, seeds):
    return [np.concatenate([_rows(n, s, i)[r] for s, i in zip(sizes, seeds)])
            for r in range(n)]


def _jax_quantized(stack, block=512, **kw):
    """JAX ``traced.quantized_allreduce`` with block scales on an
    n-device CPU mesh, rank r holding ``stack[r]``."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.ops import traced

    n = stack.shape[0]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("hvd",))
    fn = jax.jit(partial(
        jax.shard_map, mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"),
        check_vma=False,
    )(lambda t: traced.quantized_allreduce(
        t[0], axis_name="hvd", block_size=block, **kw)[None]))
    return np.asarray(fn(jnp.asarray(stack)))


def test_sum_and_average_within_the_quantum_budget(world):
    from horovod_tpu.ops.reduction_ops import Sum

    n, outs = world
    rows = _batch_rows(n, SIZES, [0, 1])
    bound = _quantum_bound(rows)
    exact = np.sum(rows, axis=0)
    jax_out = _jax_quantized(np.stack(rows), op=Sum)
    for o in outs:
        assert o["sum_batches"] == 1  # both entries in one fused batch
        got = np.concatenate([t.numpy() for t in o["sum"]])
        assert np.abs(got - exact).max() <= bound * 1.01
        avg = np.concatenate([t.numpy() for t in o["avg"]])
        assert np.abs(avg - exact / n).max() <= bound / n * 1.01
    for r in range(n):
        # the JAX recipe, same inputs, same budget; the two within twice
        assert np.abs(jax_out[r] - exact).max() <= bound * 1.01
        got = np.concatenate([t.numpy() for t in outs[r]["sum"]])
        assert np.abs(got - jax_out[r]).max() <= 2 * bound * 1.01


def test_block_size_of_the_compressor_is_used(world):
    n, outs = world
    rows = [_rows(n, SIZES[0], 0)[r] for r in range(n)]
    exact = np.sum(rows, axis=0)
    for o in outs:
        assert np.abs(o["block"].numpy() - exact).max() <= \
            _quantum_bound(rows) * 1.01


def test_residual_reconstructs_the_wire_value(world):
    """|residual| within the rank's quantum plus the reduced row's, and
    the carry's defining identity: what went out is the inputs' sum less
    the residuals' sum."""
    n, outs = world
    rows = _rows(n, 256, 7)
    q2 = np.abs(rows.sum(0)).max() / 127.0
    for r, o in enumerate(outs):
        q1 = np.abs(rows[r]).max() / 127.0
        assert np.abs(o["res"].numpy()).max() <= (q1 + q2) * 1.01
    sent = rows.sum(0) - sum(o["res"].numpy() for o in outs)
    for o in outs:
        np.testing.assert_allclose(o["res_out"].numpy(), sent, rtol=1e-5,
                                   atol=1e-5 * np.abs(rows).max())


def test_ef_residual_norm_gauge_when_observability_on(world):
    """``fusion.ef_residual_norm`` (the reference's ``_note_residuals``,
    tests/test_fusion_quantized.py): absent while nothing watches, then
    the registry gauge equals the manager's attribute and the L2 norm of
    the residual the call returned."""
    n, outs = world
    for out in outs:
        assert out["norm_unwatched"] == (False, 0.0)
        gauge, attr, norm = out["norm"]
        assert gauge == attr and np.isfinite(attr)
        assert abs(attr - norm) <= 1e-5 * max(norm, 1.0)


def test_prescale_folds_into_the_wire_scales_bit_exact(world):
    _, outs = world
    for o in outs:
        (out_a, res_a), (out_b, res_b) = o["two_pass"], o["folded"]
        assert torch.equal(out_a, out_b)
        # the two-pass residual is in prescaled units, the folded one in
        # input units
        np.testing.assert_allclose(res_a.numpy() / 0.125, res_b.numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_zero_prescale_gives_zero_not_nan(world):
    _, outs = world
    for o in outs:
        out, res = o["zero"]
        assert torch.equal(out, torch.zeros(130))
        assert torch.equal(res, torch.zeros(130))


def test_zero_padding_quantizes_to_exact_zero(world):
    n, outs = world
    rows = [_rows(n, 300, 9)[r] for r in range(n)]
    exact = np.sum(rows, axis=0)
    bound = _quantum_bound(rows)
    for o in outs:
        (out, _res), (pad_out, pad_res) = o["padded"]
        assert np.abs(out.numpy() - exact).max() <= bound * 1.01
        assert torch.equal(pad_out, torch.zeros(212))
        assert torch.equal(pad_res, torch.zeros(212))


def test_wire_byte_counter_drops_about_4x(world):
    from horovod_tpu.ops.fusion import FusionManager

    from horovod_tpu_torch.ops.fusion import hop_bytes

    n, outs = world
    want, blocks = FusionManager._hop_bytes(4096, "int8", 4, n, 512)
    assert hop_bytes(4096, "int8", 4, n, 512) == (want, blocks)
    for o in outs:
        wire, saved, qb = o["bytes"]
        assert (wire, qb) == (want, blocks)
        assert saved == 4096 * 4 - wire
        assert 4096 * 4 / wire >= 3.5
        assert o["format"] == "int8"


def test_process_set_within_the_quantum_budget(world):
    n, outs = world
    rows = [_rows(n, SIZES[0], 0)[r] for r in sorted({0, n - 1})]
    exact = np.mean(rows, axis=0)
    for r, o in enumerate(outs):
        if r in (0, n - 1):
            assert np.abs(o["set_avg"].numpy() - exact).max() <= \
                _quantum_bound(rows) / len(rows) * 1.01
        else:
            assert "set_avg" not in o


def test_exact_ops_and_integers_ride_the_fp32_wire(world):
    n, outs = world
    y = np.arange(1.0, 6.0)
    for o in outs:
        assert np.array_equal(o["min"].numpy(), y)
        assert o["min_format"] == "fp32"
        assert np.array_equal(o["max"].numpy(), y + n - 1)
        assert np.array_equal(o["prod"].numpy(), np.prod(
            [y + r for r in range(n)], axis=0))
        assert torch.equal(o["ints"], torch.arange(5) * n + sum(range(n)))


def test_bad_residual_requests_raise_at_enqueue(world):
    n, outs = world
    for o in outs:
        min_err, adasum_err, bf16_err, int_err = o["errors"]
        assert "Sum/Average" in min_err and "Sum/Average" in adasum_err
        assert "int8" in bf16_err and "floating" in int_err
        assert torch.equal(o["healthy"], torch.full((16,), float(n)))


def test_wire_knobs_apply_and_none_opts_out(world):
    n, outs = world
    total = float(sum(range(1, n + 1)))
    for o in outs:
        assert o["knob_format"] == "int8" and o["knob_saved"] > 0
        assert np.abs(o["knob"].numpy() - total).max() <= \
            (n + 1) * n / 127.0
        assert o["opt_out_format"] == "fp32"
        assert torch.equal(o["opt_out"], torch.full((1024,), total))
        # the bf16 wire: half the bytes, exact on small integers
        assert o["bf16_format"] == "bf16" and o["bf16_saved"] == 1024 * 2
        assert torch.equal(o["bf16"], torch.full((1024,), total))


def test_wire_env_knobs(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOROVOD_FUSION_WIRE", "int8")
    monkeypatch.setenv("HOROVOD_FUSION_WIRE_BLOCK", "128")
    hvd.init(device="cpu")
    try:
        fusion = basics.state().fusion
        assert (fusion.wire, fusion.wire_block) == ("int8", 128)
        out = hvd.allreduce(torch.ones(1000), op=hvd.Sum)
        assert fusion.last_wire_format == "int8"
        assert torch.equal(out, torch.ones(1000))  # all-equal blocks
    finally:
        hvd.shutdown()
    # auto: each batch's wire from the wire tuner; the first dispatches
    # of a tier are trials of its menu in order (fp32, bf16, int8), and
    # the sums stay exact on integer-valued fp32 under fp32 and bf16
    monkeypatch.setenv("HOROVOD_FUSION_WIRE", "auto")
    monkeypatch.delenv("HOROVOD_TUNER_CACHE", raising=False)
    hvd.init(device="cpu")
    try:
        fusion = basics.state().fusion
        assert fusion.wire == "auto" and fusion.wire_tuner is not None
        key = ("allreduce", 1 << 15, "float32")
        wires = []
        for _ in range(7):
            out = hvd.allreduce(torch.ones(1 << 15), op=hvd.Sum)
            wires.append(fusion.last_wire_format)
            assert torch.equal(out, torch.ones(1 << 15))
        assert wires[:6] == ["fp32"] * 3 + ["bf16"] * 3
        assert wires[6] == "int8" and fusion.wire_trials == 7
        assert fusion.wire_choices[key] == "int8"
        # an integer payload rides the exact wire, never a trial
        hvd.allreduce(torch.ones(8, dtype=torch.int32), op=hvd.Sum)
        assert fusion.last_wire_format == "fp32"
        assert fusion.wire_trials == 7
    finally:
        hvd.shutdown()
    # the two-level placement of the int8 wire is a switch now
    monkeypatch.setenv("HOROVOD_FUSION_WIRE", "int8")
    monkeypatch.setenv("HOROVOD_FUSION_WIRE_HIER", "1")
    hvd.init(device="cpu")
    try:
        assert basics.state().fusion.wire_hier
        assert torch.equal(hvd.allreduce(torch.ones(64), op=hvd.Sum),
                           torch.ones(64))  # a world of one: flat
        assert basics.state().fusion.hier_dispatches == 0
    finally:
        hvd.shutdown()
    monkeypatch.delenv("HOROVOD_FUSION_WIRE_HIER", raising=False)
