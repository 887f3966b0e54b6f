"""The port's in-step exact collectives (``horovod_tpu_torch/ops/traced.py``)
in gloo worlds of 4 and 6 processes on the CPU, against the JAX
package's ``ops/traced.py`` in ``shard_map`` over as many devices of the
8-device CPU mesh of tests/conftest.py.

Every rank runs ``_traced_worker`` on inputs made from one numpy seed,
rank r taking row r, and calls each function with every keyword the JAX
function takes: ``op`` (Sum, Average, Min, Max, Product, Adasum),
pre/postscale, a process set (ranks 1 and 3 of the world), the join
``mask`` (alone and with the set) and ``groups=`` (pairs of ranks). The
JAX functions run on the same rows with the same keywords.

Tolerances (ROADMAP's rules): integer-valued fp32 is compared bit for
bit; random normal fp32 within 4 ulp of the largest result (the ranks'
sum in another order); Adasum within 2.0e-7 of the largest magnitude
(phase 9's reading of the tree against its plain version on the card);
outsiders of a process set get their input back exactly.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

SET = [1, 3]
ULP = np.finfo(np.float32).eps


def _ints(n, shape, seed, lo=-50, hi=50):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n,) + tuple(shape)).astype(np.float32)


def _normal(n, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + tuple(shape)).astype(np.float32)


def _mask(n):
    return [r != n - 2 for r in range(n)]


def _pairs(n):
    return [[2 * i, 2 * i + 1] for i in range(n // 2)]


OPS = ("Sum", "Average", "Min", "Max", "Product")


def _traced_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import traced

    hvd.init(device="cpu", store=file_store(outdir, n))
    ps = hvd.add_process_set(SET)
    t = lambda a: torch.from_numpy(a[rank].copy())  # noqa: E731
    x, xn = t(_ints(n, (37,), 1)), t(_normal(n, (37,), 2))
    small = t(_ints(n, (9,), 3, 1, 3))  # products stay exact
    out = {"rank": traced.rank(), "size": traced.size()}
    for name in OPS:
        op = getattr(hvd, name)
        v = small if name == "Product" else x
        out[f"ar_{name}"] = traced.allreduce(v, op=op)
        out[f"ar_set_{name}"] = traced.allreduce(v, op=op, process_set=ps)
    out["ar_avg_legacy"] = traced.allreduce(x, average=True)
    out["ar_scaled"] = traced.allreduce(x, op=hvd.Average,
                                        prescale_factor=2.0,
                                        postscale_factor=0.5)
    out["ar_normal"] = traced.allreduce(xn, op=hvd.Sum)
    out["ar_normal_avg"] = traced.allreduce(xn)
    out["ar_mask"] = traced.allreduce(x, mask=_mask(n))
    out["ar_mask_sum"] = traced.allreduce(x, op=hvd.Sum, mask=_mask(n))
    out["ar_mask_tensor"] = traced.allreduce(
        x, mask=torch.tensor(_mask(n)), postscale_factor=3.0)
    out["ar_mask_set"] = traced.allreduce(x, mask=_mask(n), process_set=ps)
    out["ar_groups"] = traced.allreduce(x, groups=_pairs(n),
                                        prescale_factor=3.0)
    out["ar_groups_sum"] = traced.allreduce(x, op=hvd.Sum,
                                            groups=_pairs(n))
    out["adasum"] = traced.allreduce(xn, op=hvd.Adasum)
    out["adasum_set"] = traced.allreduce(xn, op=hvd.Adasum, process_set=ps,
                                         postscale_factor=2.0)
    raises = {}
    for key, call in (
            ("mask_min", lambda: traced.allreduce(x, op=hvd.Min,
                                                  mask=_mask(n))),
            ("groups_max", lambda: traced.allreduce(x, op=hvd.Max,
                                                    groups=_pairs(n))),
            ("groups_set", lambda: traced.allreduce(x, groups=_pairs(n),
                                                    process_set=ps)),
            ("grouped_product", lambda: traced.grouped_allreduce(
                [x], op=hvd.Product)),
            ("uneven_alltoall", lambda: traced.alltoall(x[:n + 1]))):
        try:
            call()
            raises[key] = None
        except (ValueError, NotImplementedError) as e:
            raises[key] = type(e).__name__
    out["raises"] = raises
    bad = xn.clone()
    if rank == 1:
        bad[3] = float("nan")
    out["finite"] = [bool(traced.finite_scalar(xn)),
                     bool(traced.finite_scalar(traced.allreduce(bad))),
                     bool(traced.finite_scalar(torch.arange(3))),
                     bool(traced.tree_finite({"a": xn, "b": [x, bad]})),
                     bool(traced.tree_finite({"a": xn, "b": [x]})),
                     bool(traced.tree_finite({}))]
    members = [x, t(_ints(n, (2, 3), 4)), t(_normal(n, (5,), 5)),
               t(_ints(n, (4,), 6)).to(torch.bfloat16)]
    for name in ("Sum", "Average", "Max"):
        out[f"grouped_{name}"] = traced.grouped_allreduce(
            members, op=getattr(hvd, name), prescale_factor=2.0)
    out["grouped_set"] = traced.grouped_allreduce(members, op=hvd.Sum,
                                                  process_set=ps)
    panes = t(_ints(n, (2 * n, 3), 7))
    out["gather"] = traced.allgather(panes)
    out["gather_set"] = traced.allgather(panes, process_set=ps)
    out["bcast"] = traced.broadcast(panes, root_rank=n - 1)
    out["bcast_set"] = traced.broadcast(panes, root_rank=3, process_set=ps)
    out["a2a"] = traced.alltoall(panes)
    out["a2a_set"] = traced.alltoall(panes, process_set=ps)
    out["rs"] = traced.reducescatter(panes, op=hvd.Sum)
    out["rs_avg"] = traced.reducescatter(panes, op=hvd.Average,
                                         prescale_factor=2.0,
                                         postscale_factor=3.0)
    out["rs_set"] = traced.reducescatter(panes, op=hvd.Sum, process_set=ps)
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module", params=[4, 6], ids=["world4", "world6"])
def world(request, tmp_path_factory):
    n = request.param
    path = tmp_path_factory.mktemp(f"traced{n}")
    return n, _run(path, n, Path(__file__), "_traced_worker", 150, None)


def _sm(fn, n, *arrays):
    """``fn`` on rank r's rows of ``arrays`` in shard_map over n devices;
    returns every rank's output, stacked."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("hvd",))
    run = jax.jit(jax.shard_map(
        lambda *a: jax.tree_util.tree_map(
            lambda v: v[None], fn(*[v[0] for v in a])),
        mesh=mesh, in_specs=P("hvd"), out_specs=P("hvd"), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, run(*arrays))


def _jax_set(n):
    from horovod_tpu.common.process_sets import ProcessSet

    ps = ProcessSet(SET)
    ps.process_set_id = 1
    return ps


def _eq(got, want):
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(
        want, np.float32))


def test_allreduce_ops_bitwise_on_integers(world):
    from horovod_tpu.ops import reduction_ops as jops
    from horovod_tpu.ops import traced as jt

    n, outs = world
    x, small = _ints(n, (37,), 1), _ints(n, (9,), 3, 1, 3)
    jps = _jax_set(n)
    for name in OPS:
        op = getattr(jops, name)
        v = small if name == "Product" else x
        flat = _sm(lambda a, op=op: jt.allreduce(a, op=op), n, v)
        inset = _sm(lambda a, op=op: jt.allreduce(a, op=op, process_set=jps),
                    n, v)
        for r, o in enumerate(outs):
            _eq(o[f"ar_{name}"], flat[r])
            _eq(o[f"ar_set_{name}"], inset[r])
            if r not in SET:  # outsiders keep their input
                _eq(o[f"ar_set_{name}"], v[r])
    scaled = _sm(lambda a: jt.allreduce(a, op=jops.Average,
                                        prescale_factor=2.0,
                                        postscale_factor=0.5), n, x)
    for r, o in enumerate(outs):
        assert o["rank"] == r and o["size"] == n
        _eq(o["ar_avg_legacy"], o["ar_Average"])
        _eq(o["ar_scaled"], scaled[r])


def test_allreduce_random_within_ulp(world):
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops.reduction_ops import Average, Sum

    n, outs = world
    xn = _normal(n, (37,), 2)
    for key, op in (("ar_normal", Sum), ("ar_normal_avg", Average)):
        want = _sm(lambda a, op=op: jt.allreduce(a, op=op), n, xn)
        tol = 4 * ULP * np.abs(want).max()
        for r, o in enumerate(outs):
            assert np.abs(o[key].numpy() - want[r]).max() <= tol
            assert torch.equal(o[key], outs[0][key])  # every rank equal


def test_join_mask_and_groups(world):
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops.reduction_ops import Average, Sum

    n, outs = world
    x = _ints(n, (37,), 1)
    mask = np.asarray(_mask(n))
    jps = _jax_set(n)
    cases = {
        "ar_mask": lambda a: jt.allreduce(a, mask=mask),
        "ar_mask_sum": lambda a: jt.allreduce(a, op=Sum, mask=mask),
        "ar_mask_tensor": lambda a: jt.allreduce(a, mask=mask,
                                                 postscale_factor=3.0),
        "ar_mask_set": lambda a: jt.allreduce(a, mask=mask,
                                              process_set=jps),
        "ar_groups": lambda a: jt.allreduce(a, op=Average,
                                            groups=_pairs(n),
                                            prescale_factor=3.0),
        "ar_groups_sum": lambda a: jt.allreduce(a, op=Sum,
                                                groups=_pairs(n)),
    }
    for key, fn in cases.items():
        want = _sm(fn, n, x)
        for r, o in enumerate(outs):
            _eq(o[key], want[r])
    live = x[mask].sum(0) / mask.sum()
    for o in outs:
        _eq(o["ar_mask"], live)
    for r, o in enumerate(outs):
        pair = x[r - r % 2:r - r % 2 + 2].sum(0)
        _eq(o["ar_groups_sum"], pair)
        assert o["raises"] == {"mask_min": "ValueError",
                               "groups_max": "ValueError",
                               "groups_set": "NotImplementedError",
                               "grouped_product": "ValueError",
                               "uneven_alltoall": "ValueError"}


def test_adasum_within_bound(world):
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops.reduction_ops import Adasum

    n, outs = world
    xn = _normal(n, (37,), 2)
    jps = _jax_set(n)
    want = _sm(lambda a: jt.allreduce(a, op=Adasum), n, xn)
    want_set = _sm(lambda a: jt.allreduce(a, op=Adasum, process_set=jps,
                                          postscale_factor=2.0), n, xn)
    for r, o in enumerate(outs):
        bound = 2.0e-7 * np.abs(want[r]).max()
        assert np.abs(o["adasum"].numpy() - want[r]).max() <= bound
        bound = 2.0e-7 * np.abs(want_set[r]).max()
        assert np.abs(o["adasum_set"].numpy() - want_set[r]).max() <= bound
        if r not in SET:
            _eq(o["adasum_set"], xn[r])


def test_finite_sentinels(world):
    """On reduced values the flag agrees across ranks with no collective;
    on a rank's own tree it is that rank's."""
    _, outs = world
    for r, o in enumerate(outs):
        assert o["finite"] == [True, False, True, r != 1, True, True]


def test_grouped_allreduce(world):
    import jax.numpy as jnp
    from horovod_tpu.ops import reduction_ops as jops
    from horovod_tpu.ops import traced as jt

    n, outs = world
    arrays = [_ints(n, (37,), 1), _ints(n, (2, 3), 4), _normal(n, (5,), 5),
              _ints(n, (4,), 6)]
    jps = _jax_set(n)
    for name in ("Sum", "Average", "Max"):
        want = _sm(lambda *a, op=getattr(jops, name): jt.grouped_allreduce(
            list(a[:3]) + [a[3].astype(jnp.bfloat16)], op=op,
            prescale_factor=2.0), n, *arrays)
        for r, o in enumerate(outs):
            got = o[f"grouped_{name}"]
            assert got[3].dtype == torch.bfloat16
            for i, (g, w) in enumerate(zip(got, want)):
                if i == 2:  # random normal: within ulp
                    tol = 4 * ULP * np.abs(w[r]).max()
                    assert np.abs(g.numpy() - w[r]).max() <= tol
                else:
                    _eq(g, w[r])
    want = _sm(lambda *a: jt.grouped_allreduce(
        list(a[:3]) + [a[3].astype(jnp.bfloat16)], op=jops.Sum,
        process_set=jps), n, *arrays)
    for r, o in enumerate(outs):
        for i, (g, w) in enumerate(zip(o["grouped_set"], want)):
            if i != 2:
                _eq(g, w[r])


def test_gather_broadcast_alltoall_reducescatter(world):
    import jax
    from horovod_tpu.ops import traced as jt
    from horovod_tpu.ops.reduction_ops import Average, Sum

    n, outs = world
    panes = _ints(n, (2 * n, 3), 7)
    jps = _jax_set(n)
    cases = {
        "gather": lambda a: jt.allgather(a),
        "gather_set": lambda a: jt.allgather(a, process_set=jps),
        "bcast": lambda a: jt.broadcast(a, n - 1),
        "bcast_set": lambda a: jt.broadcast(a, 3, process_set=jps),
        "a2a": lambda a: jt.alltoall(a),
        "a2a_set": lambda a: jt.alltoall(a, process_set=jps),
        "rs": lambda a: jt.reducescatter(a, op=Sum),
        "rs_avg": lambda a: jt.reducescatter(a, op=Average,
                                             prescale_factor=2.0,
                                             postscale_factor=3.0),
        "rs_set": lambda a: jt.reducescatter(a, op=Sum, process_set=jps),
    }
    for key, fn in cases.items():
        want = _sm(fn, n, panes)
        for r, o in enumerate(outs):
            assert tuple(o[key].shape) == want[r].shape, key
            _eq(o[key], want[r])
    for r, o in enumerate(outs):
        if r not in SET:
            _eq(o["a2a_set"], panes[r])
            _eq(o["bcast_set"], panes[r])
