"""The port's parallelism primitives (``horovod_tpu_torch/parallel/``)
against the JAX package's on the CPU: the mesh, the tp pair, the dense
and flash rings (values and gradients, causal and not, grouped-query),
GPipe, the 1F1B tables (equal to ``_build_1f1b_schedule``'s), and 1F1B
plain, interleaved, with a parameterized tail and input cotangents, and
with the collective-free declaration.

The same seeded numpy inputs go to both sides: the JAX functions run
under ``shard_map`` on the conftest's 8-device CPU mesh (the flash ring
on the interpret-mode kernels), the port in one gloo world of 8 CPU
processes (``_parallel_worker``, run once for the module), each case
on a mesh over the world or over its first ranks. Forward values within
1e-5 (fp32), gradients within the JAX tests' rtol 5e-4.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

WORLD = 8
RING_CASES = [(name, causal) for name in ("dense", "flash", "dense_gqa",
                                          "flash_gqa")
              for causal in (False, True)]
PIPE_CASES = [("plain", 4, 1), ("tail_dx", 4, 1), ("interleaved", 2, 2),
              ("interleaved", 4, 2), ("free", 4, 1), ("free_tail", 4, 1)]


# ------------------------------------------------------ the shared inputs


def _ring_inputs(name):
    rng = np.random.default_rng(7)
    b, t, h, d = 2, 32, 4, 8
    g = 2 if name.endswith("gqa") else h
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, g, d)).astype(np.float32)
    v = rng.normal(size=(b, t, g, d)).astype(np.float32)
    w = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return q, k, v, w


def _tp_inputs():
    rng = np.random.default_rng(3)
    d, f = 16, 32
    return (rng.normal(size=(4, d)).astype(np.float32),
            rng.normal(size=(d, f)).astype(np.float32),
            rng.normal(size=(f,)).astype(np.float32),
            rng.normal(size=(f, d)).astype(np.float32),
            rng.normal(size=(4, d)).astype(np.float32))


def _gpipe_inputs():
    rng = np.random.default_rng(4)
    n_micro, bm, d, pp = 6, 2, 8, 4
    return (rng.normal(size=(n_micro, bm, d)).astype(np.float32),
            rng.normal(size=(pp, d)).astype(np.float32),
            rng.normal(size=(pp, d)).astype(np.float32))


def _pipe_inputs(kind, pp, v):
    rng = np.random.default_rng(100 + 10 * pp + v)
    n_micro = {"plain": 7, "free": 6, "free_tail": 6}.get(kind, 5)
    bm, d = 2, 8
    x = rng.normal(size=(n_micro, bm, d)).astype(np.float32)
    y = rng.normal(size=(n_micro, bm, d)).astype(np.float32)
    w = (0.5 * rng.normal(size=(pp * v, d, d))).astype(np.float32)
    b = (0.1 * rng.normal(size=(pp, d))).astype(np.float32)
    tail = (0.5 * rng.normal(size=(d, d))).astype(np.float32)
    return x, y, w, b, tail


def _seq_slice(rank, n, t):
    tl = t // n
    return slice(rank * tl, (rank + 1) * tl)


# ---------------------------------------------------------- the port world


def _port_pipeline(kind, pp, v, mesh):
    """One pipeline case on this rank of a pp-mesh: a dict of its
    results (this stage's loss and grads)."""
    from horovod_tpu_torch.parallel.pipeline import pipeline_1f1b

    x, y, w, b, tail = (torch.from_numpy(a) for a in
                        _pipe_inputs(kind, pp, v))
    axis = mesh.axis("pp")
    s = axis.index
    stats = {}
    if kind == "plain":
        def stage_fn(p, xb):
            return torch.tanh(xb @ p[0] + p[1])

        loss, grads = pipeline_1f1b(
            stage_fn, lambda out, tgt: ((out - tgt) ** 2).mean(),
            (w[s], b[s]), x, y, axis=axis, stats=stats)
        return {"loss": loss, "gw": grads[0], "gb": grads[1],
                "stats": stats}
    if kind in ("free", "free_tail"):
        def stage_fn(ws, xb):
            return torch.tanh(xb @ ws)

        res = {}
        for fast in (False, True):
            kw = dict(axis=axis, loss_collective_free=fast)
            if kind == "free_tail":
                out = pipeline_1f1b(
                    stage_fn,
                    lambda p, o, tgt: p["s"] * ((o - tgt) ** 2).mean(),
                    w[s], x, y, loss_params={"s": torch.tensor(1.3)}, **kw)
            else:
                out = pipeline_1f1b(
                    stage_fn, lambda o, tgt: ((o - tgt) ** 2).mean(),
                    w[s], x, y, **kw)
            res[fast] = out
        return {"loss": res[False][0], "gw": res[False][1],
                "tail": res[False][2]["s"] if kind == "free_tail" else None,
                "same": all(torch.equal(a, b_) for a, b_ in zip(
                    _flat(res[False]), _flat(res[True])))}

    def stage_fn(p, xb):
        return torch.tanh(xb @ p)

    params = w[s] if v == 1 else torch.stack([w[c * pp + s]
                                              for c in range(v)])
    loss, grads, gtail, dx = pipeline_1f1b(
        stage_fn, lambda tl, o, tgt: ((o @ tl - tgt) ** 2).mean(),
        params, x, y, axis=axis, loss_params=tail, return_dx=True,
        virtual_stages=v, stats=stats)
    return {"loss": loss, "gw": grads, "gtail": gtail, "dx": dx,
            "stats": stats}


def _flat(out):
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(out)


def _parallel_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import (
        MeshSpec,
        column_parallel_dense,
        gpipe,
        ring_attention,
        ring_flash_attention,
        row_parallel_dense,
    )
    from horovod_tpu_torch.parallel.mesh import world_axis

    torch.manual_seed(0)
    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {}
    mesh = MeshSpec(dp=2, sp=2, tp=2).build()
    out["coords"] = dict(mesh.coords)
    out["tp_rank"] = mesh.axis("tp").ranks

    # the tp pair over the world: column shards of w1/b1, row shards of w2
    x, w1, b1, w2, wout = (torch.from_numpy(a) for a in _tp_inputs())
    f = w1.shape[1] // n
    cols = slice(rank * f, (rank + 1) * f)
    xs = x.clone().requires_grad_()
    w1s = w1[:, cols].clone().requires_grad_()
    b1s = b1[cols].clone().requires_grad_()
    w2s = w2[cols].clone().requires_grad_()
    y = row_parallel_dense(column_parallel_dense(xs, w1s, b1s), w2s)
    (y * wout).sum().backward()
    out["tp"] = [t.detach() for t in
                 (y, xs.grad, w1s.grad, b1s.grad, w2s.grad)]

    # the rings over the world (sp = 8)
    axis = world_axis()
    for name, causal in RING_CASES:
        q, k, v, w = (torch.from_numpy(a) for a in _ring_inputs(name))
        sl = _seq_slice(rank, n, q.shape[1])
        ql, kl, vl = (a[:, sl].clone().requires_grad_() for a in (q, k, v))
        fn = ring_flash_attention if name.startswith("flash") else \
            ring_attention
        o = fn(ql, kl, vl, axis=axis, causal=causal)
        (o * w[:, sl]).sum().backward()
        out[("ring", name, causal)] = [t.detach() for t in
                                       (o, ql.grad, kl.grad, vl.grad)]

    # GPipe over the first 4 ranks
    m4 = MeshSpec(pp=4).build(list(range(4)))
    if m4.member:
        xg, wg, cg = (torch.from_numpy(a) for a in _gpipe_inputs())
        s = m4.axis("pp").index
        og = gpipe(lambda p, xb: xb * p[0] + p[1], (wg[s], cg[s]), xg,
                   axis=m4.axis("pp"))
        out["gpipe"] = og.detach()
    # 1F1B over the first pp ranks
    m2 = MeshSpec(pp=2).build([0, 1])
    for kind, pp, v in PIPE_CASES:
        m = m4 if pp == 4 else m2
        if m.member:
            res = _port_pipeline(kind, pp, v, m)
            out[("pipe", kind, pp, v)] = {
                k: (val.detach() if torch.is_tensor(val) else val)
                for k, val in res.items()}
    # the stash stays bounded as n_micro grows
    if m4.member:
        from horovod_tpu_torch.parallel.pipeline import pipeline_1f1b

        peaks = {}
        for n_micro in (8, 32):
            xb = torch.zeros((n_micro, 4, 8))
            st = {}
            pipeline_1f1b(lambda p, a: torch.tanh(a @ p),
                          lambda o, tgt: ((o - tgt) ** 2).mean(),
                          torch.zeros(8, 8), xb, xb, axis=m4.axis("pp"),
                          stats=st)
            peaks[n_micro] = st["stash_peak"]
        out["stash_peaks"] = peaks
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("parallel"), WORLD, Path(__file__),
                "_parallel_worker", 240, None)


# ------------------------------------------------------------- the JAX side


def _jax_mesh(name, n=WORLD):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _shard_map(fn, mesh, in_specs, out_specs):
    import jax

    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# ------------------------------------------------------------------ tests


def test_mesh_spec():
    from horovod_tpu_torch.parallel import MeshSpec
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER

    from horovod_tpu.parallel import mesh as jmesh

    assert AXIS_ORDER == jmesh.AXIS_ORDER
    spec = MeshSpec.auto(8, tp=2, sp=2)
    assert spec.dp == 2 and spec.size == 8
    assert spec.shape == (2, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        MeshSpec.auto(8, tp=3)
    with pytest.raises(ValueError, match="needs 3 devices"):
        MeshSpec(dp=3).build(ranks=[0, 1])


def test_mesh_coords_match_jax(hvd, world):
    import jax

    from horovod_tpu.parallel import MeshSpec as JMeshSpec

    mesh = JMeshSpec.auto(8, tp=2, sp=2).build(jax.devices())
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, out in enumerate(world):
        want = dict(zip(mesh.axis_names,
                        (int(c) for c in np.argwhere(ids == r)[0])))
        assert out["coords"] == want
        # the tp group: the ranks differing only in the tp coordinate
        assert list(out["tp_rank"]) == [int(i) for i in ids[tuple(
            want[a] for a in mesh.axis_names[:-1])]]


def test_tp_pair_matches_jax(hvd, world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel import column_parallel_dense as jcol
    from horovod_tpu.parallel import row_parallel_dense as jrow

    x, w1, b1, w2, wout = _tp_inputs()
    fwd = _shard_map(
        lambda x, a, b, c: jrow(jcol(x, a, b), c, axis_name="tp"),
        _jax_mesh("tp"), (P(), P(None, "tp"), P("tp"), P("tp", None)), P())
    want = np.asarray(fwd(x, w1, b1, w2))

    def full(x, w1, b1, w2):
        return jnp.sum(((x @ w1 + b1) @ w2) * wout)

    gx, g1, gb1, g2 = jax.grad(full, argnums=(0, 1, 2, 3))(x, w1, b1, w2)
    f = w1.shape[1] // WORLD
    for r, out in enumerate(world):
        y, dx, dw1, db1, dw2 = out["tp"]
        _close(y, want, rtol=1e-5, atol=1e-4)
        cols = slice(r * f, (r + 1) * f)
        _close(dx, gx, rtol=5e-4, atol=1e-4, msg="dx")
        _close(dw1, np.asarray(g1)[:, cols], rtol=5e-4, atol=1e-4)
        _close(db1, np.asarray(gb1)[cols], rtol=5e-4, atol=1e-4)
        _close(dw2, np.asarray(g2)[cols], rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("name,causal", RING_CASES)
def test_ring_matches_jax(hvd, world, name, causal):
    """Values and q/k/v gradients of the port's ring on 8 gloo ranks
    against the JAX ring on the 8-device mesh (the flash ring's kernels
    in interpret mode there, plain PyTorch here)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel.ring_attention import (
        ring_attention as jring,
        ring_flash_attention as jflash,
    )

    fn = jflash if name.startswith("flash") else jring
    q, k, v, w = _ring_inputs(name)
    mesh = _jax_mesh("sp")
    fwd = _shard_map(lambda q, k, v: fn(q, k, v, "sp", causal), mesh,
                     P(None, "sp"), P(None, "sp"))

    def loss(q, k, v, w):
        return jnp.sum(fn(q, k, v, "sp", causal) * w)

    grads = _shard_map(
        lambda q, k, v, w: jax.grad(loss, argnums=(0, 1, 2))(q, k, v, w),
        mesh, P(None, "sp"), P(None, "sp"))
    want = [np.asarray(fwd(q, k, v))] + [np.asarray(g) for g in
                                         grads(q, k, v, w)]
    for r, out in enumerate(world):
        sl = _seq_slice(r, WORLD, q.shape[1])
        got = out[("ring", name, causal)]
        _close(got[0], want[0][:, sl], msg=f"rank {r} out")
        for label, g, wg in zip("qkv", got[1:], want[1:]):
            _close(g, wg[:, sl], rtol=5e-4, atol=5e-5,
                   msg=f"rank {r} d{label}")


def test_gpipe_matches_jax(hvd, world):
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel import gpipe as jgpipe

    x, w, c = _gpipe_inputs()
    pp = 4

    def per_device(x, ws, cs):
        out = jgpipe(lambda p, xb: xb * p[0] + p[1], (ws[0], cs[0]), x,
                     axis_name="pp")
        stage = lax.axis_index("pp")
        return lax.psum(jnp.where(stage == pp - 1, out,
                                  jnp.zeros_like(out)), "pp")

    want = np.asarray(_shard_map(per_device, _jax_mesh("pp", pp),
                                 (P(), P("pp"), P("pp")), P())(x, w, c))
    for r in range(pp):
        got = world[r]["gpipe"]
        if r == pp - 1:
            _close(got, want)
        else:
            np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("pp,n_micro,v,cap", [
    (2, 1, 1, None), (2, 5, 1, None), (4, 4, 1, None), (4, 9, 1, None),
    (8, 16, 1, None), (1, 3, 2, None), (2, 4, 2, None), (2, 7, 3, None),
    (4, 8, 2, None), (3, 7, 1, None), (4, 9, 3, None), (5, 7, 2, None),
    (4, 16, 1, 4), (2, 6, 2, 1)])
def test_1f1b_tables_equal_jax(pp, n_micro, v, cap):
    from horovod_tpu_torch.parallel import pipeline as port

    from horovod_tpu.parallel import pipeline as ref

    assert port._default_in_flight(pp) == ref._default_in_flight(pp)
    got = port._build_1f1b_schedule(pp, n_micro, v, cap)
    want = ref._build_1f1b_schedule(pp, n_micro, v, cap)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _jax_pipeline(kind, pp, v):
    """The JAX pipeline's own outputs on the same inputs."""
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P
    import jax.numpy as jnp

    from horovod_tpu.parallel.pipeline import pipeline_1f1b

    x, y, w, b, tail = _pipe_inputs(kind, pp, v)
    mesh = _jax_mesh("pp", pp)
    if kind == "plain":
        def per_device(x, y, ws, bs):
            loss, (gw, gb) = pipeline_1f1b(
                lambda p, xb: jnp.tanh(xb @ p[0] + p[1]),
                lambda o, tgt: jnp.mean((o - tgt) ** 2),
                (ws[0], bs[0]), x, y, axis_name="pp")
            return loss, gw[None], gb[None]

        loss, gw, gb = _shard_map(per_device, mesh,
                                  (P(), P(), P("pp"), P("pp")),
                                  (P(), P("pp"), P("pp")))(x, y, w[:pp], b)

        def full_loss(ws, bs):
            total = 0.0
            for m in range(x.shape[0]):
                h = x[m]
                for s in range(pp):
                    h = jnp.tanh(h @ ws[s] + bs[s])
                total = total + jnp.mean((h - y[m]) ** 2)
            return total / x.shape[0]

        oracle = jax.value_and_grad(full_loss, argnums=(0, 1))(w[:pp], b)
        return {"loss": loss, "gw": gw, "gb": gb, "plain_oracle": oracle}
    if kind in ("free", "free_tail"):
        kw = dict(axis_name="pp", loss_collective_free=True)
        if kind == "free_tail":
            kw["loss_params"] = {"s": jnp.asarray(1.3, jnp.float32)}

            def loss_fn(p, o, tgt):
                return p["s"] * jnp.mean((o - tgt) ** 2)
        else:
            def loss_fn(o, tgt):
                return jnp.mean((o - tgt) ** 2)

        def per_device(x, y, ws):
            out = pipeline_1f1b(lambda p, xb: jnp.tanh(xb @ p), loss_fn,
                                ws[0], x, y, **kw)
            extra = (out[2]["s"],) if kind == "free_tail" else ()
            return (out[0], out[1][None]) + extra

        outs = (P(), P("pp")) + ((P(),) if kind == "free_tail" else ())
        res = _shard_map(per_device, mesh, (P(), P(), P("pp")), outs)(
            x, y, w[:pp])
        return {"loss": res[0], "gw": res[1],
                "tail": res[2] if kind == "free_tail" else None}
    n_glob = pp * v
    w_dev = np.stack([[w[c * pp + s] for c in range(v)] if v > 1 else
                      w[s] for s in range(pp)])

    def per_device(x, y, ws, tl):
        loss, grads, gtail, dx = pipeline_1f1b(
            lambda p, xb: jnp.tanh(xb @ p),
            lambda t_, o, tgt: jnp.mean((o @ t_ - tgt) ** 2),
            ws[0], x, y, axis_name="pp", loss_params=tl, return_dx=True,
            virtual_stages=v)
        stage = lax.axis_index("pp")
        dx = lax.psum(jnp.where(stage == 0, dx, jnp.zeros_like(dx)), "pp")
        return loss, grads[None], gtail, dx

    loss, gw, gtail, dx = _shard_map(
        per_device, mesh, (P(), P(), P("pp"), P()),
        (P(), P("pp"), P(), P()))(x, y, w_dev, tail)

    def full_loss(w_all, tl, xin):
        total = 0.0
        for m in range(x.shape[0]):
            h = xin[m]
            for g in range(n_glob):
                h = jnp.tanh(h @ w_all[g])
            total = total + jnp.mean((h @ tl - y[m]) ** 2)
        return total / x.shape[0]

    oracle = jax.value_and_grad(full_loss, argnums=(0, 1, 2))(
        w, tail, x)
    return {"loss": loss, "gw": gw, "gtail": gtail, "dx": dx,
            "oracle": oracle}


@pytest.mark.parametrize("kind,pp,v", PIPE_CASES)
def test_1f1b_matches_jax(hvd, world, kind, pp, v):
    """The port's 1F1B (loss, each stage's grads, the tail's grads, the
    input cotangents) against the JAX pipeline's on the same schedule,
    and, for the tail cases, against autodiff of the composed model."""
    want = _jax_pipeline(kind, pp, v)
    for s in range(pp):
        got = world[s][("pipe", kind, pp, v)]
        _close(got["loss"], want["loss"], msg=f"stage {s} loss")
        _close(got["gw"], np.asarray(want["gw"])[s], rtol=5e-4, atol=1e-5,
               msg=f"stage {s} grads")
        if kind == "plain":
            _close(got["gb"], np.asarray(want["gb"])[s], rtol=5e-4,
                   atol=1e-5)
            ref_loss, (rw, rb) = want["plain_oracle"]
            _close(got["loss"], ref_loss)
            _close(got["gw"], np.asarray(rw)[s], rtol=5e-4, atol=1e-5)
            _close(got["gb"], np.asarray(rb)[s], rtol=5e-4, atol=1e-5)
        if "stats" in got:
            # the stash never holds more than max_in_flight + 1 inputs
            assert got["stats"]["stash_peak"] <= 2 * pp + 2
        if kind.startswith("free"):
            # the declaration changes nothing in the port: bitwise
            assert got["same"]
            if kind == "free_tail":
                _close(got["tail"], want["tail"], rtol=5e-4, atol=1e-5)
        if "oracle" in want:
            ref_loss, (rw, rtail, rx) = want["oracle"]
            _close(got["loss"], ref_loss)
            _close(got["gtail"], rtail, rtol=5e-4, atol=1e-5)
            for c in range(v):
                g = got["gw"] if v == 1 else got["gw"][c]
                _close(g, np.asarray(rw)[c * pp + s], rtol=5e-4, atol=1e-5,
                       msg=f"global stage {c * pp + s}")
            if s == 0:
                _close(got["dx"], rx, rtol=5e-4, atol=1e-5)
            else:
                np.testing.assert_array_equal(got["dx"], 0.0)


def test_1f1b_stash_independent_of_n_micro(world):
    """Growing n_micro 4× leaves the live stash where it was: O(pp)."""
    for s in range(4):
        peaks = world[s]["stash_peaks"]
        assert peaks[8] == peaks[32] <= 2 * 4 + 1, peaks
