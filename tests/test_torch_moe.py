"""The port's expert parallelism against the JAX package's on the CPU:
``traced.quantized_alltoall`` and ``traced.hierarchical_alltoall``, the
switch-MoE ``parallel.moe.moe_ffn`` (the gate, drops, the join mask, a
process set, the two-level wire's exactness, the int8 wire's
straight-through gradient), the composed step threaded with the expert
wire, and the ``Transformer``'s MoE banks (``moe_experts > 0``).

The same seeded numpy inputs go to both sides: the JAX functions under
``shard_map`` on the conftest's 8-device mesh, the port in one gloo
world of 8 CPU processes (``_moe_worker``, once for the module). The
exact wires are held bit for bit (integer-valued fp32, the int32 expert
map); the int8 wire to its contract, as the JAX tests hold it: the block
scales bitwise the JAX quantizer's, every value within one quantum of
the exact exchange, pad slots exact zeros, routing identical across
wires. Stochastic rounding draws Philox here and ``jax.random`` there,
so no int8 value is compared bit for bit with the JAX wire's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

WORLD = 8
STAGES_84 = ([[0, 1, 2, 3], [4, 5, 6, 7]], [[0, 4], [1, 5], [2, 6], [3, 7]])
STAGES_82 = ([[0, 1], [2, 3], [4, 5], [6, 7]],
             [[0, 2, 4, 6], [1, 3, 5, 7]])
MOE_CASES = {
    "oracle8": dict(t=8, seed=5, key=0, kw=dict(capacity_factor=2.0,
                                                wire="fp32")),
    "oracle10": dict(t=10, seed=5, key=0, kw=dict(capacity_factor=2.0,
                                                  wire="fp32")),
    "drops": dict(t=12, seed=6, key=1, kw=dict(capacity_factor=0.5,
                                               wire="fp32")),
    "flat_fp32": dict(t=8, seed=7, key=2, kw=dict(capacity_factor=1.25,
                                                  wire="fp32")),
    "hier_int8": dict(t=8, seed=7, key=2, kw=dict(
        capacity_factor=1.25, wire="int8", hier=STAGES_84, seed=3)),
    "hier_base": dict(t=8, seed=8, key=3, kw=dict(capacity_factor=1.25,
                                                  wire="fp32")),
    "hier_fp32": dict(t=8, seed=8, key=3, kw=dict(
        capacity_factor=1.25, wire="fp32", hier=STAGES_84)),
    "mask_base": dict(t=6, seed=9, key=4, kw=dict(capacity_factor=2.0)),
    "mask": dict(t=6, seed=9, key=4, kw=dict(
        capacity_factor=2.0, mask=[True] * 7 + [False])),
    "pset": dict(t=8, seed=10, key=5, kw=dict(capacity_factor=2.0)),
}


# ------------------------------------------------------ the shared inputs


def _full_params(key):
    """The JAX package's ``init_moe_params`` (d 16, f 32, 16 experts) as
    numpy, saved for the workers."""
    import jax

    from horovod_tpu.parallel.moe import init_moe_params

    p = init_moe_params(jax.random.PRNGKey(key), 16, 32, 16, 16)
    return {k: np.asarray(v) for k, v in p._asdict().items()}


def _moe_x(case):
    c = MOE_CASES[case]
    rng = np.random.default_rng(c["seed"])
    return rng.normal(size=(WORLD, c["t"], 16)).astype(np.float32)


def _wire_x(which):
    if which == "pad":
        x = np.random.default_rng(0).normal(size=(8, 8, 4, 64)).astype(
            np.float32)
        x[:, :, 3, :] = 0.0  # an empty (dropped or pad) dispatch slot
        return x
    if which == "groups":
        return np.random.default_rng(1).normal(size=(8, 2, 3, 32)).astype(
            np.float32)
    if which == "wide":
        return np.random.default_rng(12).normal(size=(8, 8, 2, 64)).astype(
            np.float32)
    if which == "int":
        return np.random.default_rng(2).integers(
            -50, 51, size=(8, 8, 4, 16)).astype(np.float32)
    if which == "map":
        return np.random.default_rng(3).integers(
            -1, 7, size=(8, 8, 4, 1)).astype(np.int32)
    return np.random.default_rng(4).normal(size=(8, 8, 4, 64)).astype(
        np.float32)


def _moe_params(path, rank, e_local):
    from horovod_tpu_torch.parallel.moe import MoEParams

    full = np.load(path)
    sl = slice(rank * e_local, (rank + 1) * e_local)
    return MoEParams(
        router=torch.from_numpy(full["router"]),
        **{k: torch.from_numpy(full[k][sl]).clone()
           for k in ("w1", "b1", "w2", "b2")})


# ---------------------------------------------------------- the port world


def _moe_worker(rank, n, outdir):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import traced
    from horovod_tpu_torch.parallel.moe import moe_ffn

    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {}

    def mine(which):
        return torch.from_numpy(_wire_x(which)[rank])

    flat = {w: traced._all_to_all(mine(w), dist.group.WORLD)
            for w in ("pad", "int", "map", "normal")}
    out["flat"] = flat
    out["q_pad"] = traced.quantized_alltoall(mine("pad"), seed=1,
                                             block_size=32)
    out["q_groups"] = traced.quantized_alltoall(
        mine("groups"), seed=2, block_size=16, groups=STAGES_84[1])
    out["q_wide"] = [traced.quantized_alltoall(mine("wide"), seed=4,
                                               block_size=bs)
                     for bs in (512, 64)]
    x = mine("pad").reshape(-1, 64)
    out["scales"] = traced._stochastic_round_blocks(x, 32, 1, 0)[1]
    for name, stages in (("84", STAGES_84), ("82", STAGES_82)):
        out[f"hier_int_{name}"] = traced.hierarchical_alltoall(
            mine("int"), stages=stages)
    out["hier_map"] = traced.hierarchical_alltoall(
        mine("map"), stages=STAGES_84, intra_wire="bf16", inter_wire="int8")
    for wire in ("int8", "bf16"):
        out[f"hier_lossy_{wire}"] = traced.hierarchical_alltoall(
            mine("normal"), stages=STAGES_84, inter_wire=wire, seed=5,
            block_size=32)

    # moe_ffn, expert-stacked params cut by rank (2 local experts of 16)
    pset = hvd.add_process_set([0, 2, 4, 5])
    for case, c in MOE_CASES.items():
        params = _moe_params(Path(outdir) / f"params{c['key']}.npz", rank, 2)
        x = torch.from_numpy(_moe_x(case)[rank])
        kw = dict(c["kw"])
        if case == "pset":
            kw["process_set"] = pset
        o, st = moe_ffn(params, x, return_stats=True, **kw)
        out[("moe", case)] = [o, st.expert_tokens, st.dropped, st.total]
    hvd.remove_process_set(pset)

    # the int8 wire differentiates straight through
    params = _moe_params(Path(outdir) / "params7.npz", rank, 2)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(n, 8, 16)).astype(np.float32)[rank])
    for wire, hier in (("fp32", None), ("int8", STAGES_84)):
        xx = x.clone().requires_grad_()
        o = moe_ffn(params, xx, capacity_factor=2.0, wire=wire, hier=hier,
                    seed=2)
        (o * o).sum().backward()
        out[("grad", wire)] = xx.grad

    # the composed step threaded with the expert wire (dp 2 × ep 4)
    from horovod_tpu_torch.parallel import MeshSpec
    from horovod_tpu_torch.parallel import transformer as ptf

    mesh = MeshSpec(dp=2, ep=4).build()
    for wire in ("fp32", "int8"):
        cfg = ptf.ParallelTransformerConfig(
            vocab_size=64, num_layers=2, d_model=32, num_heads=2, d_ff=64,
            max_len=32, n_experts=4, n_microbatches=1, moe_wire=wire,
            moe_hier=([[0, 1], [2, 3]], [[0, 2], [1, 3]]) if wire == "int8"
            else None)
        g = torch.Generator().manual_seed(0)
        params = ptf.make_sharded_params(cfg, mesh, g, device="cpu")
        step = ptf.make_train_step(cfg, mesh, device="cpu")
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 64, size=(8, 32))
        labs = rng.integers(0, 64, size=(8, 32))
        losses = []
        for _ in range(4):
            params, loss = step(params, toks, labs)
            losses.append(float(loss))
        out[("threading", wire)] = losses
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    for key in sorted({c["key"] for c in MOE_CASES.values()} | {7}):
        np.savez(tmp / f"params{key}.npz", **_full_params(key))
    return _run(tmp, WORLD, Path(__file__), "_moe_worker", 240, None)


# ------------------------------------------------------------- the JAX side


def _sm(fn, ins, outs):
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("ep",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=ins,
                                 out_specs=outs, check_vma=False))


def _flat_a2a(x):
    import jax
    from jax.sharding import PartitionSpec as P

    return np.asarray(_sm(
        lambda v: jax.lax.all_to_all(v[0], "ep", 0, 0, tiled=True)[None],
        P("ep"), P("ep"))(x))


def _jax_moe(case, stats=True, key=None):
    import jax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.parallel.moe import MoEParams, init_moe_params, moe_ffn

    c = MOE_CASES[case]
    params = init_moe_params(jax.random.PRNGKey(c["key"]), 16, 32, 16, 16)
    spec = MoEParams(router=P(), w1=P("ep"), b1=P("ep"), w2=P("ep"),
                     b2=P("ep"))

    def body(p, v):
        o, s = moe_ffn(p, v[0], return_stats=True, **c["kw"])
        return o[None], s

    o, s = _sm(body, (spec, P("ep")), (P("ep"), P()))(params,
                                                      _moe_x(case))
    return np.asarray(o), s


def _port(world, key):
    return np.stack([np.asarray(o[key]) for o in world])


# ------------------------------------------------------------------ tests


class TestQuantizedAlltoall:
    def test_pads_exact_and_within_a_quantum(self, world):
        x = _wire_x("pad")
        q = _port(world, "q_pad")
        f = _flat_a2a_np(x)
        np.testing.assert_array_equal(q[:, :, 3, :], 0.0)
        # one quantum of each received block: its sender's absmax / 127
        blocks = np.abs(x).reshape(8, 8, 4, 2, 32).max(-1)
        quantum = _flat_a2a_np(blocks[..., None])[..., 0] / 127.0
        err = np.abs(q - f).reshape(8, 8, 4, 2, 32).max(-1)
        assert (err <= quantum * (1 + 1e-6)).all()
        assert abs((q - f).mean()) < 2.5 * np.abs(f).max() / 127.0 / 20

    def test_scales_bitwise_jax(self, hvd, world):
        import jax

        from horovod_tpu.ops import traced as jtraced

        x = _wire_x("pad")
        for r, o in enumerate(world):
            xr = x[r].reshape(-1, 64)
            _, want = jax.jit(
                lambda v: jtraced._stochastic_round_blocks(
                    v, 32, jax.random.PRNGKey(0)))(xr)
            np.testing.assert_array_equal(np.asarray(o["scales"]),
                                          np.asarray(want))

    def test_groups_restrict_exchange(self, hvd, world):
        import jax
        from jax.sharding import PartitionSpec as P

        x = _wire_x("groups")
        f = np.asarray(_sm(lambda v: jax.lax.all_to_all(
            v[0], "ep", 0, 0, tiled=True,
            axis_index_groups=STAGES_84[1])[None], P("ep"), P("ep"))(x))
        q = _port(world, "q_groups")
        assert np.abs(q - f).max() <= 2.5 * np.abs(f).max() / 127.0

    def test_block_wider_than_row_clamps(self, world):
        for o in world:
            np.testing.assert_array_equal(np.asarray(o["q_wide"][0]),
                                          np.asarray(o["q_wide"][1]))

    def test_shape_validation(self):
        from horovod_tpu_torch.ops import traced

        with pytest.raises(ValueError, match="slots"):
            traced.quantized_alltoall_in(torch.zeros(4, 8), None, 4)


def _flat_a2a_np(x):
    """The flat alltoall of rank-major ``[n, n, ...]`` on the host."""
    return np.swapaxes(x, 0, 1).copy()


class TestHierarchicalAlltoall:
    @pytest.mark.parametrize("name", ["84", "82"])
    def test_fp32_bitexact_vs_flat_and_jax(self, hvd, world, name):
        from jax.sharding import PartitionSpec as P

        from horovod_tpu.ops import traced as jtraced

        stages = STAGES_84 if name == "84" else STAGES_82
        x = _wire_x("int")
        got = _port(world, f"hier_int_{name}")
        np.testing.assert_array_equal(got, _port_flat(world, "int"))
        want = np.asarray(_sm(lambda v: jtraced.hierarchical_alltoall(
            v[0], axis_name="ep", stages=stages)[None], P("ep"), P("ep"))(x))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _flat_a2a(x))

    def test_int32_map_bitexact(self, world):
        np.testing.assert_array_equal(_port(world, "hier_map"),
                                      _port_flat(world, "map"))

    @pytest.mark.parametrize("wire", ["int8", "bf16"])
    def test_lossy_inter_spares_intra_blocks(self, world, wire):
        out = _port(world, f"hier_lossy_{wire}")
        f = _port_flat(world, "normal")
        for r in range(8):
            sl = slice((r // 4) * 4, (r // 4 + 1) * 4)
            np.testing.assert_array_equal(out[r][sl], f[r][sl])
        bound = (2.5 * np.abs(f).max() / 127.0 if wire == "int8"
                 else 0.01 * np.abs(f).max())
        assert np.abs(out - f).max() <= bound

    def test_validation(self):
        from horovod_tpu_torch.ops import traced

        with pytest.raises(ValueError, match="stages"):
            traced.hierarchical_alltoall(torch.zeros(8, 4, 8))


def _port_flat(world, which):
    return np.stack([np.asarray(o["flat"][which]) for o in world])


def _oracle(case, member_ranks=None, live=None):
    """The JAX test's host oracle (tests/test_moe_wire.py)."""
    import test_moe_wire

    from horovod_tpu.parallel.moe import MoEParams

    c = MOE_CASES[case]
    p = {k: v for k, v in _full_params(c["key"]).items()}
    return test_moe_wire._oracle(MoEParams(**p), _moe_x(case),
                                 c["kw"]["capacity_factor"], member_ranks,
                                 live)


def _moe(world, case):
    rows = [o[("moe", case)] for o in world]
    return (np.stack([np.asarray(r[0]) for r in rows]),
            [(np.asarray(r[1]), float(r[2]), float(r[3])) for r in rows])


class TestMoEFFN:
    @pytest.mark.parametrize("case", ["oracle8", "oracle10"])
    def test_host_oracle_gate_and_output(self, hvd, world, case):
        out, stats = _moe(world, case)
        want, hist, dropped = _oracle(case)
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-5)
        jout, jst = _jax_moe(case)
        np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
        t = MOE_CASES[case]["t"]
        for expert_tokens, drop, total in stats:
            np.testing.assert_array_equal(expert_tokens, hist)
            np.testing.assert_array_equal(expert_tokens,
                                          np.asarray(jst.expert_tokens))
            assert drop == dropped and total == 8 * t

    def test_capacity_overflow_drop_parity(self, world):
        out, stats = _moe(world, "drops")
        want, hist, dropped = _oracle("drops")
        assert dropped > 0
        np.testing.assert_array_equal(out[np.all(want == 0.0, axis=2)], 0.0)
        for expert_tokens, drop, _ in stats:
            assert drop == dropped
            np.testing.assert_array_equal(expert_tokens, hist)

    def test_routing_identical_across_wires(self, hvd, world):
        base, st0 = _moe(world, "flat_fp32")
        out8, st8 = _moe(world, "hier_int8")
        _, jst = _jax_moe("hier_int8")
        for (h0, d0, _), (h8, d8, _) in zip(st0, st8):
            np.testing.assert_array_equal(h0, h8)
            np.testing.assert_array_equal(h8, np.asarray(jst.expert_tokens))
            assert d0 == d8 == float(jst.dropped)
        scale = np.abs(base).max()
        assert np.abs(out8 - base).max() <= 0.15 * scale
        assert np.abs(out8 - base).mean() <= 0.01 * scale

    def test_hier_fp32_bitexact_vs_flat(self, world):
        a, _ = _moe(world, "hier_base")
        b, _ = _moe(world, "hier_fp32")
        np.testing.assert_array_equal(a, b)

    def test_join_mask(self, world):
        base, _ = _moe(world, "mask_base")
        out, stats = _moe(world, "mask")
        np.testing.assert_array_equal(out[7], 0.0)
        np.testing.assert_array_equal(out[:7], base[:7])
        assert all(total == 7 * 6 for _, _, total in stats)

    def test_process_set(self, world):
        out, stats = _moe(world, "pset")
        for r in (1, 3, 6, 7):
            np.testing.assert_array_equal(out[r], 0.0)
        want, hist, _ = _oracle("pset", member_ranks=[0, 2, 4, 5])
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-5)
        for expert_tokens, _, _ in stats:
            np.testing.assert_array_equal(expert_tokens, hist)
            used = np.nonzero(expert_tokens)[0]
            assert set(used // 2) <= {0, 2, 4, 5}

    def test_int8_wire_differentiates_straight_through(self, hvd, world):
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from horovod_tpu.parallel.moe import MoEParams, init_moe_params
        from horovod_tpu.parallel.moe import moe_ffn as jmoe

        g_fp = _port(world, ("grad", "fp32"))
        g_q = _port(world, ("grad", "int8"))
        assert np.isfinite(g_q).all() and np.abs(g_q).max() > 0
        scale = np.abs(g_fp).max()
        assert np.abs(g_q - g_fp).max() <= 0.25 * scale
        # the fp32 wire's gradient is the JAX function's
        params = init_moe_params(jax.random.PRNGKey(7), 16, 32, 16, 16)
        x = np.random.default_rng(11).normal(size=(8, 8, 16)).astype(
            np.float32)

        def body(p, v):
            def loss(vv):
                o = jmoe(p, vv, capacity_factor=2.0, wire="fp32", seed=2)
                return jnp.sum(o * o)

            return jax.grad(loss)(v[0])[None]

        spec = MoEParams(router=P(), w1=P("ep"), b1=P("ep"), w2=P("ep"),
                         b2=P("ep"))
        want = np.asarray(_sm(body, (spec, P("ep")), P("ep"))(params, x))
        np.testing.assert_allclose(g_fp, want, rtol=5e-4, atol=1e-5)

    def test_wire_validation(self):
        from horovod_tpu_torch.parallel import moe

        with pytest.raises(NotImplementedError, match="A12"):
            moe._resolve_wire("auto", None)
        with pytest.raises(ValueError, match="fp32/bf16/int8"):
            moe._resolve_wire("fp16", None)
        with pytest.raises(ValueError, match="intra_wire"):
            moe._resolve_wire("int8", "int8")


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_train_step_with_expert_wire(world, wire):
    """The composed step on dp 2 × ep 4 with the expert wire (int8 on a
    two-level split of ep): finite, falling, every rank the same loss."""
    losses = [o[("threading", wire)] for o in world]
    assert all(ls == losses[0] for ls in losses)
    assert np.isfinite(losses[0]).all() and losses[0][-1] < losses[0][0]


# ------------------------------------------------- the Transformer's banks


def _moe_models(dtype="float32"):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import (
        Transformer as JTransformer,
        TransformerConfig as JConfig,
    )
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )

    kw = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
              max_len=64, causal=True, flash_attention=False, moe_experts=4)
    jmodel = JTransformer(JConfig(dtype=jnp.float32, **kw))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        np.zeros((1, 4), np.int32)))
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params, cfg))
    return jmodel, params, model


def test_transformer_moe_forward_matches_flax():
    jmodel, params, model = _moe_models()
    toks = np.random.default_rng(0).integers(0, 64, size=(2, 12))
    want = np.asarray(jmodel.apply(params, toks.astype(np.int32),
                                   train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), train=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert "blocks.0.moe.w1" in model.state_dict()
    assert "blocks.0.fc1.kernel" not in model.state_dict()


def test_transformer_moe_cached_decode_matches_full():
    from horovod_tpu_torch.models.transformer import init_cache

    _, _, model = _moe_models()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, size=(2, 10)))
    with torch.no_grad():
        full = model(toks, train=False)
        cache = init_cache(model.cfg, 2, device="cpu")
        steps = [model(toks[:, :6], cache=cache, cache_index=[0, 0])]
        for i in range(6, 10):
            steps.append(model(toks[:, i:i + 1], cache=cache,
                               cache_index=[i, i]))
    got = torch.cat(steps, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_moe_ffn_emits_cfg_dtype():
    from horovod_tpu_torch.models.transformer import MoEFFN, TransformerConfig

    cfg = TransformerConfig(vocab_size=32, num_layers=1, d_model=16,
                            num_heads=2, d_ff=32, max_len=16,
                            dtype=torch.bfloat16, moe_experts=4)
    out = MoEFFN(cfg, device="cpu")(torch.zeros((1, 4, 16)))
    assert out.dtype == torch.bfloat16
