"""The collective-program audit of the port (``horovod_tpu_torch/
analysis/fx_parse.py`` and ``rules.py``), case for case against the
reference's ``TestParser`` and ``TestRules`` (tests/test_analysis.py):
the same program, two independent world all_reduces, a scalar
inter-group all_reduce fed by one of them, and an int8 all_to_all on the
intra groups over a world of 8, is built twice, as FX graphs (one a
rank, merged) and as recorded eager calls (one list a rank), and each
rule gives the same findings by name and count as the reference's over
its hand-built module. The recorded calls have no def-use edges, so the
rule that needs them raises there. Also: the JAX package's parser and
rules on its own text agree with the port's counts, a real FX program
(``make_fx`` of a functional all_reduce in a world of one), kernel
counting, and the in-place pool rule on a serving engine with a breaker
that moves the pool."""


import pytest
import torch
import torch.distributed as dist
import torch.fx as fx

from horovod_tpu_torch.analysis import fx_parse, rules
from horovod_tpu_torch.testing.recorder import Call

WORLD_G = ((0, 1, 2, 3, 4, 5, 6, 7),)
INTRA_G = ((0, 1, 2, 3), (4, 5, 6, 7))
INTER_G = ((0, 4), (1, 5), (2, 6), (3, 7))
F = torch.ops._c10d_functional


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _rank_graph(rank):
    """One rank's program, as an FX graph with the values' metadata."""
    g = fx.Graph()

    def node(target, args, val, kwargs=None):
        n = g.call_function(target, args, kwargs or {})
        n.meta["val"] = val
        return n

    a0 = g.placeholder("arg0")
    a0.meta["val"] = _meta((1, 16))
    a1 = g.placeholder("arg1")
    a1.meta["val"] = _meta((1, 16))
    x0 = node(F.all_reduce.default, (a0, "sum", "world"), _meta((1, 16)))
    w0 = node(F.wait_tensor.default, (x0,), _meta((1, 16)))
    x1 = node(F.all_reduce.default, (a0, "sum", "world"), _meta((1, 16)))
    w1 = node(F.wait_tensor.default, (x1,), _meta((1, 16)))
    s = node(torch.ops.aten.sum.default, (w1,), _meta(()))
    x2 = node(F.all_reduce.default, (s, "sum", f"inter{rank % 4}"),
              _meta(()))
    node(F.wait_tensor.default, (x2,), _meta(()))
    q = node(torch.ops.aten._to_copy.default, (a0,), _meta((1, 16), torch.int8),
             {"dtype": torch.int8})
    x3 = node(F.all_to_all_single.default,
              (q, [4, 4, 4, 4], [4, 4, 4, 4], f"intra{rank // 4}"),
              _meta((1, 16), torch.int8))
    node(F.wait_tensor.default, (x3,), _meta((1, 16), torch.int8))
    out = node(torch.ops.aten.add.Tensor, (w0, w1), _meta((1, 16)))
    g.output(out)
    return fx.GraphModule(torch.nn.Module(), g)


GROUPS = {"world": list(range(8)),
          **{f"inter{i}": [i, i + 4] for i in range(4)},
          "intra0": [0, 1, 2, 3], "intra1": [4, 5, 6, 7]}


def _fx_program(extra_scalar=False):
    progs = []
    for r in range(8):
        gm = _rank_graph(r)
        if extra_scalar:
            _add_scalar_allreduce(gm)
        progs.append(fx_parse.parse_fx(gm, groups=GROUPS, world=8))
    return fx_parse.merge_ranks(progs)


def _add_scalar_allreduce(gm):
    g = gm.graph
    out = next(n for n in g.nodes if n.op == "output")
    a0 = next(n for n in g.nodes if n.op == "placeholder")
    with g.inserting_before(out):
        s = g.call_function(torch.ops.aten.sum.default, (a0,))
        s.meta["val"] = _meta(())
        x = g.call_function(F.all_reduce.default, (s, "sum", "world"))
        x.meta["val"] = _meta(())
    gm.recompile()


def _calls(extra_scalar=False):
    per_rank = []
    for r in range(8):
        calls = [
            Call("all_reduce", WORLD_G[0], 64, "torch.float32", (1, 16)),
            Call("all_reduce", WORLD_G[0], 64, "torch.float32", (1, 16)),
            Call("all_reduce", (r % 4, r % 4 + 4), 4, "torch.float32", ()),
            Call("all_to_all_single", INTRA_G[r // 4], 16, "torch.int8",
                 (1, 16)),
            Call("broadcast", WORLD_G[0], 64, "torch.float32", (1, 16)),
        ]
        if extra_scalar:
            calls.append(Call("all_reduce", WORLD_G[0], 4, "torch.float32",
                              ()))
        per_rank.append(calls)
    return fx_parse.parse_calls(per_rank)


SOURCES = {"fx": _fx_program, "calls": _calls}


@pytest.fixture(params=sorted(SOURCES))
def source(request):
    return request.param


class TestParser:
    def test_collectives_groups_types(self, source):
        g = SOURCES[source]()
        assert g.num_partitions == 8
        assert g.counts() == {
            "all_reduce": 3, "reduce_scatter": 0, "all_gather": 0,
            "all_to_all": 1, "collective_permute": 0,
        }
        ars = g.collectives("all_reduce")
        assert ars[0].replica_groups == WORLD_G
        assert ars[2].replica_groups == INTER_G
        assert ars[0].operand_types[0].shape == (1, 16)
        assert ars[0].operand_types[0].dtype == "f32"
        assert ars[0].operand_types[0].nbytes == 64
        assert ars[2].is_scalar()
        assert not ars[0].is_scalar()
        assert ars[0].reduction_dtype == "f32"
        a2a = g.collectives("all_to_all")[0]
        assert a2a.dtypes == ("i8",)
        assert a2a.replica_groups == INTRA_G
        assert g.group_sizes("all_to_all") == [4]

    def test_def_use_edges(self, source):
        g = SOURCES[source]()
        if source == "calls":
            with pytest.raises(ValueError, match="def-use"):
                g.dependent_pairs("all_reduce")
            return
        pairs = g.dependent_pairs("all_reduce")
        assert len(pairs) == 1
        dep, on = pairs[0]
        ars = g.collectives("all_reduce")
        assert (dep.sid, on.sid) == (ars[2].sid, ars[1].sid)
        assert not g.independent("all_reduce")
        assert g.independent("all_to_all")

    def test_no_donation(self, source):
        """torch donates nothing: every FX input is undonated (the
        reference's donated ``arg0`` has no counterpart)."""
        g = SOURCES[source]()
        assert not g.donated_args()
        if source == "fx":
            assert [a.donated for a in g.args()] == [False, False]
            assert g.args()[0].type.shape == (1, 16)

    def test_world_spanning(self, source):
        ars = SOURCES[source]().collectives("all_reduce")
        assert ars[0].spans(8)
        assert not ars[2].spans(8)

    def test_snippet_and_line_anchor(self, source):
        g = SOURCES[source]()
        c = g.collectives("all_to_all")[0]
        assert "all_to_all" in c.snippet and len(c.snippet) <= 240
        if source == "fx":
            assert c.sid in c.snippet

    def test_the_references_parser_agrees(self, source):
        """The JAX package's parser over its own module counts what the
        port's does over the same program."""
        from horovod_tpu import analysis as janalysis
        import test_analysis

        ref = janalysis.parse_module(test_analysis._MODULE)
        g = SOURCES[source]()
        assert g.counts() == ref.counts()
        assert g.replica_groups() == ref.replica_groups()
        assert [c.is_scalar() for c in g.collectives()] == [
            c.is_scalar() for c in ref.collectives()]


class TestRules:
    def test_collective_count_int_and_range(self, source):
        g = SOURCES[source]()
        assert not rules.CollectiveCount("all_reduce", 3).check(g)
        assert rules.CollectiveCount("all_reduce", 2).check(g)
        assert not rules.CollectiveCount("all_to_all", (1, 2)).check(g)
        assert rules.CollectiveCount("all_to_all", (2, 9)).check(g)

    def test_def_use_rule_names_the_pair(self, source):
        g = SOURCES[source]()
        rule = rules.NoInterCollectiveDefUse("all_reduce")
        if source == "calls":
            with pytest.raises(ValueError, match="def-use"):
                rule.check(g)
            return
        f = rule.check(g)
        ars = g.collectives("all_reduce")
        assert len(f) == 1
        assert ars[2].sid in f[0].message and ars[1].sid in f[0].message
        assert "all_reduce" in f[0].snippet

    def test_replica_group_structure(self, source):
        g = SOURCES[source]()
        assert not rules.ReplicaGroupStructure(
            "all_to_all", groups=INTRA_G).check(g)
        assert rules.ReplicaGroupStructure(
            "all_to_all", groups=INTER_G).check(g)
        assert not rules.ReplicaGroupStructure(
            "all_to_all", forbid_world_spanning=True).check(g)
        assert rules.ReplicaGroupStructure(
            "all_reduce", forbid_world_spanning=True).check(g)
        assert rules.ReplicaGroupStructure(
            "reduce_scatter", require_present=True).check(g)
        assert not rules.ReplicaGroupStructure(
            "all_to_all", groups_any_of=(INTRA_G, INTER_G)).check(g)
        assert rules.ReplicaGroupStructure(
            "all_to_all", groups_any_of=(INTER_G,)).check(g)

    def test_wire_dtype_placement(self, source):
        g = SOURCES[source]()
        f = rules.WireDtype(inter_groups=INTER_G,
                            intra_groups=INTRA_G).check(g)
        assert len(f) == 1 and "INTRA hop" in f[0].message
        assert rules.WireDtype(int8_allowed=False).check(g)

    def test_guard_overhead(self, source):
        base = SOURCES[source]()
        assert not rules.GuardOverhead(base).check(SOURCES[source]())
        extra = SOURCES[source](extra_scalar=True)
        assert rules.GuardOverhead(base).check(extra)
        assert not rules.GuardOverhead(
            base, extra_scalar_allreduces=1).check(extra)

    def test_compile_budget(self):
        r = rules.CompileBudget(decode_compiles=1, prefills=(2, 4))
        assert not r.check({"decode_compiles": 1, "prefills": 3})
        assert r.check({"decode_compiles": 2, "prefills": 3})
        assert r.check({"prefills": 3})

    def test_expect_raises_with_snippet(self):
        with pytest.raises(AssertionError, match="all_reduce"):
            rules.expect(_fx_program(),
                         rules.NoInterCollectiveDefUse("all_reduce"))

    def test_report_json_shape(self, source):
        rep = rules.check_program(SOURCES[source](),
                                  [rules.CollectiveCount("all_reduce", 2)])
        d = rep.to_dict()
        assert d["ok"] is False
        assert d["rules_checked"] == ["CollectiveCount[all_reduce==2]"]
        assert d["violations"][0]["rule"].startswith("CollectiveCount")

    def test_findings_match_the_reference(self, source):
        """Every rule of the catalog ported here, over the reference's
        module with its rules and over the port's program with the
        port's: the same findings by rule name and count."""
        from horovod_tpu import analysis as janalysis
        from horovod_tpu.analysis import rules as jrules
        import test_analysis

        ref = janalysis.parse_module(test_analysis._MODULE)
        g = SOURCES[source]()
        cases = [
            ("CollectiveCount", ("all_reduce", 2), {}),
            ("CollectiveCount", ("all_to_all", (1, 2)), {}),
            ("ReplicaGroupStructure", ("all_reduce",),
             {"forbid_world_spanning": True}),
            ("ReplicaGroupStructure", ("reduce_scatter",),
             {"require_present": True}),
            ("ReplicaGroupStructure", ("all_to_all",), {"groups": INTER_G}),
            ("WireDtype", (), {"inter_groups": INTER_G,
                               "intra_groups": INTRA_G}),
            ("WireDtype", (), {"int8_allowed": False}),
            ("TransientBuffer", ((1, 16),), {"forbid": True}),
            ("TransientBuffer", ((9, 9),), {"forbid": False}),
        ]
        if source == "fx":
            cases.append(("NoInterCollectiveDefUse", ("all_reduce",), {}))
        for name, args, kw in cases:
            want = getattr(jrules, name)(*args, **kw).check(ref)
            got = getattr(rules, name)(*args, **kw).check(g)
            if name == "TransientBuffer" and source == "calls":
                continue  # recorded calls carry no intermediate values
            assert [f.rule for f in got] == [f.rule for f in want], name


def test_real_fx_program_in_a_world_of_one(tmp_path):
    """``make_fx`` of a functional all_reduce in a gloo world of one
    parses with its group's ranks, dtype and shape."""
    from torch.distributed import _functional_collectives as funcol
    from torch.fx.experimental.proxy_tensor import make_fx

    mine = not dist.is_initialized()
    if mine:
        store = dist.FileStore(str(tmp_path / "store"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        gm = make_fx(lambda x: funcol.all_reduce(x * 2, "sum",
                                                 dist.group.WORLD))(
            torch.ones(8, 16))
        g = fx_parse.parse_fx(gm)
    finally:
        if mine:
            dist.destroy_process_group()
    assert g.count("all_reduce") == 1
    c = g.collectives("all_reduce")[0]
    assert c.replica_groups == ((0,),)
    assert c.operand_types[0].shape == (8, 16)
    assert c.reduction_dtype == "f32"
    assert g.node_count() > 0 and g.has_edges


def test_kernel_count_over_custom_operators():
    """Each ``hvd_torch`` operator is one node: the LM head's operator in
    a traced forward, counted by name."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from horovod_tpu_torch.ops.fused_xent import mixed_linear

    x, k, b, b8 = torch.ones(4, 8), torch.ones(8, 6), torch.zeros(6), \
        torch.zeros(8)
    gm = make_fx(lambda x: mixed_linear(mixed_linear(x, k, b, None),
                                        k.t(), b8, None))(x)
    g = fx_parse.parse_fx(gm, world=1)
    assert g.kernel_counts() == {"mixed_linear": 2}
    assert not rules.KernelCount("mixed_linear", 2).check(g)
    f = rules.KernelCount("mixed_linear", (3, 4)).check(g)
    assert len(f) == 1 and "mixed_linear" in f[0].message


def _engine():
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serving import InferenceEngine

    model = Transformer(TransformerConfig.tiny(), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return InferenceEngine(model, None, slots=2, max_len=32, device="cpu")


def test_pool_written_in_place():
    eng = _engine()
    probe = rules.probe_pool(eng, [1, 2, 3, 4, 5])
    assert [name for name, _ in probe.pointers] == [
        "built", "prefill", "decode", "replay"]
    assert not rules.PoolWrittenInPlace().check(probe)


def test_pool_written_in_place_sees_a_moved_pool(monkeypatch):
    """The breaker: a decode step that writes a copy of the pool and
    rebinds it (what an undonated carry is to the JAX engine)."""
    eng = _engine()
    body = eng._decode_body

    def copying(head=True):
        out = body(head)
        for layer in eng.manager.full_cache:
            for name in layer:
                layer[name] = layer[name].clone()
        return out

    monkeypatch.setattr(eng, "_decode_body", copying)
    f = rules.PoolWrittenInPlace().check(
        rules.probe_pool(eng, [1, 2, 3], program=False))
    assert f and "moved" in f[0].message
