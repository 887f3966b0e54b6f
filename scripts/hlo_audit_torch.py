#!/usr/bin/env python
"""hlo_audit_torch: the collective-program invariant catalog over the
port's roster, the counterpart of ``scripts/hlo_audit.py``.

Every structural claim the port's collective and serving planes rest on
(N independent per-bucket collectives, two-level routing with int8 on
the inter hop only, the guard's overhead, the pool written in place,
the engine's capture counts) is checked as a rule set
(``horovod_tpu_torch/analysis/rules.py``) over programs of the port, in
one gloo world of 4 processes on the CPU, 2 nodes of 2
(``HOROVOD_INTRA_SIZE=2``). A program is one of:

* the FX graphs of a compiled step (``torch.compile(fullgraph=True)`` of
  ``ops/traced.py``'s functions, the forward graph AOTAutograd makes of
  it), one a rank, merged into the world's replica groups
  (``analysis/fx_parse.py``);
* the eager calls ``testing/recorder.py`` records of a fused dispatch
  (the optimizers' steps), one list a rank: no def-use edges, so the
  independence rule is not run on them (``--list`` names those gaps);
* a serving engine's stats and pool probe (rank 0 only).

Nonzero exit on any violated invariant, with the line ``invariant
violation(s) found``; the JSON report is the artifact.

Usage:
    python scripts/hlo_audit_torch.py [--json out.json] [--only NAME]
        [--break MODE] [--list]

``--break MODE`` audits a deliberately broken program instead
(``int8-intra``: int8 on an intra-hop group; ``serialized-buckets``:
one bucket's exchange fed by another's; ``monolithic-alltoall``: a
world-spanning alltoall; ``undonated-carry``: a decode step that copies
the KV pool instead of writing it in place), so that the gate proves the
auditor fails when it should.

World-4 values where the reference's depend on its world of 8: INTRA is
``((0, 1), (2, 3))``, INTER ``((0, 2), (1, 3))``; counts that depend on
the bucket count alone (3) are the reference's. On the CPU the serving
engine captures no CUDA graph, so its ``decode_compiles`` is 0 where the
reference's is 1 (``chip_smoke.py`` phase 24 (e) checks 1 on the card).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORLD = 4
LOCAL = 2
INTRA = ((0, 1), (2, 3))
INTER = ((0, 2), (1, 3))
WORLD_GROUP = (tuple(range(WORLD)),)

# reference entries without a counterpart here, or rules of an entry that
# do not apply to its source yet, each with its reason
MISSING = {
    "serve_warm_start": "missing: the engine's graphs are CUDA graphs, "
    "which hold the capturing process's addresses and cannot be "
    "persisted (common/exe_cache.py's decision); only Inductor's "
    "artifacts persist, which tests/test_torch_exe_cache.py audits",
    "zero2 NoInterCollectiveDefUse[reduce_scatter]": "missing: ZeRO's "
    "legs run eagerly, so the program is the recorded calls, which have "
    "no def-use edges; a compiled ZeRO step (ROADMAP A3) would give them",
    "zero3 NoInterCollectiveDefUse[all_gather]": "missing: as zero2's",
    "local_sgd_phase NoInterCollectiveDefUse[all_reduce]": "missing: "
    "local SGD's local phase runs eagerly (recorded calls, no edges)",
    "sharded serving roles": "missing: a sharded prefill or decode "
    "worker waits for A15's 4-card cell (the JAX roster has no entry)",
}


# ------------------------------------------------------------ the world


class World:
    """This rank's handle: its rank, and the merge of every rank's
    program onto rank 0."""

    def __init__(self, rank):
        self.rank = rank

    def merge_fx(self, program):
        import torch.distributed as dist

        from horovod_tpu_torch.analysis import fx_parse

        progs = [None] * WORLD
        dist.all_gather_object(progs, _portable(program))
        return fx_parse.merge_ranks(progs) if self.rank == 0 else None

    def merge_calls(self, calls):
        import torch.distributed as dist

        from horovod_tpu_torch.analysis import fx_parse

        per_rank = [None] * WORLD
        dist.all_gather_object(per_rank, [tuple(c) for c in calls])
        if self.rank:
            return None
        from horovod_tpu_torch.testing.recorder import Call

        return fx_parse.parse_calls([[Call(*c) for c in calls]
                                     for calls in per_rank])


def _portable(program):
    """A ProgramGraph without its text (it pickles; the text can be
    large)."""
    program.text = ""
    return program


def _compiled(fn, *args):
    """The forward FX graph of ``torch.compile(fn, fullgraph=True)`` on
    ``args``, through AOTAutograd, as this rank's program."""
    import torch

    from horovod_tpu_torch.analysis import fx_parse

    kept = []

    def backend(gm, example_inputs):
        kept.append(fx_parse.aot_graphs(gm, example_inputs)["forward"])
        return gm.forward

    torch._dynamo.reset()
    torch.compile(fn, fullgraph=True, backend=backend)(*args)
    return fx_parse.parse_fx(kept, world=WORLD)


def _rows(seed, *shape):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _stages():
    from horovod_tpu_torch.common import topology

    return topology.hierarchy_stages(mode="on")


def _int8_count(g):
    return {"int8_collectives": sum(
        1 for c in g.collectives()
        if any(t.dtype in ("i8", "ui8") for t in c.operand_types))}


# --------------------------------------------------------------- roster


def prog_fused_allreduce_fp32(w):
    """N buckets -> N world-spanning all_reduces, no inter-bucket
    def-use edge, full-width wire (the compiled exchange of 3
    tensors)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import traced

    g = w.merge_fx(_compiled(
        lambda a, b, c: [traced.allreduce(t, op=hvd.Sum) for t in (a, b, c)],
        _rows(1, 64), _rows(2, 64), _rows(3, 64)))
    from horovod_tpu_torch.analysis import rules

    return [
        (rules.CollectiveCount("all_reduce", 3), g),
        (rules.CollectiveCount("reduce_scatter", 0), g),
        (rules.NoInterCollectiveDefUse("all_reduce"), g),
        (rules.ReplicaGroupStructure("all_reduce", groups=WORLD_GROUP,
                                     require_present=True), g),
        (rules.WireDtype(int8_allowed=False), g),
    ]


def prog_fused_allreduce_int8(w):
    """The flat quantized wire moves int8 payloads and stays one
    independent exchange family."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    g = w.merge_fx(_compiled(
        lambda x: traced.quantized_allreduce(x, op=hvd.Sum, seed=3),
        _rows(w.rank, 4096)))
    if g is None:
        return []
    return [
        (rules.CollectiveCount("all_to_all", (1, 4)), g),
        (rules.NoInterCollectiveDefUse("all_to_all"), g),
        (rules.CompileBudget(int8_collectives=(1, 8)), _int8_count(g)),
    ]


def prog_overlap_buckets(w):
    """The overlap contract at N=3 (the reference audits the same
    bucketed program as its fp32 entry)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    g = w.merge_fx(_compiled(
        lambda *ts: [traced.allreduce(t, op=hvd.Sum) for t in ts],
        *[_rows(i, 64) for i in range(6)][:3]))
    return [
        (rules.CollectiveCount("all_reduce", 3), g),
        (rules.NoInterCollectiveDefUse("all_reduce"), g),
    ]


def _opt_calls(w, sharded=False, stage=None, guard=False, **kw):
    """One optimizer step's recorded calls: 3 parameters of [32, 8]
    (6 for ZeRO) with this rank's gradients, 3 overlap buckets."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.testing.recorder import record_collectives

    n = 6 if sharded else 3
    model = torch.nn.Module()
    model.ps = torch.nn.ParameterList(
        [torch.nn.Parameter(_rows(40 + i, 32, 8)) for i in range(n)])
    grads = [_rows(100 * w.rank + i, 32, 8) for i in range(n)]
    base = torch.optim.SGD(model.parameters(), lr=0.1)
    named = list(model.named_parameters())
    if sharded:
        # the flat legs, as the reference's world of one node
        opt = hvd.ShardedDistributedOptimizer(
            base, named_parameters=named, op=hvd.Sum, zero_stage=stage,
            overlap_buckets=3, overlap_min_bytes=0, grad_guard=guard,
            hierarchical=False, **kw)
    else:
        opt = hvd.DistributedOptimizer(base, named_parameters=named,
                                       op=hvd.Sum, grad_guard=guard,
                                       overlap_buckets=3, overlap_min_bytes=0,
                                       **kw)
    with record_collectives() as calls:
        if stage == 3:  # the sharded tape: gathers in, scatters out
            opt.value_and_grad(lambda: sum(
                (p * g).sum() for p, g in zip(model.ps, grads)), model)()
        else:
            for p, g in zip(model.ps, grads):
                p.grad = g
        opt.step()
    remove = getattr(opt, "remove_hooks", None)
    if remove is not None:
        remove()
    return w.merge_calls(calls)


def prog_zero2(w):
    """ZeRO-2: per-bucket reduce-scatters and all-gathers, no full
    all_reduce (recorded calls: the independence rule is listed
    missing)."""
    from horovod_tpu_torch.analysis import rules

    g = _opt_calls(w, sharded=True, stage=2)
    return [
        (rules.CollectiveCount("reduce_scatter", 3), g),
        (rules.CollectiveCount("all_gather", 3), g),
        (rules.CollectiveCount("all_reduce", 0), g),
    ]


def prog_zero3(w):
    """ZeRO-3: per-bucket parameter all-gathers and gradient
    reduce-scatters, no full all_reduce."""
    from horovod_tpu_torch.analysis import rules

    g = _opt_calls(w, sharded=True, stage=3)
    return [
        (rules.CollectiveCount("all_gather", 3), g),
        (rules.CollectiveCount("reduce_scatter", 3), g),
        (rules.CollectiveCount("all_reduce", 0), g),
    ]


def prog_guard_overhead(w):
    """The replicated path's guard: its agreement rides the existing
    exchanges, so guard on == guard off."""
    from horovod_tpu_torch.analysis import rules

    base = _opt_calls(w)
    guarded = _opt_calls(w, guard=True)
    return [
        (rules.CollectiveCount("all_reduce", 3), base),
        (rules.GuardOverhead(base, extra_scalar_allreduces=0), guarded),
    ]


def prog_zero_guard_overhead(w):
    """The sharded path's guard: exactly one extra scalar all_reduce,
    the agreement flag."""
    from horovod_tpu_torch.analysis import rules

    base = _opt_calls(w, sharded=True, stage=2)
    guarded = _opt_calls(w, sharded=True, stage=2, guard=True)
    return [(rules.GuardOverhead(base, extra_scalar_allreduces=1), guarded)]


def prog_hier_allreduce(w):
    """The two-level wire: per-bucket intra reduce-scatter, inter
    all_reduce, intra all-gather; group-limited; independent buckets."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    stages = _stages()
    g = w.merge_fx(_compiled(
        lambda *ts: [traced.hierarchical_allreduce_groups(
            t, op=hvd.Sum, stages=stages) for t in ts],
        _rows(1, 64), _rows(2, 64), _rows(3, 64)))
    return [
        (rules.CollectiveCount("reduce_scatter", 3), g),
        (rules.CollectiveCount("all_reduce", 3), g),
        (rules.CollectiveCount("all_gather", 3), g),
        (rules.ReplicaGroupStructure("reduce_scatter", groups=INTRA), g),
        (rules.ReplicaGroupStructure("all_gather", groups=INTRA), g),
        (rules.ReplicaGroupStructure("all_reduce", groups=INTER,
                                     forbid_world_spanning=True), g),
        (rules.NoInterCollectiveDefUse("all_reduce"), g),
        (rules.WireDtype(int8_allowed=False), g),
    ]


def prog_hier_int8(w):
    """int8 on the inter hop only; the intra hops full width; nothing
    world-spanning."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    stages = _stages()
    g = w.merge_fx(_compiled(
        lambda x: traced.hierarchical_allreduce_groups(
            x, op=hvd.Sum, stages=stages, inter_wire="int8", seed=5,
            block_size=64), _rows(w.rank, 2048)))
    if g is None:
        return []
    return [
        (rules.ReplicaGroupStructure("reduce_scatter", groups=INTRA), g),
        (rules.ReplicaGroupStructure(
            "all_gather", groups_any_of=(INTRA, INTER),
            forbid_world_spanning=True), g),
        (rules.WireDtype(inter_groups=INTER, intra_groups=INTRA), g),
        (rules.CompileBudget(int8_collectives=(1, 8)), _int8_count(g)),
    ]


def prog_moe_alltoall(w):
    """Expert dispatch is two-level: every all_to_all group-limited,
    none world-spanning, int8 on the inter hop only."""
    import torch

    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    stages = _stages()
    g = w.merge_fx(_compiled(
        lambda v: traced.hierarchical_alltoall(
            v, stages=stages, inter_wire="int8", block_size=32),
        torch.zeros(WORLD, 4, 64)))
    return [
        (rules.ReplicaGroupStructure("all_to_all",
                                     forbid_world_spanning=True,
                                     require_present=True), g),
        (rules.WireDtype(inter_groups=INTER, intra_groups=INTRA), g),
    ]


def prog_local_sgd_phase(w):
    """Local SGD's local phase: every collective over the intra groups,
    full width, 3 buckets (recorded calls)."""
    from horovod_tpu_torch.analysis import fx_parse, rules

    g = _opt_calls(w, local_sgd_steps=8, local_sgd_intra=LOCAL)
    pairs = [
        (rules.CollectiveCount("all_reduce", 3), g),
        (rules.WireDtype(int8_allowed=False), g),
    ]
    for kind in fx_parse.COLLECTIVE_KINDS:
        pairs.append((rules.ReplicaGroupStructure(
            kind, groups_any_of=(INTRA,), forbid_world_spanning=True,
            require_present=(kind == "all_reduce")), g))
    return pairs


def _serve_engine(paged=True, role="unified", paged_attn=None):
    import torch

    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serving import InferenceEngine

    cfg = TransformerConfig(vocab_size=61, num_layers=1, d_model=16,
                            num_heads=2, d_ff=32, max_len=64,
                            dtype=torch.float32)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return InferenceEngine(model, None, slots=4, max_len=64, min_bucket=4,
                           paged=paged, role=role, paged_attn=paged_attn,
                           device="cpu")


def _rolling(eng, rng):
    import numpy as np

    for i in range(4):
        slot = eng.manager.alloc(f"warm{i}")
        eng.prefill(slot, rng.integers(1, 60, size=5 + i).tolist())
    for i in range(6):
        eng.decode_step(np.zeros(eng.slots, np.int32))
        if i == 2:
            eng.manager.free(1)
            slot = eng.manager.alloc("rolled")
            eng.prefill(slot, rng.integers(1, 60, size=9).tolist())


def prog_serve_decode(w):
    """The pool written in place (the reference's donated carry) and
    one decode program across rolling admissions: no capture on the CPU
    (``decode_compiles`` 0, every step the same eager body)."""
    import numpy as np

    from horovod_tpu_torch.analysis import rules

    if w.rank:
        return []
    eng = _serve_engine(paged=False)
    pairs = [(rules.PoolWrittenInPlace(), rules.probe_pool(eng, [1, 2, 3]))]
    _rolling(eng, np.random.default_rng(3))
    pairs.append((rules.CompileBudget(decode_compiles=0, decode_steps=8),
                  eng.stats()))
    return pairs


def prog_serve_prefill(w):
    """The prefill tier: four prompts in (4, 8] share one width-8 bucket
    entry; the pool written in place."""
    from horovod_tpu_torch.analysis import rules

    if w.rank:
        return []
    eng = _serve_engine(paged=False)
    pairs = [(rules.PoolWrittenInPlace(),
              rules.probe_pool(eng, [1, 2, 3], program=False))]
    before = eng.stats()
    for i, n in enumerate((5, 6, 7, 8)):
        slot = eng.manager.alloc(i)
        eng.prefill(slot, list(range(1, n + 1)))
    stats = eng.stats()
    stats = {k: stats[k] - before.get(k, 0) for k in
             ("prefill_compiles", "prefill_bucket_hits")}
    pairs.append((rules.CompileBudget(prefill_compiles=1,
                                      prefill_bucket_hits=3), stats))
    return pairs


def prog_serve_prefill_role(w):
    """A prefill-role worker: prefill entries only, pages out over the
    wire, ``decode_compiles == 0``."""
    import numpy as np

    from horovod_tpu_torch.analysis import rules

    if w.rank:
        return []
    eng = _serve_engine(paged=True, role="prefill")
    rng = np.random.default_rng(5)
    for i, n in enumerate((5, 6, 7, 8)):
        slot = eng.manager.alloc(i)
        eng.prefill(slot, rng.integers(1, 60, size=n).tolist())
        kept, length = eng.manager.detach_keep(slot)
        eng.extract_pages(kept, length)
        eng.manager.release_kept(kept)
    return [(rules.CompileBudget(decode_compiles=0, prefill_compiles=1),
             eng.stats())]


def prog_serve_decode_role(w):
    """A decode-role worker admits ingested pages, never prompts: no
    prefill entry, three ingests, the pool written in place."""
    import numpy as np

    from horovod_tpu_torch.analysis import rules

    if w.rank:
        return []
    src = _serve_engine(paged=True)
    eng = _serve_engine(paged=True, role="decode")
    rng = np.random.default_rng(6)
    ptrs = [rules.pool_leaves(eng)[0].data_ptr()]
    for i in range(3):
        slot = src.manager.alloc(f"src{i}")
        src.prefill(slot, rng.integers(1, 60, size=5 + i).tolist())
        kept, length = src.manager.detach_keep(slot)
        arrays = src.extract_pages(kept, length)
        dslot = eng.manager.alloc(f"dst{i}")
        assert eng.ingest_attach(dslot, [lp for lp, _ in kept], arrays,
                                 length) is not None
        src.manager.release_kept(kept)
        eng.decode_step(np.zeros(eng.slots, np.int32))
        eng.decode_step(np.zeros(eng.slots, np.int32))
        ptrs.append(rules.pool_leaves(eng)[0].data_ptr())
    probe = rules.PoolProbe([(f"ingest{i}", (p,)) for i, p in
                             enumerate(ptrs)], ())
    return [
        (rules.PoolWrittenInPlace(), probe),
        (rules.CompileBudget(decode_compiles=0, prefill_compiles=0,
                             transfer_ingests=3), eng.stats()),
    ]


def prog_serve_paged_attn(w):
    """The kernel-path decode program makes no ``[slots, max_len]``
    gather view, the gather-path one does (the matcher's
    falsifiability); one decode program, no fallback."""
    import numpy as np

    from horovod_tpu_torch.analysis import rules

    if w.rank:
        return []
    eng = _serve_engine(paged=True, paged_attn="on")
    base = _serve_engine(paged=True, paged_attn="off")
    gk = rules.probe_pool(eng, [1, 2, 3]).program
    gb = rules.probe_pool(base, [1, 2, 3]).program
    shape = (eng.slots, eng.max_len)
    pairs = [
        (rules.TransientBuffer(shape, forbid=True), gk),
        (rules.TransientBuffer(shape, forbid=False), gb),
    ]
    _rolling(eng, np.random.default_rng(7))
    pairs.append((rules.CompileBudget(decode_compiles=0,
                                      paged_attn_fallbacks=0), eng.stats()))
    return pairs


def prog_serve_migrate_resume(w):
    """Two sequences exported mid-decode at different lengths resume on
    one decode-role receiver: no prefill entry, two ingests, the pool
    written in place."""
    import numpy as np

    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.serving import ContinuousBatcher

    if w.rank:
        return []
    src = _serve_engine(paged=True)
    sbat = ContinuousBatcher(src, default_max_new_tokens=12)
    rng = np.random.default_rng(19)
    r1 = sbat.submit(rng.integers(1, 60, size=5).tolist(), max_new_tokens=12)
    r2 = sbat.submit(rng.integers(1, 60, size=9).tolist(), max_new_tokens=10)
    for _ in range(4):
        sbat.step()
    assert r1.status == "running" and r2.status == "running"
    records = sbat.export_inflight()
    deng = _serve_engine(paged=True, role="decode")
    dbat = ContinuousBatcher(deng, role="decode", default_max_new_tokens=12)
    ptr0 = rules.pool_leaves(deng)[0].data_ptr()
    resumed = []
    for rec in records:
        req, kept, length = rec["req"], rec["kept"], rec["length"]
        resumed.append(dbat.submit_migrated(
            prompt=[int(t) for t in req.prompt],
            tokens=list(req.out_tokens), max_new_tokens=req.max_new_tokens,
            logical=[lp for lp, _ in kept],
            arrays=src.extract_pages(kept, length), length=length,
            sample=rec.get("sample")))
        src.manager.release_kept(kept)
        dbat.step()
    for _ in range(1000):
        if all(r.finished() for r in resumed):
            break
        dbat.step()
    assert all(r.status == "done" for r in resumed)
    probe = rules.PoolProbe([("built", (ptr0,)), ("resumed", (
        rules.pool_leaves(deng)[0].data_ptr(),))], ())
    return [
        (rules.PoolWrittenInPlace(), probe),
        (rules.CompileBudget(decode_compiles=0, prefill_compiles=0,
                             transfer_ingests=2), deng.stats()),
    ]


ROSTER = {
    "fused_allreduce_fp32": prog_fused_allreduce_fp32,
    "fused_allreduce_int8": prog_fused_allreduce_int8,
    "overlap_buckets": prog_overlap_buckets,
    "zero2": prog_zero2,
    "zero3": prog_zero3,
    "guard_overhead": prog_guard_overhead,
    "zero_guard_overhead": prog_zero_guard_overhead,
    "hier_allreduce": prog_hier_allreduce,
    "hier_int8": prog_hier_int8,
    "moe_alltoall": prog_moe_alltoall,
    "local_sgd_phase": prog_local_sgd_phase,
    "serve_decode": prog_serve_decode,
    "serve_prefill": prog_serve_prefill,
    "serve_prefill_role": prog_serve_prefill_role,
    "serve_decode_role": prog_serve_decode_role,
    "serve_paged_attn": prog_serve_paged_attn,
    "serve_migrate_resume": prog_serve_migrate_resume,
}


# ------------------------------------------------- deliberate breakage


def break_int8_intra(w):
    """int8 on the INTRA hop: the placement rule must flag it."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    groups = [list(r) for r in INTRA]
    traced.prepare_groups(groups)
    g = w.merge_fx(_compiled(
        lambda v: traced.quantized_reducescatter(
            torch.stack([v] * LOCAL), op=hvd.Sum, seed=1, block_size=64,
            groups=groups), _rows(2, 256)))
    return [(rules.WireDtype(inter_groups=INTER, intra_groups=INTRA), g)]


def break_serialized_buckets(w):
    """One bucket's exchange fed by another's: independence gone."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    g = w.merge_fx(_compiled(
        lambda t: traced.allreduce(traced.allreduce(t, op=hvd.Sum) * 2.0,
                                   op=hvd.Sum), _rows(3, 64)))
    return [(rules.NoInterCollectiveDefUse("all_reduce"), g)]


def break_monolithic_alltoall(w):
    """A world-spanning alltoall where the two-level contract holds."""
    from horovod_tpu_torch.analysis import rules
    from horovod_tpu_torch.ops import traced

    g = w.merge_fx(_compiled(lambda v: traced.alltoall(v),
                             _rows(4, WORLD * 4, 8)))
    return [(rules.ReplicaGroupStructure("all_to_all",
                                         forbid_world_spanning=True,
                                         require_present=True), g)]


def break_undonated_carry(w):
    """A decode step that writes a copy of the KV pool and rebinds it,
    what an undonated carry is to the JAX engine."""
    from horovod_tpu_torch.analysis import rules

    if w.rank:
        return []
    eng = _serve_engine(paged=False)
    body = eng._decode_body

    def copying(head=True):
        out = body(head)
        mgr = eng.manager
        for whole, live in zip(mgr.full_cache, mgr.cache):
            for name in whole:
                whole[name] = whole[name].clone()
                live[name] = whole[name][:mgr.slots]
        return out

    eng._decode_body = copying
    return [(rules.PoolWrittenInPlace(),
             rules.probe_pool(eng, [1, 2, 3], program=False))]


BREAKS = {
    "int8-intra": break_int8_intra,
    "serialized-buckets": break_serialized_buckets,
    "monolithic-alltoall": break_monolithic_alltoall,
    "undonated-carry": break_undonated_carry,
}


# ------------------------------------------------------------- running


def _rank_main(rank, store_path, names, break_mode, json_path):
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import rules

    hvd.init(device="cpu", store=dist.FileStore(store_path, WORLD))
    w = World(rank)
    builders = ({f"break:{break_mode}": BREAKS[break_mode]} if break_mode
                else {n: ROSTER[n] for n in names})
    report = {"programs": {}, "ok": True, "missing": MISSING}
    for name, builder in builders.items():
        t0 = time.monotonic()
        pairs = builder(w)
        dist.barrier()
        if rank:
            continue
        prog = rules.run_rules(pairs)
        report["programs"][name] = dict(prog.to_dict(),
                                        seconds=time.monotonic() - t0)
        status = "OK" if prog.ok else "VIOLATED"
        print(f"[{status:8s}] {name}: {len(pairs)} rule(s)", flush=True)
        for f in prog.findings:
            print(f"    {f}", flush=True)
        report["ok"] = report["ok"] and prog.ok
    hvd.shutdown()
    if rank:
        return 0
    if json_path:
        tmp = json_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(report, fh, indent=2)
        os.replace(tmp, json_path)
        print(f"report: {json_path}")
    if not report["ok"]:
        print("hlo_audit_torch: invariant violation(s) found",
              file=sys.stderr)
        return 1
    print(f"hlo_audit_torch: {len(builders)} program(s) green")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default="")
    ap.add_argument("--only", default="")
    ap.add_argument("--break", dest="break_mode", default="",
                    choices=[""] + sorted(BREAKS))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    ap.add_argument("--names", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.list:
        for name in ROSTER:
            print(name)
        for name in BREAKS:
            print(f"--break {name}")
        for name, why in MISSING.items():
            print(f"missing {name}: {why}")
        return 0
    if args.rank is not None:
        return _rank_main(args.rank, args.store,
                          args.names.split(",") if args.names else [],
                          args.break_mode, args.json)
    names = [n for n in ROSTER if args.only in n]
    if not names and not args.break_mode:
        print(f"no roster program matches {args.only!r}", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="hlo-audit-torch-")
    env = dict(os.environ, HOROVOD_SIZE=str(WORLD),
               HOROVOD_INTRA_SIZE=str(LOCAL), OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        cmd = [sys.executable, os.path.abspath(__file__), "--rank", str(r),
               "--store", os.path.join(tmp, "store"),
               "--names", ",".join(names)]
        if args.break_mode:
            cmd += ["--break", args.break_mode]
        if args.json and r == 0:
            cmd += ["--json", args.json]
        procs.append(subprocess.Popen(
            cmd, env=dict(env, HOROVOD_RANK=str(r)), cwd=REPO,
            stdout=None if r == 0 else subprocess.DEVNULL,
            stderr=None if r == 0 else subprocess.PIPE, text=True))
    rcs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            print("hlo_audit_torch: the world timed out", file=sys.stderr)
            return 3
        rcs.append(p.returncode)
        if r and p.returncode:
            print(f"rank {r} exited {p.returncode}:\n{(err or '')[-3000:]}",
                  file=sys.stderr)
    if any(rcs[1:]):
        return 3
    return rcs[0]


if __name__ == "__main__":
    sys.exit(main())
