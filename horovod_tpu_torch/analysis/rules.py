"""Declarative invariant rules over :class:`~.fx_parse.ProgramGraph`.

The counterpart of ``horovod_tpu/analysis/rules.py``, with its names and
messages. Each rule is a small object with a ``name`` and a
``check(subject)`` returning a list of :class:`Finding` (empty: the
invariant holds). Program rules take a ProgramGraph (an FX graph's or
recorded eager calls', :mod:`.fx_parse`); :class:`CompileBudget` takes a
counter mapping (an engine's ``stats()``) and
:class:`PoolWrittenInPlace` an engine probe (:func:`probe_pool`). The
roster runner (``scripts/hlo_audit_torch.py``) pairs each rule with its
subject, and tests use :func:`expect` as the one-line assertion form.

The catalog:

* :class:`CollectiveCount` — exactly N collectives of a kind.
* :class:`KernelCount` — exactly N calls of one ``hvd_torch`` operator
  (a kernel B1-B7, or the LM head): an FX graph's custom operators are
  single nodes.
* :class:`NoInterCollectiveDefUse` — no collective's operands reach
  another's result. It needs def-use edges, so it raises on recorded
  calls (an FX graph has them).
* :class:`ReplicaGroupStructure` — group-limited vs world-spanning
  routing.
* :class:`WireDtype` — int8 payloads on the inter-hop groups only.
* :class:`GuardOverhead` — guard on == guard off collective counts (+
  optionally scalar agreement all_reduces).
* :class:`CompileBudget` — expected counts per cache (``decode_compiles
  == 1``, prefill captures a width served).
* :class:`TransientBuffer` — a tensor shape prefix absent (or present)
  among the values a program makes.
* :class:`PoolWrittenInPlace` — what the reference's
  ``DonationCoverage`` guards, in torch's terms. The JAX engine donates
  its cache carry so a step never double-buffers it; torch has no
  donation (the port keys it ``none``) and the engine writes its pool
  in place instead (a CUDA graph holds its addresses). So the rule
  checks that every pool leaf keeps its storage (``data_ptr``) across a
  prefill, a decode step and a graph replay, and that the serving
  program makes no pool-sized value besides the in-place writes.
  ``DonationCoverage`` itself has no torch meaning and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple, Union

from .fx_parse import COLLECTIVE_KINDS, Collective, ProgramGraph

Groups = Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass
class Finding:
    """One violated invariant: which rule, what happened, where."""

    rule: str
    message: str
    snippet: str = ""
    line_no: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f" (line {self.line_no + 1})" if self.line_no is not None else ""
        tail = f"\n    {self.snippet}" if self.snippet else ""
        return f"[{self.rule}] {self.message}{loc}{tail}"


@dataclasses.dataclass
class Report:
    """The result of running a rule set: findings + per-rule status."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    checked: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "rules_checked": list(self.checked),
            "violations": [f.to_dict() for f in self.findings],
        }


def _norm_groups(groups) -> Groups:
    return tuple(tuple(int(r) for r in g) for g in groups)


class Rule:
    """Base: subclasses define ``check(subject) -> List[Finding]``."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def check(self, subject) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def _finding(self, message: str, coll: Optional[Collective] = None) -> Finding:
        return Finding(
            rule=self.name,
            message=message,
            snippet=coll.snippet if coll is not None else "",
            line_no=coll.line_no if coll is not None else None,
        )


class CollectiveCount(Rule):
    """Exactly ``expect`` collectives of ``kind`` (int, or a
    ``(min, max)`` inclusive range)."""

    def __init__(self, kind: str, expect: Union[int, Tuple[int, int]]):
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown kind {kind!r}")
        self.kind = kind
        self.expect = expect

    @property
    def name(self) -> str:
        return f"CollectiveCount[{self.kind}=={self.expect}]"

    def check(self, graph: ProgramGraph) -> List[Finding]:
        n = graph.count(self.kind)
        if isinstance(self.expect, tuple):
            lo, hi = self.expect
            if lo <= n <= hi:
                return []
            want = f"in [{lo}, {hi}]"
        else:
            if n == int(self.expect):
                return []
            want = f"== {self.expect}"
        colls = graph.collectives(self.kind)
        return [
            self._finding(
                f"module carries {n} {self.kind} op(s), expected {want}",
                colls[0] if colls else None,
            )
        ]


class KernelCount(Rule):
    """Exactly ``expect`` calls (int, or a ``(min, max)`` inclusive
    range) of the ``hvd_torch`` operator ``op`` (``flash_fwd``,
    ``paged_attention``, ``mixed_linear``, ...)."""

    def __init__(self, op: str, expect: Union[int, Tuple[int, int]]):
        self.op = op
        self.expect = expect

    @property
    def name(self) -> str:
        return f"KernelCount[{self.op}=={self.expect}]"

    def check(self, graph: ProgramGraph) -> List[Finding]:
        n = graph.kernel_counts().get(self.op, 0)
        if isinstance(self.expect, tuple):
            lo, hi = self.expect
            if lo <= n <= hi:
                return []
            want = f"in [{lo}, {hi}]"
        else:
            if n == int(self.expect):
                return []
            want = f"== {self.expect}"
        return [self._finding(
            f"program calls hvd_torch::{self.op} {n} time(s), expected "
            f"{want}")]


class NoInterCollectiveDefUse(Rule):
    """No collective of ``kind`` may transitively depend on another's
    result — independence is what makes buckets overlappable."""

    def __init__(self, kind: Optional[str] = None):
        self.kind = kind

    @property
    def name(self) -> str:
        return f"NoInterCollectiveDefUse[{self.kind or 'any'}]"

    def check(self, graph: ProgramGraph) -> List[Finding]:
        out = []
        for dep, on in graph.dependent_pairs(self.kind):
            out.append(
                self._finding(
                    f"{dep.kind} {dep.sid} depends on {on.kind} {on.sid}: "
                    "collectives serialized (bucket independence broken)",
                    dep,
                )
            )
        return out


class ReplicaGroupStructure(Rule):
    """Routing structure of ``kind``:

    * ``groups=`` — every matching collective must carry exactly these
      replica groups.
    * ``groups_any_of=`` — every matching collective must carry ONE of
      these group sets (e.g. intra OR inter on a two-level wire).
    * ``forbid_world_spanning=True`` — no matching collective may have
      a group covering all ``world`` ranks (the "no monolithic
      exchange over DCN" gate).
    * ``require_present=True`` — at least one matching collective must
      exist (a vacuous pass is itself a violation: the program was
      expected to carry this exchange).
    """

    def __init__(
        self,
        kind: str,
        groups: Optional[Sequence[Sequence[int]]] = None,
        groups_any_of: Optional[Sequence[Sequence[Sequence[int]]]] = None,
        forbid_world_spanning: bool = False,
        world: Optional[int] = None,
        require_present: bool = False,
    ):
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown kind {kind!r}")
        self.kind = kind
        self.groups = _norm_groups(groups) if groups is not None else None
        self.groups_any_of = (
            tuple(_norm_groups(g) for g in groups_any_of)
            if groups_any_of is not None
            else None
        )
        self.forbid_world_spanning = forbid_world_spanning
        self.world = world
        self.require_present = require_present

    @property
    def name(self) -> str:
        return f"ReplicaGroupStructure[{self.kind}]"

    def check(self, graph: ProgramGraph) -> List[Finding]:
        out: List[Finding] = []
        colls = graph.collectives(self.kind)
        if self.require_present and not colls:
            out.append(
                self._finding(
                    f"expected at least one {self.kind} op, module has none"
                )
            )
        world = self.world or graph.num_partitions
        for c in colls:
            if self.groups is not None and _norm_groups(c.replica_groups) != self.groups:
                out.append(
                    self._finding(
                        f"{c.kind} {c.sid} routes over groups "
                        f"{c.replica_groups}, expected {self.groups}",
                        c,
                    )
                )
            if (
                self.groups_any_of is not None
                and _norm_groups(c.replica_groups) not in self.groups_any_of
            ):
                out.append(
                    self._finding(
                        f"{c.kind} {c.sid} routes over groups "
                        f"{c.replica_groups}, expected one of "
                        f"{list(self.groups_any_of)}",
                        c,
                    )
                )
            if self.forbid_world_spanning and c.spans(world):
                out.append(
                    self._finding(
                        f"{c.kind} {c.sid} spans the whole world "
                        f"(group of {max(c.group_sizes or (0,))} ranks, "
                        f"world {world}) — expected group-limited routing",
                        c,
                    )
                )
        return out


class WireDtype(Rule):
    """int8 wire placement: an i8-payload collective is permitted only
    when its replica groups are the INTER-hop groups; i8 on the intra
    groups (or spanning the world, when a hierarchy is declared) is the
    violation this rule exists to catch. ``int8_allowed=False`` forbids
    i8 payloads entirely (the fp32-roster programs)."""

    INT8 = ("i8", "ui8")

    def __init__(
        self,
        inter_groups: Optional[Sequence[Sequence[int]]] = None,
        intra_groups: Optional[Sequence[Sequence[int]]] = None,
        int8_allowed: bool = True,
    ):
        self.inter_groups = (
            _norm_groups(inter_groups) if inter_groups is not None else None
        )
        self.intra_groups = (
            _norm_groups(intra_groups) if intra_groups is not None else None
        )
        self.int8_allowed = int8_allowed

    def _moves_int8(self, c: Collective) -> bool:
        return any(t.dtype in self.INT8 for t in c.operand_types)

    def check(self, graph: ProgramGraph) -> List[Finding]:
        out: List[Finding] = []
        for c in graph.collectives():
            if not self._moves_int8(c):
                continue
            if not self.int8_allowed:
                out.append(
                    self._finding(
                        f"{c.kind} {c.sid} moves int8 payload on a program "
                        "whose wire contract is full-width",
                        c,
                    )
                )
                continue
            groups = _norm_groups(c.replica_groups)
            if self.intra_groups is not None and groups == self.intra_groups:
                out.append(
                    self._finding(
                        f"{c.kind} {c.sid} moves int8 over the INTRA hop "
                        f"{c.replica_groups} — int8 is licensed for the "
                        "inter (DCN) hop only",
                        c,
                    )
                )
            elif self.inter_groups is not None and groups != self.inter_groups:
                out.append(
                    self._finding(
                        f"{c.kind} {c.sid} moves int8 over groups "
                        f"{c.replica_groups}, which are not the declared "
                        f"inter-hop groups {self.inter_groups}",
                        c,
                    )
                )
        return out


class GuardOverhead(Rule):
    """The grad guard's contract, as a two-program rule: construct
    with the guard-OFF baseline graph, check the guard-ON graph. Every
    collective count must match the baseline exactly, except
    ``extra_scalar_allreduces`` additional all_reduce ops which must
    each be SCALAR (the 4-byte agreement flag) — a shaped extra
    all_reduce is a hidden full-gradient exchange."""

    def __init__(self, baseline: ProgramGraph, extra_scalar_allreduces: int = 0):
        self.baseline = baseline
        self.extra = int(extra_scalar_allreduces)

    def check(self, graph: ProgramGraph) -> List[Finding]:
        out: List[Finding] = []
        base = self.baseline.counts()
        got = graph.counts()
        for kind in COLLECTIVE_KINDS:
            want = base[kind] + (self.extra if kind == "all_reduce" else 0)
            if got[kind] != want:
                colls = graph.collectives(kind)
                out.append(
                    self._finding(
                        f"guard-on module carries {got[kind]} {kind} op(s), "
                        f"guard-off baseline implies {want}",
                        colls[0] if colls else None,
                    )
                )
        if self.extra and not out:
            # the extra all_reduces must be the scalar agreement flags:
            # identify them as the ops absent from the baseline's
            # multiset of operand shapes
            base_shapes = [
                tuple(t.shape for t in c.operand_types)
                for c in self.baseline.collectives("all_reduce")
            ]
            extras = []
            for c in graph.collectives("all_reduce"):
                shapes = tuple(t.shape for t in c.operand_types)
                if shapes in base_shapes:
                    base_shapes.remove(shapes)
                else:
                    extras.append(c)
            for c in extras:
                if not c.is_scalar():
                    out.append(
                        self._finding(
                            f"extra all_reduce {c.sid} carries a SHAPED "
                            f"operand {c.operand_types} — the agreement "
                            "flag must be scalar",
                            c,
                        )
                    )
        return out


class TransientBuffer(Rule):
    """Presence/absence of a tensor shape among a program's values: the
    paged-attention memory-plane gate. ``forbid=True`` (the default)
    asserts NO tensor whose leading dims match ``shape_prefix`` exists
    anywhere in the program — e.g. ``(slots, max_len)`` catches the
    transient contiguous ``[slots, max_len, kvh, hd]`` gather view the
    fused kernel is supposed to delete. ``forbid=False`` is the
    falsifiability twin: the gather-path program MUST still carry it,
    proving the matcher actually detects the buffer it bans."""

    def __init__(self, shape_prefix: Sequence[int], forbid: bool = True):
        self.shape_prefix = tuple(int(d) for d in shape_prefix)
        self.forbid = bool(forbid)

    @property
    def name(self) -> str:
        dims = "x".join(str(d) for d in self.shape_prefix)
        mode = "absent" if self.forbid else "present"
        return f"TransientBuffer[{dims}* {mode}]"

    def check(self, graph: ProgramGraph) -> List[Finding]:
        n = len(self.shape_prefix)
        hit = next(((func, node, t) for func, node, t in graph.values
                    if t.shape[:n] == self.shape_prefix), None)
        needle = "tensor<" + "".join(f"{d}x" for d in self.shape_prefix)
        if self.forbid and hit is not None:
            func, node, t = hit
            return [
                Finding(
                    rule=self.name,
                    message=(
                        f"program materializes a {needle}...> buffer "
                        f"({node} in {func}: {t}) — the transient gather "
                        "view the kernel path must not carry"
                    ),
                    snippet=node,
                )
            ]
        if not self.forbid and hit is None:
            return [
                Finding(
                    rule=self.name,
                    message=(
                        f"program carries no {needle}...> buffer — the "
                        "gather-path baseline should materialize the "
                        "view (matcher falsifiability check)"
                    ),
                )
            ]
        return []


@dataclasses.dataclass
class PoolProbe:
    """What :func:`probe_pool` saw of an engine: each pool leaf's
    storage address and shape at each named point, and the serving
    step's program (None when not traced)."""

    pointers: List[Tuple[str, Tuple[int, ...]]]
    shapes: Tuple[Tuple[int, ...], ...]
    program: Optional[ProgramGraph] = None


def pool_leaves(engine):
    """Every leaf of ``engine``'s KV pool, spare rows included."""
    return [leaf for layer in engine.manager.full_cache
            for _, leaf in sorted(layer.items())]


def probe_pool(engine, prompt, program: bool = True) -> PoolProbe:
    """Run a prefill of ``prompt`` on a free slot, a decode step and a
    second decode step (a graph replay on a CUDA card) on ``engine``,
    reading every pool leaf's ``data_ptr`` before and after each; with
    ``program``, trace the engine's decode body with ``make_fx`` (on the
    CPU: the graph a card captures runs the same body). The slot is
    freed after."""
    import numpy as np

    def snap():
        return tuple(leaf.data_ptr() for leaf in pool_leaves(engine))

    points = [("built", snap())]
    slot = engine.manager.alloc("probe")
    tok = engine.prefill(slot, prompt)
    points.append(("prefill", snap()))
    toks = np.zeros(engine.slots, np.int32)
    toks[slot] = tok
    for name in ("decode", "replay"):
        engine.manager.advance(slot)
        toks = engine.decode_step(toks)
        points.append((name, snap()))
    traced = None
    if program:
        import torch
        from torch.fx.experimental.proxy_tensor import make_fx

        with torch.no_grad():
            gm = make_fx(lambda: engine._decode_body())()
        from .fx_parse import parse_fx

        traced = parse_fx(gm, world=1)
    engine.manager.free(slot)
    return PoolProbe(points, tuple(tuple(leaf.shape) for leaf in
                                   pool_leaves(engine)), traced)


class PoolWrittenInPlace(Rule):
    """The serving engine's pool is written in place (the torch form of
    the reference's ``DonationCoverage``, module docstring): every pool
    leaf's storage is the same at every point of a :class:`PoolProbe`,
    and the serving program makes no pool-sized value except through an
    in-place write (a copy of the pool double-buffers it)."""

    def check(self, probe: PoolProbe) -> List[Finding]:
        out: List[Finding] = []
        first_name, first = probe.pointers[0]
        for name, ptrs in probe.pointers[1:]:
            moved = [i for i, (a, b) in enumerate(zip(first, ptrs))
                     if a != b]
            if moved:
                out.append(self._finding(
                    f"pool leaf #{moved[0]} (and {len(moved) - 1} more) "
                    f"moved between {first_name!r} and {name!r} — the "
                    "pool is not written in place (the carry double-"
                    "buffers)"))
        if probe.program is not None:
            shapes = set(probe.shapes)
            for func, node, t in probe.program.values:
                stmt = probe.program._stmts[func].get(node)
                if (t.shape not in shapes or stmt is None
                        or not stmt.rhs.startswith("call_function")):
                    continue
                # an in-place aten operator (index_copy_, copy_) returns
                # the pool itself
                if not stmt.rhs.split()[-1].split(".")[0].endswith("_"):
                    out.append(self._finding(
                        f"the serving program makes a pool-sized value "
                        f"{t} at {node} ({stmt.rhs}) — a copy of the pool",
                    ))
                    break
        return out


class CompileBudget(Rule):
    """Runtime counter rule: each key of ``expected`` must equal (or,
    as ``(min, max)``, fall within) the subject mapping's value. The
    ``decode_compiles == 1`` / exact-executable-count acceptance gates,
    shared between the roster runner and tests."""

    def __init__(self, **expected):
        self.expected = expected

    def check(self, stats: Mapping[str, float]) -> List[Finding]:
        out: List[Finding] = []
        for key, want in self.expected.items():
            got = stats.get(key)
            if got is None:
                out.append(self._finding(f"counter {key!r} absent from stats"))
            elif isinstance(want, tuple):
                lo, hi = want
                if not (lo <= got <= hi):
                    out.append(
                        self._finding(
                            f"counter {key} == {got}, expected in [{lo}, {hi}]"
                        )
                    )
            elif got != want:
                out.append(
                    self._finding(f"counter {key} == {got}, expected {want}")
                )
        return out


def run_rules(pairs: Sequence[Tuple[Rule, object]]) -> Report:
    """Evaluate (rule, subject) pairs into one Report."""
    report = Report()
    for rule, subject in pairs:
        report.checked.append(rule.name)
        report.findings.extend(rule.check(subject))
    return report


def check_program(graph: ProgramGraph, rules: Sequence[Rule]) -> Report:
    """Evaluate a rule list against one program."""
    return run_rules([(r, graph) for r in rules])


def expect(graph: ProgramGraph, *rules: Rule) -> None:
    """Test-facing assertion: raise AssertionError listing every
    violated invariant (with its snippet)."""
    report = check_program(graph, list(rules))
    if not report.ok:
        raise AssertionError(
            "lowered-program invariant(s) violated:\n"
            + "\n".join(str(f) for f in report.findings)
        )
