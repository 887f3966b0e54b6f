"""A program's collectives, kernels and def-use edges, from FX graphs or
from recorded eager calls.

The counterpart of ``horovod_tpu/analysis/hlo_parse.py``, with the same
names: :class:`ProgramGraph`, :class:`Collective`, :class:`ArgInfo`,
:class:`TensorType`, ``COLLECTIVE_KINDS``. The JAX package parses the
lowered StableHLO text of a jitted step; a torch program has two other
sources, and :mod:`.rules` runs over either:

* **FX graphs** (:func:`parse_fx`): what ``torch.compile`` hands a
  backend (wrap ``common.exe_cache.backend``, or any backend, to keep
  the ``GraphModule``), the forward and backward graphs AOTAutograd makes
  of it (:func:`aot_graphs`), or what ``make_fx`` traces. Every
  ``_c10d_functional`` node is a collective: its kind from the operator,
  its group's global ranks from the group name (resolved in this
  process, or from ``groups=``), its operand and result types from
  ``node.meta["val"]``. Def-use edges come from the graph itself, one
  function a graph module (a nested module, such as a checkpointed
  region, is its own function). Each ``hvd_torch`` custom operator (the
  kernels B1-B7 and the LM head) is one node, so :meth:`ProgramGraph.
  kernel_counts` counts kernel calls.
* **Recorded eager calls** (:func:`parse_calls`): the
  ``testing.recorder.Call`` list that ``record_collectives()`` makes of
  the port's eager ``torch.distributed`` calls, one list a rank. Call
  ``i`` of every rank is collective ``i``; its replica groups are the
  distinct groups the ranks named. This source has no def-use edges: a
  question that needs them (:meth:`ProgramGraph.dependent_pairs`)
  raises instead of passing vacuously.

A torch program donates nothing: an entry's arguments are all
``donated=False`` (the port keys donation as ``none``,
``common/exe_cache.py``), and the engine writes its pool in place
instead; :class:`.rules.PoolWrittenInPlace` checks that property.

Imports the standard library and torch only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

COLLECTIVE_KINDS = (
    "all_reduce",
    "reduce_scatter",
    "all_gather",
    "all_to_all",
    "collective_permute",
)

# the functional collectives (torch.ops._c10d_functional) by kind
_FUNCTIONAL = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "all_reduce_coalesced_": "all_reduce",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "all_to_all_single": "all_to_all",
}
# the recorder's call names by kind (a broadcast has no kind here)
_RECORDED = {
    "all_reduce": "all_reduce", "all_gather": "all_gather",
    "all_gather_into_tensor": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "send": "collective_permute", "recv": "collective_permute",
}
_DTYPES = {
    "torch.bool": "i1", "torch.int8": "i8", "torch.uint8": "ui8",
    "torch.int16": "i16", "torch.int32": "i32", "torch.int64": "i64",
    "torch.float16": "f16", "torch.bfloat16": "bf16",
    "torch.float32": "f32", "torch.float64": "f64",
    "torch.float8_e4m3fn": "f8E4M3FN", "torch.float8_e5m2": "f8E5M2",
}
_DTYPE_BYTES = {
    "i1": 1, "i8": 1, "ui8": 1, "i16": 2, "i32": 4, "i64": 8,
    "f8E4M3FN": 1, "f8E5M2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
}
KERNEL_NAMESPACE = "hvd_torch"


@dataclasses.dataclass(frozen=True)
class TensorType:
    """One tensor's shape and element type (the HLO spelling: ``f32``,
    ``bf16``, ``i8``, ...)."""

    shape: Tuple[int, ...]
    dtype: str

    @property
    def elems(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.elems * _DTYPE_BYTES.get(self.dtype, 4)

    @property
    def is_scalar(self) -> bool:
        return self.elems == 1

    def __str__(self) -> str:
        dims = "x".join(str(d) for d in self.shape)
        return f"tensor<{dims}{'x' if dims else ''}{self.dtype}>"


def dtype_name(dtype) -> str:
    """A torch dtype (or its string) in the HLO spelling."""
    return _DTYPES.get(str(dtype), str(dtype).replace("torch.", ""))


def _types_of(val) -> Tuple[TensorType, ...]:
    """The tensor types of a node's ``meta["val"]`` (a tensor, or a
    tuple or list of them)."""
    if isinstance(val, (list, tuple)):
        return tuple(t for v in val for t in _types_of(v))
    shape = getattr(val, "shape", None)
    if shape is None:
        return ()
    dims = tuple(int(d) if str(d).lstrip("-").isdigit() else 0
                 for d in shape)
    return (TensorType(dims, dtype_name(val.dtype)),)


@dataclasses.dataclass
class Statement:
    """One node of a function: its name, the names it reads."""

    sid: str
    func: str
    rhs: str
    operands: Tuple[str, ...]
    line_no: int


@dataclasses.dataclass
class Collective:
    """A collective with its routing and payload facts."""

    kind: str
    sid: str
    func: str
    index: int
    replica_groups: Tuple[Tuple[int, ...], ...]
    operand_types: Tuple[TensorType, ...]
    result_types: Tuple[TensorType, ...]
    reduction_dtype: Optional[str]
    line_no: int
    snippet: str

    @property
    def group_sizes(self) -> Tuple[int, ...]:
        return tuple(len(g) for g in self.replica_groups)

    @property
    def operand_bytes(self) -> int:
        return sum(t.nbytes for t in self.operand_types)

    @property
    def dtypes(self) -> Tuple[str, ...]:
        return tuple(t.dtype for t in self.operand_types)

    def spans(self, world: int) -> bool:
        """True when any replica group covers the whole world."""
        return any(len(g) >= world for g in self.replica_groups)

    def is_scalar(self) -> bool:
        return all(t.is_scalar for t in self.operand_types)


@dataclasses.dataclass(frozen=True)
class ArgInfo:
    """One input of a function: its type; torch donates nothing."""

    index: int
    type: Optional[TensorType]
    donated: bool = False
    aliased_output: Optional[int] = None


class ProgramGraph:
    """Typed view of one program: collectives, kernel calls, def-use
    edges (when the source has them) and the tensor types it makes.
    Built by :func:`parse_fx` or :func:`parse_calls`."""

    def __init__(self, text: str, collectives: List[Collective],
                 statements: Optional[Dict[str, Dict[str, Statement]]],
                 args: Dict[str, List[ArgInfo]], entry: str,
                 num_partitions: int, kernels: Optional[Dict[str, int]] = None,
                 values: Optional[List[Tuple[str, str, TensorType]]] = None
                 ) -> None:
        self.text = text
        self._collectives = collectives
        self._stmts = statements  # None: no def-use edges (recorded calls)
        self._args = args
        self.entry = entry
        self.num_partitions = num_partitions
        self._kernels = dict(kernels or {})
        # (func, node, type) of every value the program makes
        self.values = list(values or [])

    # ------------------------------------------------------------ queries

    def collectives(self, kind: Optional[str] = None) -> List[Collective]:
        if kind is None:
            return list(self._collectives)
        _check_kind(kind)
        return [c for c in self._collectives if c.kind == kind]

    def count(self, kind: str) -> int:
        return len(self.collectives(kind))

    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in COLLECTIVE_KINDS}
        for c in self._collectives:
            out[c.kind] += 1
        return out

    def replica_groups(self, kind: Optional[str] = None):
        return [c.replica_groups for c in self.collectives(kind)]

    def group_sizes(self, kind: Optional[str] = None) -> List[int]:
        return [len(c.replica_groups[0]) for c in self.collectives(kind)
                if c.replica_groups]

    def args(self, func: Optional[str] = None) -> List[ArgInfo]:
        return list(self._args.get(func or self.entry, []))

    def donated_args(self, func: Optional[str] = None) -> List[ArgInfo]:
        return [a for a in self.args(func)
                if a.donated or a.aliased_output is not None]

    def kernel_counts(self) -> Dict[str, int]:
        """Calls of each ``hvd_torch`` operator, by its name."""
        return dict(self._kernels)

    def functions(self) -> List[str]:
        return sorted(self._args)

    def node_count(self) -> int:
        return sum(len(d) for d in (self._stmts or {}).values())

    @property
    def has_edges(self) -> bool:
        return self._stmts is not None

    # ------------------------------------------------------------ def-use

    def _deps_of(self, stmt: Statement) -> set:
        defs = self._stmts.get(stmt.func, {})
        out: set = set()
        stack = list(stmt.operands)
        while stack:
            o = stack.pop()
            if o in out or o not in defs:
                continue
            out.add(o)
            stack.extend(defs[o].operands)
        return out

    def dependent_pairs(self, kind: Optional[str] = None
                        ) -> List[Tuple[Collective, Collective]]:
        """(dependent, dependency) pairs among the matching collectives.
        Raises ``ValueError`` on a program without def-use edges."""
        if self._stmts is None:
            raise ValueError(
                "this program has no def-use edges (recorded eager calls): "
                "a rule over them needs an FX graph")
        pairs = []
        by_func: Dict[str, List[Collective]] = {}
        for c in self.collectives(kind):
            by_func.setdefault(c.func, []).append(c)
        for func, group in by_func.items():
            defs = self._stmts.get(func, {})
            ids = {c.sid: c for c in group}
            for c in group:
                stmt = defs.get(c.sid)
                if stmt is None:
                    continue
                deps = self._deps_of(stmt)
                for other_sid, other in ids.items():
                    if other_sid != c.sid and other_sid in deps:
                        pairs.append((c, other))
        return pairs

    def independent(self, kind: Optional[str] = None) -> bool:
        return not self.dependent_pairs(kind)


def _check_kind(kind: str) -> None:
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; expected one "
                         f"of {COLLECTIVE_KINDS}")


# ---------------------------------------------------------------- FX source


def _group_ranks(name, groups: Optional[Mapping[str, Sequence[int]]]):
    """A functional collective's group name as global ranks: from
    ``groups`` when given, else resolved in this process."""
    if groups is not None and name in groups:
        return tuple(int(r) for r in groups[name])
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    return tuple(dist.get_process_group_ranks(
        c10d._resolve_process_group(name)))


def _world(groups) -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    sizes = [len(r) for r in (groups or {}).values()]
    return max(sizes, default=1)


def _functional_kind(target) -> Optional[str]:
    ns = getattr(target, "namespace", None)
    if ns not in ("_c10d_functional", "c10d_functional"):
        return None
    return _FUNCTIONAL.get(target._schema.name.split("::")[-1])


def _kernel_name(target) -> Optional[str]:
    if getattr(target, "namespace", None) != KERNEL_NAMESPACE:
        return None
    return target._schema.name.split("::")[-1]


def _walk(gm, func, out, groups, world_ranks):
    """Add ``gm``'s nodes as function ``func`` (its nested graph modules
    as functions of their own) to ``out``."""
    import torch.fx

    stmts, args, line = {}, [], 0
    out["stmts"][func] = stmts
    out["args"][func] = args
    for node in gm.graph.nodes:
        line += 1
        val = node.meta.get("val")
        types = _types_of(val)
        if node.op == "placeholder":
            args.append(ArgInfo(len(args), types[0] if types else None))
            continue
        if node.op == "output":
            continue
        operands = tuple(n.name for n in node.all_input_nodes)
        rhs = f"{node.op} {getattr(node.target, '__name__', node.target)}"
        stmts[node.name] = Statement(node.name, func, rhs, operands, line)
        for t in types:
            out["values"].append((func, node.name, t))
        if node.op == "get_attr":
            sub = getattr(gm, node.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                _walk(sub, f"{func}.{node.target}", out, groups, world_ranks)
            continue
        if node.op != "call_function":
            continue
        kernel = _kernel_name(node.target)
        if kernel is not None:
            out["kernels"][kernel] = out["kernels"].get(kernel, 0) + 1
            continue
        kind = _functional_kind(node.target)
        if kind is None:
            continue
        name = next((a for a in node.args if isinstance(a, str)
                     and a not in ("sum", "avg", "max", "min", "product",
                                   "premul_sum", "band", "bor", "bxor")),
                    None)
        ranks = (_group_ranks(name, groups) if name is not None
                 else world_ranks)
        src = node.args[0] if node.args else None
        operand_types = _types_of(src.meta.get("val")) if isinstance(
            src, torch.fx.Node) else ()
        red = None
        if kind in ("all_reduce", "reduce_scatter") and operand_types:
            red = operand_types[0].dtype
        snippet = f"{node.name} = {node.target}({', '.join(map(str, node.args))})"
        out["colls"].append(Collective(
            kind, node.name, func, len(out["colls"]), (ranks,),
            operand_types, types, red, line, snippet[:240]))


def parse_fx(graphs, groups: Optional[Mapping[str, Sequence[int]]] = None,
             world: Optional[int] = None) -> ProgramGraph:
    """A :class:`ProgramGraph` of one ``torch.fx.GraphModule``, or of
    several as its functions (a mapping of name to module, or a
    sequence: ``forward``, ``backward``, then ``fn<i>``). ``groups`` maps
    a group name to its global ranks where this process has no such
    group; ``world`` is the world's size (default: this process's, or
    the largest group's). A collective's replica groups are its own
    group's ranks (one row: a graph is one rank's program)."""
    if not isinstance(graphs, Mapping):
        if not isinstance(graphs, (list, tuple)):
            graphs = [graphs]
        names = ["forward", "backward"] + [f"fn{i}" for i in
                                           range(2, len(graphs))]
        graphs = dict(zip(names, graphs))
    world = int(world or _world(groups))
    out = {"stmts": {}, "args": {}, "colls": [], "kernels": {},
           "values": []}
    for name, gm in graphs.items():
        _walk(gm, name, out, groups, tuple(range(world)))
    text = "\n".join(f"# {name}\n{gm.code}" for name, gm in graphs.items())
    return ProgramGraph(text, out["colls"], out["stmts"], out["args"],
                        next(iter(graphs)), world, out["kernels"],
                        out["values"])


def aot_graphs(gm, example_inputs) -> Dict[str, object]:
    """The forward and backward graphs AOTAutograd partitions ``gm`` into
    (what a compiled step runs), traced from ``example_inputs`` and
    compiled by no one: ``{"forward": gm, "backward": gm}`` (no
    ``backward`` when nothing needs a gradient)."""
    import torch._functorch.config as functorch_config
    from torch._functorch.aot_autograd import (aot_module_simplified,
                                               make_boxed_func)

    kept: Dict[str, object] = {}

    def keep(name):
        def compiler(g, _inputs):
            kept[name] = g
            return make_boxed_func(g.forward)
        return compiler

    with functorch_config.patch(force_non_lazy_backward_lowering=True):
        aot_module_simplified(gm, list(example_inputs),
                              fw_compiler=keep("forward"),
                              bw_compiler=keep("backward"))
    return kept


# ------------------------------------------------------ recorded-call source


def parse_calls(per_rank) -> ProgramGraph:
    """A :class:`ProgramGraph` of recorded eager calls
    (``testing.recorder.Call``), one list a rank (a single list is one
    rank's). Call ``i`` of every rank is collective ``i``: its replica
    groups are the distinct groups the ranks named, its operand type the
    first rank's ``dtype`` and ``shape`` (the byte count as ``ui8``
    where the recorder had no type). Broadcasts are kept in the text
    only. The result has no def-use edges."""
    if per_rank and not isinstance(per_rank[0], (list, tuple)) or (
            per_rank and per_rank[0] and hasattr(per_rank[0], "op")):
        per_rank = [per_rank]
    per_rank = [list(calls) for calls in per_rank]
    lengths = {len(calls) for calls in per_rank}
    if len(lengths) > 1:
        raise ValueError(f"the ranks recorded different numbers of calls "
                         f"{sorted(lengths)}: their schedules diverge")
    world = max([len(per_rank)] + [max(c.ranks) + 1 for calls in per_rank
                                    for c in calls if c.ranks])
    colls, lines = [], []
    for i, calls in enumerate(zip(*per_rank)):
        first = calls[0]
        ops = {c.op for c in calls}
        line = f"{i}: {first.op} ranks={first.ranks} bytes={first.nbytes}"
        lines.append(line)
        kind = _RECORDED.get(first.op)
        if kind is None:
            continue
        if len({_RECORDED.get(o) for o in ops}) > 1:
            raise ValueError(f"call {i} differs between ranks: {ops}")
        groups = tuple(sorted({tuple(c.ranks) for c in calls}))
        dtype = getattr(first, "dtype", "") or ""
        shape = tuple(getattr(first, "shape", ()) or ())
        if dtype:
            operand = (TensorType(shape, dtype_name(dtype)),)
        else:
            operand = (TensorType((first.nbytes,), "ui8"),)
        red = operand[0].dtype if kind in ("all_reduce",
                                           "reduce_scatter") else None
        colls.append(Collective(kind, f"call{i}", "main", len(colls), groups,
                                operand, operand, red, i, line))
    return ProgramGraph("\n".join(lines), colls, None, {"main": []}, "main",
                        world)


def merge_ranks(programs: Sequence[ProgramGraph]) -> ProgramGraph:
    """One program of every rank's :func:`parse_fx` of the same step
    (rank order): collective ``i``'s replica groups become the distinct
    groups the ranks' collective ``i`` named, as the JAX package's
    lowered program lists every group. The first rank's edges, kernels
    and values stand for all. Raises when the ranks' collectives differ
    in number or kind (their schedules diverge)."""
    first = programs[0]
    kinds = [[c.kind for c in p.collectives()] for p in programs]
    if any(k != kinds[0] for k in kinds):
        raise ValueError(f"the ranks' collectives differ: {kinds}")
    colls = []
    for i, c in enumerate(first.collectives()):
        rows = sorted({row for p in programs
                       for row in p.collectives()[i].replica_groups})
        colls.append(dataclasses.replace(c, replica_groups=tuple(rows)))
    return ProgramGraph(first.text, colls, first._stmts, first._args,
                        first.entry, max(p.num_partitions for p in programs),
                        first.kernel_counts(), first.values)
