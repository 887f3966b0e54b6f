"""``scripts/hlo_audit_torch.py``, the port's counterpart of
``scripts/hlo_audit.py`` (gated by ``ci.sh``'s audit-smoke): its roster
runs green in one gloo world of 4 processes (2 nodes of 2, the
sub-meshes side by side) and writes its JSON report; each of the four
``--break`` modes exits nonzero with ``invariant violation(s) found``
and its rule's finding, as ci.sh demands of the reference's
``int8-intra``; ``--list`` names every reference entry without a
counterpart, with its reason. And ``scripts/trace_assemble_torch.py
--file`` over a spans file gives the output of
``scripts/trace_assemble.py`` on the same file."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from horovod_tpu_torch.common import tracing

REPO = Path(__file__).resolve().parent.parent
AUDIT = REPO / "scripts" / "hlo_audit_torch.py"
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _reference_roster():
    """The reference's ROSTER names, read from scripts/hlo_audit.py's
    source (importing it would start its JAX mesh)."""
    import ast

    tree = ast.parse((REPO / "scripts" / "hlo_audit.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "ROSTER" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no ROSTER in scripts/hlo_audit.py")


def _audit(*args, timeout=300):
    return subprocess.run([sys.executable, str(AUDIT), *args], cwd=REPO,
                          env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def test_roster_green_in_a_world_of_four(tmp_path):
    out = tmp_path / "audit.json"
    proc = _audit("--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["ok"]
    ported = set(report["programs"])
    missing = {k.split()[0] for k in report["missing"]}
    assert _reference_roster() <= ported | missing
    assert all(p["ok"] and p["rules_checked"]
               for p in report["programs"].values())
    assert "hlo_audit_torch: 17 program(s) green" in proc.stdout


@pytest.mark.parametrize("mode,rule", [
    ("int8-intra", "WireDtype"),
    ("serialized-buckets", "NoInterCollectiveDefUse"),
    ("monolithic-alltoall", "ReplicaGroupStructure"),
    ("undonated-carry", "PoolWrittenInPlace"),
])
def test_break_mode_is_rejected(mode, rule):
    proc = _audit("--break", mode)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 1, text[-3000:]
    assert "invariant violation(s) found" in text
    assert f"[{rule}" in text and "VIOLATED" in text


def test_list_names_every_gap_with_its_reason():
    proc = _audit("--list")
    assert proc.returncode == 0
    lines = proc.stdout.splitlines()
    named = {ln for ln in lines if not ln.startswith(("--", "missing"))}
    gaps = [ln for ln in lines if ln.startswith("missing ")]
    assert _reference_roster() - named == {"serve_warm_start"}
    assert any(ln.startswith("missing serve_warm_start: missing: ")
               for ln in gaps)
    assert all(": missing: " in ln for ln in gaps)
    assert {ln.split()[1] for ln in lines if ln.startswith("--break")} == {
        "int8-intra", "serialized-buckets", "monolithic-alltoall",
        "undonated-carry"}


@pytest.fixture()
def spans_file(tmp_path, monkeypatch):
    """A flight recorder's spans file: the port's trace plane records
    one request over three processes (tests/test_torch_trace_merge.py's
    fleet whose clocks disagree), one record a line."""
    import test_torch_trace_merge as ttm_test

    monkeypatch.setenv("HOROVOD_TRACE", "1")
    monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "1")
    tracing._reset()
    try:
        spans = ttm_test._spans(tracing, ttm_test.FLEETS["three-hosts"])
    finally:
        tracing._reset()
    path = tmp_path / "flight.jsonl.spans"
    path.write_text("".join(json.dumps(r) + "\n" for r in spans))
    return path, spans[0]["trace_id"]


@pytest.mark.parametrize("extra", [[], ["--trace"], ["--list"]],
                         ids=["all", "trace", "list"])
def test_trace_assembler_equals_the_references(tmp_path, spans_file, extra):
    path, tid = spans_file
    if extra == ["--trace"]:
        extra = ["--trace", tid]
    outs = {}
    for name in ("trace_assemble.py", "trace_assemble_torch.py"):
        out = tmp_path / f"{name}.json"
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / name), "--file",
             str(path), "--out", str(out), *extra], cwd=REPO,
            env=dict(ENV, JAX_PLATFORMS="cpu"), capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs[name] = (proc.stdout.replace(str(out), "OUT"),
                      out.read_text() if out.exists() else None)
    assert outs["trace_assemble.py"] == outs["trace_assemble_torch.py"]
    if "--list" not in extra:
        assert json.loads(outs["trace_assemble_torch.py"][1])["traceEvents"]
