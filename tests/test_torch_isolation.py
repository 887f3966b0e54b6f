"""The PyTorch port stands alone: ``horovod_tpu_torch`` imports no JAX,
no Flax and nothing of the JAX package ``horovod_tpu`` (importing any
of its modules would run ``horovod_tpu/__init__.py``, which imports
JAX). Checked both at run time in a fresh interpreter and statically
over every source file of the package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_pulls_in_no_jax():
    code = (
        "import sys, horovod_tpu_torch, horovod_tpu_torch.serving, "
        "horovod_tpu_torch.ops.paged_attention, "
        "horovod_tpu_torch.optimizer, horovod_tpu_torch.ops.flash_attention, "
        "horovod_tpu_torch.ops.fusion, horovod_tpu_torch.ops.eager, "
        "horovod_tpu_torch.common.basics, horovod_tpu_torch.ops.cuda_kernels, "
        "horovod_tpu_torch.ops.adasum, horovod_tpu_torch.ops._collectives, "
        "horovod_tpu_torch.ops.compression, "
        "horovod_tpu_torch.ops.reduction_ops, horovod_tpu_torch.common.config, "
        "horovod_tpu_torch.common.topology, "
        "horovod_tpu_torch.common.process_sets, "
        "horovod_tpu_torch.common.guard, horovod_tpu_torch.ops.fused_xent, "
        "horovod_tpu_torch.sync_batch_norm, horovod_tpu_torch.models, "
        "horovod_tpu_torch.models.convert, horovod_tpu_torch.ops.traced, "
        "horovod_tpu_torch.ops.overlap, horovod_tpu_torch.ops.int8_wire, "
        "horovod_tpu_torch.common.metrics, horovod_tpu_torch.parallel.fsdp, "
        "horovod_tpu_torch.sharded_optimizer, horovod_tpu_torch.local_sgd, "
        "horovod_tpu_torch.common.retry, horovod_tpu_torch.testing.chaos, "
        "horovod_tpu_torch.testing.recorder, "
        "horovod_tpu_torch.parallel.mesh, horovod_tpu_torch.parallel.tp, "
        "horovod_tpu_torch.parallel.ring_attention, "
        "horovod_tpu_torch.parallel.ulysses, horovod_tpu_torch.parallel.moe, "
        "horovod_tpu_torch.parallel.pipeline, "
        "horovod_tpu_torch.parallel.transformer\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout


def test_sources_import_no_jax():
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders
    # chip_smoke.py drives the port on the card, which has no JAX
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(_forbidden(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _forbidden(node.module or "")


# the scripts that drive the port on the card, which has no JAX
CARD_SCRIPTS = ("scripts/compare_attention_fwd.py",
                "scripts/compare_torch_wire_step.py",
                "scripts/profile_torch_decode.py")


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_import_no_jax(script):
    tree = ast.parse((REPO / script).read_text())
    offenders = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        offenders += [f"{script}:{node.lineno} {n}" for n in names
                      if _forbidden(n)]
    assert not offenders, offenders
