#!/usr/bin/env python3
"""Where a launched gang's start goes, before its first step.

Runs ``python -m horovod_tpu_torch.runner -np N --gloo -H localhost:N``
over this script's rank mode, as ``chip_smoke.py``'s phase 18 starts its
gangs, each rank under ``python -X importtime``. A rank takes the
marks of phase 18's worker, split finer: the interpreter's start,
``import torch``, the TF32 switches, ``use_deterministic_algorithms``,
``import horovod_tpu_torch``, ``hvd.init`` and a first allreduce on the
card; with ``--layers L``, also phase 18's model build at L layers split
into the card's first tensor, the import of ``models``, the weights from
a CUDA generator and the ``DistributedOptimizer`` on the int8 block
wire. ``--phase18`` starts the ranks as phase 18's launcher does (its
allocator and cuBLAS variables, the eager half of
``use_deterministic_algorithms``, no allreduce before the model).
``--elastic`` launches through the elastic driver instead
(``--host-discovery-script`` over ``localhost:N``, as phase 18 (c)
does). The launcher's own time is the span from the launch to a rank's
start. It prints, per rank, the marks in seconds from the launch and
the modules whose imports took longest (``-X importtime``'s cumulative
microseconds, the top level of each import), then the card's name and
power limit.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/profile_start.py [--np 4] [--layers 4] [--phase18]
[--elastic]``. It
prints one JSON object as its last line but one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(out: str, layers: int = 0, phase18: bool = False) -> int:
    t0 = time.time()
    marks = {"start": t0}
    import torch

    marks["torch"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks["tf32_switches"] = time.time()
    if phase18:
        torch._C._set_deterministic_algorithms(True)
    else:
        torch.use_deterministic_algorithms(True)
    marks["deterministic"] = time.time()
    sys.path.insert(0, ROOT)
    import horovod_tpu_torch as hvd

    marks["package"] = time.time()
    hvd.init(device="cuda")
    marks["init"] = time.time()
    if not phase18:
        hvd.allreduce(torch.ones(1024, device="cuda"), op=hvd.Sum)
        torch.cuda.synchronize()
        marks["first_allreduce"] = time.time()
    if layers:
        _model_marks(hvd, layers, marks)
    rank = hvd.rank()
    hvd.shutdown()
    with open(os.path.join(out, f"marks.{rank}.json"), "w") as f:
        json.dump(marks, f)
    return 0


def _model_marks(hvd, layers: int, marks: dict) -> None:
    """Phase 18's ``_w18_model`` (seed 1234, SGD with momentum, the int8
    block wire with error feedback), its parts timed apart."""
    import dataclasses

    import torch

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks["first_tensor"] = time.time()
    from horovod_tpu_torch import Transformer, TransformerConfig

    marks["import_models"] = time.time()
    cfg = dataclasses.replace(TransformerConfig.gpt2_medium(),
                              num_layers=layers, remat=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    model = Transformer(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    marks["model"] = time.time()
    hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters(), op=hvd.Average,
        compression=hvd.Compression.int8_block, error_feedback=True)
    torch.cuda.synchronize()
    marks["optimizer"] = time.time()


def _top_imports(path: str, n: int = 8):
    """The ``n`` slowest top-level imports in a ``-X importtime`` log:
    (cumulative microseconds, module)."""
    rows = []
    try:
        with open(path) as f:
            for line in f:
                if not line.startswith("import time:"):
                    continue
                _, cum, name = line.split(":", 1)[1].split("|")
                # a nested import is indented by two spaces a level
                if cum.strip().isdigit() and not name.startswith("  "):
                    rows.append((int(cum), name.strip()))
    except OSError:
        return []
    return sorted(rows, reverse=True)[:n]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--np", type=int, default=4)
    ap.add_argument("--layers", type=int, default=0,
                    help="also build phase 18's model at this depth")
    ap.add_argument("--phase18", action="store_true",
                    help="start the ranks as phase 18's launcher does")
    ap.add_argument("--elastic", action="store_true",
                    help="launch through the elastic driver")
    ap.add_argument("--rank", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank:
        return rank_main(args.rank, args.layers, args.phase18)
    out = tempfile.mkdtemp(prefix="hvd-start-")
    rank_cmd = [sys.executable, "-X", "importtime",
                os.path.abspath(__file__), "--rank", out,
                "--layers", str(args.layers)] + (
                    ["--phase18"] if args.phase18 else [])
    env = dict(os.environ, PYTHONPATH=ROOT)
    if args.phase18:  # chip_smoke.py's _p18_run
        env.update(CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    hosts = ["-H", f"localhost:{args.np}"]
    if args.elastic:
        script = os.path.join(out, "discover.sh")
        with open(script, "w") as f:
            f.write(f"#!/bin/sh\necho localhost:{args.np}\n")
        os.chmod(script, 0o755)
        hosts = ["--min-np", str(args.np), "--max-np", str(args.np),
                 "--host-discovery-script", script]
    t_launch = time.time()
    rc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(args.np), "--gloo"] + hosts + ["--output-filename", out]
        + rank_cmd, env=env, cwd=ROOT, timeout=600).returncode
    t_end = time.time()
    ranks = []
    for r in range(args.np):
        try:
            with open(os.path.join(out, f"marks.{r}.json")) as f:
                marks = json.load(f)
        except OSError:
            marks = {}
        err = os.path.join(out, f"rank.{r}.err")
        ranks.append({
            "rank": r,
            "marks_s": {k: round(v - t_launch, 3) for k, v in marks.items()},
            "top_imports_us": _top_imports(err)})
    print(json.dumps({"np": args.np, "elastic": args.elastic,
                      "rc": rc, "wall_s": t_end - t_launch,
                      "ranks": ranks}, sort_keys=True))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
