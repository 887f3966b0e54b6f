#!/usr/bin/env python3
"""Step time of GPT-2 medium training on the fp32 wire and on the int8 wire,
in turns, in one process on one card.

Each arm is ``chip_smoke.py``'s training phase (phase 5 on the fp32 wire,
phase 8 on the int8 wire): GPT-2 medium at full width, bf16 compute on fp32 masters,
remat, 8 × 512 tokens a step, SGD lr 0.01 momentum 0.9 through
``DistributedOptimizer(op=Average)`` in a world of one on NCCL; the int8
arm adds ``compression=Compression.int8_block, error_feedback=True``.
Every arm starts from the same weights (the generator is reseeded) and
runs ``chip_smoke.TRAIN_STEPS`` steps; its step time is the mean of the
steps after the first, on the host clock, each step ending in the loss's
device-to-host copy. Arms run in the order fp32, int8, int8, fp32, ...
(``--repeats`` pairs of each), so drift of the host's speed over the run
falls on both wires alike. Each arm's peak memory is read against what
was allocated when it began; after it, the script reports what its
teardown left allocated before and after a ``gc.collect()``.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/compare_torch_wire_step.py``. It prints one JSON line per
arm and, as its last line, one JSON object with the card's name and power
limit and each wire's arm means.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_arm(wire, seed):
    import torch

    import chip_smoke as cs
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.common import basics

    base = torch.cuda.memory_allocated()
    hvd.init()
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
        model = Transformer(cfg, device="cuda", generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        extra = {}
        if wire == "int8":
            extra = dict(compression=hvd.Compression.int8_block,
                         error_feedback=True)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters(), op=hvd.Average,
            **extra)
        tokens, labels = cs._lm_batch(cfg.vocab_size, cs.TRAIN_BATCH,
                                      cs.TRAIN_SEQ)
        fusion = basics.state().fusion
        fusion.dispatched_bytes = 0
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(cs.TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            opt.zero_grad(set_to_none=True)
            loss = cs._loss(model, tokens, labels)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            step_ms.append((time.monotonic() - t0) * 1e3)
        if fusion.last_wire_format != wire:
            raise SystemExit(f"the {wire} arm's last batch rode the "
                             f"{fusion.last_wire_format} wire")
        if not losses[-1] < losses[0]:
            raise SystemExit(f"the {wire} arm's loss did not fall: {losses}")
        steady = step_ms[1:]
        row = {
            "wire": wire, "step_ms": step_ms,
            "step_ms_mean_after_first": sum(steady) / len(steady),
            "peak_memory_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "allocated_at_start_gb": base / 1e9,
            "wire_bytes_per_step": fusion.dispatched_bytes / cs.TRAIN_STEPS,
            "losses": losses,
        }
        opt.remove_hooks()
        del model, opt, loss
    finally:
        hvd.shutdown()
    row["left_after_arm_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    row["gc_collected"] = gc.collect()
    row["left_after_gc_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4,
                    help="arms of each wire (run fp32, int8, int8, fp32, ...)")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from horovod_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("this script needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    _build.build(["flash_attention", "cuda_kernels"])
    pair = ("fp32", "int8")
    order = [pair[(i // 2 + i) % 2] for i in range(2 * args.repeats)]
    rows = []
    for wire in order:
        row = run_arm(wire, args.seed)
        rows.append(row)
        print(json.dumps(row, sort_keys=True), flush=True)
    means = {w: [r["step_ms_mean_after_first"] for r in rows
                 if r["wire"] == w] for w in pair}
    print(json.dumps({
        "card": card, "torch": torch.__version__, "order": order,
        "step_ms_arm_means": means,
        "step_ms_mean": {w: sum(v) / len(v) for w, v in means.items()},
        "int8_over_fp32": (sum(means["int8"]) / sum(means["fp32"])),
        "peak_memory_gb": {w: max(r["peak_memory_gb"] for r in rows
                                  if r["wire"] == w) for w in pair},
        "left_after_arm_gb": {w: max(r["left_after_arm_gb"] for r in rows
                                     if r["wire"] == w) for w in pair},
    }, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
