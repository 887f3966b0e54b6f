#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one card.

Builds GPT-2 medium (bf16, random weights from ``--seed``) in an
``InferenceEngine`` on the CUDA card, prefills ``--slots`` slots with
prompts of staggered lengths, then:

1. times ``--steps`` decode steps on the host clock, each ending in the
   engine's device-to-host copy of the next tokens (no profiler);
2. profiles the same number of steps with ``torch.profiler`` and prints
   the device's busy share of the wall time (kernel time summed over the
   window, divided by its length; kernels of one step do not overlap on
   the one stream the engine uses) and the kernels by device time.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/profile_torch_decode.py``. It prints one JSON object
as its last line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch import InferenceEngine, Transformer, TransformerConfig
    from horovod_tpu_torch.ops import paged_attention as pa

    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cfg = TransformerConfig.gpt2_medium()
    model = Transformer(cfg, device="cuda", generator=gen)
    engine = InferenceEngine(model, None, slots=args.slots, max_len=cfg.max_len,
                             device="cuda", prefill_ceiling=256)
    rng = np.random.default_rng(args.seed)
    lengths = np.linspace(16, 700, args.slots).astype(int)
    tokens = np.zeros(args.slots, np.int32)
    for n in lengths:
        slot = engine.manager.alloc()
        tokens[slot] = engine.prefill(slot, rng.integers(0, cfg.vocab_size, n))

    def step():
        nxt = engine.decode_step(tokens)
        for slot in range(args.slots):
            engine.manager.advance(slot)
        tokens[:] = nxt

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)

    launches = pa.paged_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    launches = pa.paged_attention.launches - launches
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / args.steps:9.4f} ms/step "
              f"{e.count // args.steps:5d}/step  {e.key[:90]}")
    walls.sort()
    out = {
        "card": card,
        "slots": args.slots,
        "prompt_lengths": [int(n) for n in lengths],
        "steps": args.steps,
        "step_ms_p50": walls[len(walls) // 2],
        "step_ms_min": walls[0],
        "step_ms_max": walls[-1],
        "profiled_step_ms": window_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_busy_share": busy_ms / window_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
        "paged_attention_launches_per_step": launches / args.steps,
        "paged_attention_ms_per_step": sum(
            e.self_device_time_total for e in kernels
            if "paged_decode_kernel" in e.key or "paged_attention_kernel" in e.key
        ) / 1e3 / args.steps,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
