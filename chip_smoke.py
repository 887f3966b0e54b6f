#!/usr/bin/env python3
"""Drive the PyTorch port (``horovod_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``)
and no network; it imports no JAX. Phases, each printing its own lines:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   build of every kernel from the repository's sources, timed.
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the main path gives them, with the tolerance stated; each
   timed beside its plain version, a PyTorch library call computing the
   same function (timed only, never used by the port) and its bound.
3. Main path: ``serve()`` of GPT-2 medium (full width, random weights
   from a seed, bf16) answering HTTP ``POST /generate`` requests; the
   kernel launch counters are zeroed just before and read just after.
4. Correctness at full width: the same weights in fp32 serve two
   requests whose greedy tokens must equal the uncached full-forward
   argmax loop.

Then it prints the ``{"kernels": [...]}`` line, the card line, and as
its last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that last line, as does a machine without a CUDA
device or a directory without the package.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
SEED = 1234


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2 kernels


def _ulp_bf16(x):
    """One bf16 ulp at |x|, floored at 2^-6 (outputs nearer zero are
    fp32 sums with cancellation; their absolute error is what counts)."""
    import torch

    mag = x.abs().clamp_min(2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _time_ms(fn, iters: int = 30, warmup: int = 3,
             graph: bool = True) -> float:
    """Mean ms per call of ``fn(i)`` over ``iters`` calls, by CUDA
    events. With ``graph`` the calls are captured once into a CUDA graph
    and the replay is timed: the card's time alone, without the Python
    and launch cost of each call (which the eager timing includes)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    run = lambda: [fn(i) for i in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _paged_case(name, b, t, h, kvh, d, page_tokens, n_logical, starts,
                sentinel_rows=(), gen=None):
    """Inputs at one shape: bf16 pools with scrambled page tables, several
    pool copies so that timing loops rotate over more than the 50 MB L2
    (a decode step reads each layer's pool cold)."""
    import torch

    dev = torch.device("cuda")
    num_pages = b * n_logical
    pool_bytes = 2 * num_pages * page_tokens * kvh * d * 2
    copies = max(1, min(8, math.ceil(160e6 / pool_bytes)))
    pools = [
        (
            torch.randn((num_pages, page_tokens, kvh, d), generator=gen,
                        device=dev).to(torch.bfloat16),
            torch.randn((num_pages, page_tokens, kvh, d), generator=gen,
                        device=dev).to(torch.bfloat16),
        )
        for _ in range(copies)
    ]
    perm = torch.randperm(num_pages, generator=gen, device=dev).cpu()
    table = torch.full((b, n_logical), num_pages, dtype=torch.int32)
    used = 0
    for i, s in enumerate(starts):
        if i in sentinel_rows:
            continue
        live = -(-(s + t) // page_tokens)
        table[i, :live] = perm[used:used + live]
        used += live
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(
        torch.bfloat16
    )
    return {
        "name": name, "q": q, "pools": pools, "table": table.to(dev),
        "lengths": torch.tensor(starts, dtype=torch.int32, device=dev),
        "b": b, "t": t, "h": h, "kvh": kvh, "d": d,
        "page_tokens": page_tokens, "n_logical": n_logical,
        "starts": list(starts),
    }


def _bound(c):
    """Least time for the work: the bytes the function must move (q and
    the output once, each slot's live K/V once, table and lengths) over
    the memory rate, or its multiply-adds over the bf16 peak."""
    b, t, h, kvh, d = c["b"], c["t"], c["h"], c["kvh"], c["d"]
    cap = c["n_logical"] * c["page_tokens"]
    live = sum(min(s + t, cap) for s in c["starts"])
    nbytes = (2 * b * t * h * d * 2 + 2 * live * kvh * d * 2
              + b * c["n_logical"] * 4 + b * 4)
    attended = sum(
        min(s + i + 1, cap) for s in c["starts"] for i in range(t)
    )
    flops = 4 * h * d * attended
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(gen):
    """The paged-attention kernel against its plain version at the main
    path's shapes. Tolerance: 2 bf16 ulp of the output (floored at
    2^-6): both paths compute in fp32 and round once to bf16; only the
    order of the fp32 sums differs."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import paged_attention as pa

    cases = [
        # GPT-2 medium decode: 8 slots, one token each, staggered
        # lengths, one inactive slot whose table is all sentinel
        _paged_case("decode", 8, 1, 16, 16, 64, 16, 64,
                    [15, 40, 118, 250, 431, 600, 731, 0],
                    sentinel_rows=(7,), gen=gen),
        # GPT-2 medium prefill chunks: the main path's 256-token chunk,
        # and a 512-token one, both at starts off a page boundary
        _paged_case("prefill256", 1, 256, 16, 16, 64, 16, 64, [293],
                    gen=gen),
        _paged_case("prefill512", 1, 512, 16, 16, 64, 16, 64, [37],
                    gen=gen),
        # grouped-query attention, 4 query heads per KV head, d = 128:
        # a decode step and a 3-token chunk
        _paged_case("gqa-decode", 8, 1, 32, 8, 128, 16, 64,
                    [5, 64, 200, 333, 0, 512, 900, 1000], gen=gen),
        _paged_case("gqa", 4, 3, 32, 8, 128, 16, 64, [0, 17, 100, 500],
                    gen=gen),
    ]
    results = []
    for c in cases:
        k0, v0 = c["pools"][0]
        args = (c["q"], k0, v0, c["table"], c["lengths"])
        got = pa.paged_attention(*args)
        ref = pa.paged_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"paged_attention {c['name']}: non-finite output")
        diff = (got.float() - ref.float()).abs()
        tol = 2 * _ulp_bf16(torch.maximum(got.float().abs(),
                                          ref.float().abs()))
        max_err = float(diff.max())
        if bool((diff > tol).any()):
            fail(
                f"paged_attention {c['name']}: max |kernel - plain| "
                f"{max_err:.3g} exceeds 2 bf16 ulp"
            )
        n = len(c["pools"])

        def kern(i, c=c):
            k, v = c["pools"][i % n]
            pa.paged_attention(c["q"], k, v, c["table"], c["lengths"])

        def plain(i, c=c):
            k, v = c["pools"][i % n]
            pa.paged_attention_plain(c["q"], k, v, c["table"], c["lengths"])

        # yardstick: SDPA over the gathered view (the gather itself is
        # done outside the timed call)
        b, t, h, kvh, d = c["b"], c["t"], c["h"], c["kvh"], c["d"]
        num_pages = k0.shape[0]
        tbl = c["table"].long().clamp(0, num_pages - 1)
        seq = c["n_logical"] * c["page_tokens"]
        gathered = []
        for k, v in c["pools"]:
            kg = k[tbl].reshape(b, seq, kvh, d).repeat_interleave(
                h // kvh, dim=2).transpose(1, 2).contiguous()
            vg = v[tbl].reshape(b, seq, kvh, d).repeat_interleave(
                h // kvh, dim=2).transpose(1, 2).contiguous()
            gathered.append((kg, vg))
        start = c["lengths"].long()
        key_pos = torch.arange(seq, device=start.device)
        q_pos = start[:, None] + torch.arange(t, device=start.device)
        mask = (key_pos[None, None, :] <= q_pos[:, :, None])[:, None]
        qh = c["q"].transpose(1, 2).contiguous()

        def library(i, c=c):
            kg, vg = gathered[i % n]
            F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask)

        # in turns (plain, kernel, kernel, plain), all graph-replayed;
        # eager_ms is one kernel call as the main path pays it, Python
        # and launch included
        plain_ms = _time_ms(plain)
        kernel_ms = _time_ms(kern)
        library_ms = _time_ms(library)
        kernel_ms2 = _time_ms(kern)
        plain_ms2 = _time_ms(plain)
        eager_ms = _time_ms(kern, graph=False)
        bound_ms, bound_by = _bound(c)
        r = {
            "name": c["name"],
            "shape": {k: c[k] for k in ("b", "t", "h", "kvh", "d",
                                        "page_tokens", "n_logical",
                                        "starts")},
            "max_abs_err": max_err,
            "ms": min(kernel_ms, kernel_ms2),
            "plain_ms": min(plain_ms, plain_ms2),
            "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "eager_ms": eager_ms,
        }
        log(f"kernel paged_attention[{c['name']}]: "
            + json.dumps(r, sort_keys=True))
        results.append(r)
    return results


# ------------------------------------------------------- phase 3 main path


def _post(port: int, payload: dict, timeout: float = 180.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _burst(port: int, prompts, max_tokens: int):
    """POST every prompt at once, one client thread each; returns the
    (status, body) pairs in prompt order and the wall seconds."""
    results = [None] * len(prompts)

    def one(i):
        try:
            results[i] = _post(port, {"tokens": prompts[i],
                                      "max_tokens": max_tokens})
        except Exception as e:  # reported as a failed request below
            results[i] = (0, {"status": f"client error: {e}"})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results, time.monotonic() - t0


def _check_burst(phase, results, prompts, max_tokens):
    for i, (code, body) in enumerate(results):
        if code != 200 or body.get("status") != "done":
            fail(f"{phase}: request {i} ({len(prompts[i])} prompt "
                 f"tokens) came back {code} {body.get('status')!r}")
        if len(body["tokens"]) != max_tokens:
            fail(f"{phase}: request {i} returned {len(body['tokens'])} "
                 f"tokens, expected {max_tokens}")


def phase_serve(model, prompts, max_tokens, card):
    """serve() of the bf16 GPT-2 medium model over HTTP; every request
    must come back ``done`` with ``max_tokens`` tokens, through the
    kernel and with no fallback."""
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.ops import paged_attention as pa

    pa.paged_attention.launches = 0
    handle = serve(model, None, port=0, slots=8, prefill_ceiling=256,
                   max_new_tokens=max_tokens, addr="127.0.0.1",
                   handle_sigterm=False, device="cuda")
    try:
        results, wall = _burst(handle.port, prompts, max_tokens)
        launches = pa.paged_attention.launches
        stats = handle.engine.stats()
        mgr = handle.engine.manager.stats()
        slo = handle.batcher.recorder.summaries()
    finally:
        handle.stop()
    _check_burst("serve", results, prompts, max_tokens)
    if not handle.engine.paged_attn:
        fail("serve: the engine resolved paged_attn off on the card")
    if launches <= 0 or stats["paged_attn_calls"] <= 0:
        fail(f"serve: paged attention launches {launches}, engine "
             f"paged_attn_calls {stats['paged_attn_calls']}")
    if stats["paged_attn_fallbacks"]:
        fail(f"serve: {stats['paged_attn_fallbacks']} paged-attention "
             "fallbacks")
    if stats["chunked_prefill_chunks"] <= 0:
        fail("serve: no prompt streamed in chunks")
    if mgr["prefix_hits"] <= 0:
        fail("serve: the shared leading page was never attached")
    tokens_out = sum(len(body["tokens"]) for _, body in results)
    summary = {
        "requests": len(prompts),
        "prompt_tokens": [len(p) for p in prompts],
        "max_tokens": max_tokens,
        "tokens_out": tokens_out,
        "wall_s": wall,
        "tokens_per_s": tokens_out / wall,
        "ttft_ms_p50": slo["ttft_ms"]["p50"],
        "ttft_ms_p95": slo["ttft_ms"]["p95"],
        "tpot_ms_p50": slo["tpot_ms"]["p50"],
        "tpot_ms_p95": slo["tpot_ms"]["p95"],
        "decode_steps": stats["decode_steps"],
        "prefills": stats["prefills"],
        "chunked_prefill_chunks": stats["chunked_prefill_chunks"],
        "prefix_hits": mgr["prefix_hits"],
        "paged_attn_calls": stats["paged_attn_calls"],
        "paged_attn_fallbacks": stats["paged_attn_fallbacks"],
        "kernel_launches": launches,
        "card": card,
    }
    log("serve: " + json.dumps(summary, sort_keys=True))
    return launches


def _full_forward_greedy(model, prompt, n):
    import torch

    seq = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([seq], device=model.device))
            seq.append(int(logits[0, -1].argmax()))
    return seq[len(prompt):]


def phase_fp32(model32, prompts, max_tokens):
    """The same weights in fp32 served over HTTP: greedy tokens must
    equal the uncached full-forward argmax loop."""
    from horovod_tpu_torch import serve

    handle = serve(model32, None, port=0, slots=2, prefill_ceiling=256,
                   max_new_tokens=max_tokens, addr="127.0.0.1",
                   handle_sigterm=False, device="cuda")
    try:
        results, _ = _burst(handle.port, prompts, max_tokens)
        if not handle.engine.paged_attn:
            fail("fp32: the engine resolved paged_attn off on the card")
    finally:
        handle.stop()
    _check_burst("fp32", results, prompts, max_tokens)
    for prompt, (_, body) in zip(prompts, results):
        want = _full_forward_greedy(model32, prompt, max_tokens)
        if body["tokens"] != want:
            fail(f"fp32: served tokens {body['tokens']} differ from the "
                 f"full-forward argmax loop {want}")
    log(f"fp32: {len(prompts)} requests of {[len(p) for p in prompts]} "
        f"prompt tokens match the full-forward argmax loop "
        f"({max_tokens} tokens each)")


# ------------------------------------------------------------------ main


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA device")
    sys.path.insert(0, HERE)
    try:
        import horovod_tpu_torch  # noqa: F401
        from horovod_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the horovod_tpu_torch package is not beside this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device and build
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.monotonic()
    _build.build(names)
    log(f"build: {names} in {time.monotonic() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = re.findall(r"(\d+) bytes spill stores", text)
        log(f"  ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{sum(1 for s in spills if int(s))} with spill stores")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    kernel_results = phase_kernels(gen)

    # phase 3: GPT-2 medium at full width, random weights from the seed;
    # the fp32 copy for phase 4 is taken first (serving the bf16 model
    # stores its matmul weights in bf16)
    import dataclasses

    import numpy as np

    from horovod_tpu_torch import Transformer, TransformerConfig

    cfg = TransformerConfig.gpt2_medium()
    model = Transformer(cfg, device="cuda", generator=gen)
    model32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                          device="cuda")
    model32.load_state_dict(model.state_dict())
    rng = np.random.default_rng(SEED)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    shared = prompt(16)  # one full page both requests below start with
    prompts = [prompt(n) for n in (16, 33, 64, 129, 250, 400, 700)]
    prompts += [shared + prompt(24), shared + prompt(41)]
    t0 = time.monotonic()
    launches = phase_serve(model, prompts, 32, card)
    log(f"serve phase: {time.monotonic() - t0:.2f} s")

    # phase 4: correctness at full width in fp32
    t0 = time.monotonic()
    phase_fp32(model32, [prompt(24), prompt(300)], 32)
    log(f"fp32 phase: {time.monotonic() - t0:.2f} s")

    decode = kernel_results[0]
    entry = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "horovod_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "horovod_tpu/ops/paged_attention.py:308",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results),
        "ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"],
        "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "shape": decode["shape"],
        "shapes": kernel_results,
    }
    log(json.dumps({"kernels": [entry]}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
