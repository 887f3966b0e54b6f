#!/usr/bin/env python3
"""The attention kernels' two variants against each other, in turns, in
one process on one card: the forwards by default, the flash backward
with ``--backward``.

The dispatch rules send bf16 at head_dim 64 or 128 to the tensor cores:
the flash forward to ``hvd_flash_fwd_tc`` (else ``hvd_flash_fwd``), and
a paged call with more than 4 packed rows a KV head to the tiled kernel
on the tensor cores (else the tiled kernel on the CUDA cores). The
CUDA-core kernels run bf16 all the same. This script launches both
variants of each on the same bf16 inputs at ``chip_smoke.py``'s phase-2
shapes (the flash cases gpt2-t512, gpt2-t1024 and gqa-t1024; the paged
chunks prefill256, prefill512 and gqa) and times each by CUDA events
over graph-replayed launches in the order CUDA cores, tensor cores,
tensor cores, CUDA cores (the lower of each pair), beside
``scaled_dot_product_attention`` on the same inputs (the paged chunks:
on the gathered view; timed only, never used by the port) and the
bound ``chip_smoke.py`` computes. Both variants are held to the plain
version first, by ``chip_smoke.py``'s checks.

With ``--backward`` it does the same for the flash backward's dQ and
dK/dV (``hvd_flash_bwd_dq``/``_dkv`` against their ``_tc`` kernels),
given the same delta, at the flash shapes, beside the delta pass, the
whole backward as ``FlashAttentionFunction`` runs it and SDPA's
backward. With ``--train`` it runs ``chip_smoke.py``'s phase 5 instead (GPT-2
medium's training steps, their peak memory and one profiled step: the
device time a step), with ``--serve`` its phase 3 (the burst of 9
requests to ``serve()``: TTFT, TPOT, tokens/s). ``--decode`` times
the decode kernel at the decode shapes (each merge and split width the
checkout has, the host time of 24 eager calls, SDPA and the bound),
``--quantize`` the per-tensor int8 quantizer at phase 7's sizes in fp32
and bf16 (each variant the checkout has, rotating over copies of x
that exceed L2). ``--block-quantize`` times the block quantizer (B3) at
each of phase 7's B3 cases as ``chip_smoke.py`` times them, held bitwise
to plain first, then runs phase 8 (GPT-2 medium on the int8 wire, its
profiled step's device time). ``--train-host`` runs phase 5's model,
batch and optimizer for ``--steps`` steps after two warm-up steps and
prints what a process's host clock depends on: the median host-clock
step and CUDA-event span, the same fixed pure-CPU workload timed before
and after the steps (the process's host speed), the process's CPU time
over its wall time, its threads, and the caching allocator's
``torch.cuda.memory_stats()`` (cudaMalloc calls, retries, peaks);
``--head fp32`` puts back the LM head's earlier product (the fp32
product of the bf16-rounded operands) and ``--import MOD`` imports
extra modules first, so that the arms of a bisection between two
commits run as processes in turns. ``--root DIR``
takes ``chip_smoke.py`` and the package from another checkout: run it
on an unpacked parent commit and on this one in turns to compare the
two in one call.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/compare_attention_fwd.py [--backward | --train |
--train-host [--steps N] [--head fp32] [--import MOD ...] | --serve |
--decode | --quantize | --block-quantize] [--root DIR]``. To
compare a parent commit with this one, unpack it into a git-ignored
directory and run in turns, parent, change, change, parent:
``for r in P . . P; do python3 scripts/compare_attention_fwd.py
--block-quantize --root $r; done``. It prints one JSON line per shape (the phase's
own lines with ``--train`` or ``--serve``) and, as its last line, the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

FLASH_SHAPES = ("gpt2-t512", "gpt2-t1024", "gqa-t1024")


def _in_turns(cs, slow, fast):
    """CUDA cores, tensor cores, tensor cores, CUDA cores; the lower of
    each pair."""
    c1 = cs._time_ms(slow, iters=20)
    t1 = cs._time_ms(fast, iters=20)
    t2 = cs._time_ms(fast, iters=20)
    c2 = cs._time_ms(slow, iters=20)
    return min(c1, c2), min(t1, t2)


def flash_rows(cs, gen, card):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    for case in cs.FLASH_CASES:
        name, b, t, h, kvh, d, causal, lengths, window = case
        if name not in FLASH_SHAPES:
            continue
        q, k, v = (torch.randn((b, t, n, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for n in (h, kvh, kvh))
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)

        def run(entry):
            o = torch.empty_like(q)
            lse = torch.empty((b * h, t), dtype=torch.float32,
                              device=q.device)
            fa._launch(entry, q, [q, k, v, None, None, o, None, lse, None,
                                  None],
                       [q, k, v, None, None, o, None], causal, window, kvh)
            return o, lse

        for entry in ("hvd_flash_fwd", "hvd_flash_fwd_tc"):
            o, lse = run(entry)
            torch.cuda.synchronize()
            cs._check_one_rounding(f"{name} {entry}", o, o_ref)
            if float((lse - lse_ref).abs().max()) > 1e-4:
                cs.fail(f"{name} {entry}: lse differs from plain")
        cuda_ms, tc_ms = _in_turns(cs, lambda i: run("hvd_flash_fwd"),
                                   lambda i: run("hvd_flash_fwd_tc"))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_ms = cs._time_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=h != kvh))
        bound_ms, bound_by = cs._flash_bound("fwd", case)
        print(json.dumps({
            "kernel": "flash_fwd", "name": name, "cuda_cores_ms": cuda_ms,
            "tensor_cores_ms": tc_ms, "speedup": cuda_ms / tc_ms,
            "sdpa_forward_ms": sdpa_ms, "tensor_cores_over_sdpa":
            tc_ms / sdpa_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "tensor_cores_over_bound": tc_ms / bound_ms, "card": card,
        }, sort_keys=True), flush=True)


def paged_rows(cs, gen, card):
    import torch

    from horovod_tpu_torch.ops import paged_attention as pa

    cases = [  # chip_smoke.py's phase-2 chunks
        cs._paged_case("prefill256", 1, 256, 16, 16, 64, 16, 64, [293],
                       gen=gen),
        cs._paged_case("prefill512", 1, 512, 16, 16, 64, 16, 64, [37],
                       gen=gen),
        cs._paged_case("gqa", 4, 3, 32, 8, 128, 16, 64, [0, 17, 100, 500],
                       gen=gen),
    ]
    for c in cases:
        n = len(c["pools"])
        ref = pa.paged_attention_plain(c["q"], *c["pools"][0], c["table"],
                                       c["lengths"])

        def run(variant, i, c=c):
            k, v = c["pools"][i % n]
            return pa._launch(c["q"], k, v, c["table"], c["lengths"], True,
                              variant)

        for variant in ("cuda_cores", "tensor_cores"):
            got = run(variant, 0)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            tol = 2 * cs._ulp_bf16(torch.maximum(got.float().abs(),
                                                 ref.float().abs()))
            if bool((diff > tol).any()):
                cs.fail(f"paged {c['name']} {variant}: beyond 2 bf16 ulp")
        cuda_ms, tc_ms = _in_turns(cs, lambda i: run("cuda_cores", i),
                                   lambda i: run("tensor_cores", i))
        sdpa_ms = _sdpa_gathered(cs, c)
        bound_ms, bound_by = cs._bound(c)
        print(json.dumps({
            "kernel": "paged_attention tiled", "name": c["name"],
            "rows_per_kv_head": c["t"] * c["h"] // c["kvh"],
            "cuda_cores_ms": cuda_ms,
            "tensor_cores_ms": tc_ms, "speedup": cuda_ms / tc_ms,
            "sdpa_gathered_ms": sdpa_ms,
            "tensor_cores_over_sdpa": tc_ms / sdpa_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "tensor_cores_over_bound": tc_ms / bound_ms, "card": card,
        }, sort_keys=True), flush=True)


def _sdpa_gathered(cs, c):
    """SDPA over each pool copy's gathered view (gathered outside the
    timed call), timed as chip_smoke.py's phase 2 times it."""
    import torch
    import torch.nn.functional as F

    b, t, h, kvh, d = c["b"], c["t"], c["h"], c["kvh"], c["d"]
    tbl = c["table"].long().clamp(0, c["pools"][0][0].shape[0] - 1)
    seq = c["n_logical"] * c["page_tokens"]
    gathered = [
        tuple(x[tbl].reshape(b, seq, kvh, d).repeat_interleave(
            h // kvh, dim=2).transpose(1, 2).contiguous() for x in pool)
        for pool in c["pools"]
    ]
    start = c["lengths"].long()
    key_pos = torch.arange(seq, device=start.device)
    q_pos = start[:, None] + torch.arange(t, device=start.device)
    mask = (key_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    qh = c["q"].transpose(1, 2).contiguous()
    n = len(gathered)
    return cs._time_ms(lambda i: F.scaled_dot_product_attention(
        qh, *gathered[i % n], attn_mask=mask))


def _host_ms(fn, calls=24, reps=15):
    """Median host time of ``calls`` eager calls (the wrapper's Python
    and the launch, not the card's time), synchronised between reps."""
    import time

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def decode_rows(cs, gen, card):
    """The decode kernel through the public wrapper at chip_smoke.py's
    decode shapes: graph-replayed device time, the host time of 24 eager
    calls (a decode step's 24 layers), SDPA on the gathered view and the
    bound. Where the checkout's decode kernel splits the keys
    (``SPLIT_KEYS``), at split widths of 32, 64, 128 and 256 keys, timed in
    that order and back (the lower of each pair); the host time at the
    checkout's own width."""
    import torch

    from horovod_tpu_torch.ops import paged_attention as pa

    cases = [  # chip_smoke.py's phase-2 decode shapes
        cs._paged_case("decode", 8, 1, 16, 16, 64, 16, 64,
                       [15, 40, 118, 250, 431, 600, 731, 0],
                       sentinel_rows=(7,), gen=gen),
        cs._paged_case("gqa-decode", 8, 1, 32, 8, 128, 16, 64,
                       [5, 64, 200, 333, 0, 512, 900, 1000], gen=gen),
    ]
    chosen = getattr(pa, "SPLIT_KEYS", None)
    variants = [None] if chosen is None else [32, 64, 128, 256]

    def use(width):
        if width is not None:
            pa.SPLIT_KEYS = width
            pa._plans.clear()

    for c in cases:
        n = len(c["pools"])
        ref = pa.paged_attention_plain(c["q"], *c["pools"][0], c["table"],
                                       c["lengths"])

        def run(i, c=c):
            k, v = c["pools"][i % n]
            return pa.paged_attention(c["q"], k, v, c["table"],
                                      c["lengths"])

        ms = {}
        for variant in variants + variants[::-1]:
            use(variant)
            got = run(0)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            tol = 2 * cs._ulp_bf16(torch.maximum(got.float().abs(),
                                                 ref.float().abs()))
            if bool((diff > tol).any()):
                cs.fail(f"decode {c['name']} {variant}: beyond 2 bf16 ulp")
            t = cs._time_ms(run)
            ms[variant] = min(ms.get(variant, t), t)
        use(chosen)
        host_ms = _host_ms(run)
        sdpa_ms = _sdpa_gathered(cs, c)
        bound_ms, bound_by = cs._bound(c)
        print(json.dumps({
            "kernel": "paged_attention decode", "name": c["name"],
            "ms": {str(w): t for w, t in ms.items()},
            "split_keys": chosen,
            "host_ms_24_calls": host_ms, "sdpa_gathered_ms": sdpa_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "card": card,
        }, sort_keys=True), flush=True)


def quantize_rows(cs, gen, card):
    """The per-tensor quantizer (B2) at chip_smoke.py's phase-7 sizes in
    fp32 and bf16, held bitwise to plain, then graph-replayed while
    rotating over copies of x that together exceed the 50 MB L2 (a
    caller quantizes each tensor once, cold), twice (the lower). Beside:
    the one-read bound, the two-read floor, and each of the kernel's
    launches' device time from ``torch.profiler`` (where it reports
    any)."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    for label, n in cs.WIRE_N.items():
        for dtype in (torch.float32, torch.bfloat16):
            esize = torch.finfo(dtype).bits // 8
            copies = max(2, min(32, -(-120_000_000 // (n * esize))))
            xs = []
            for _ in range(copies):
                x = torch.randn(n, generator=gen, device="cuda")
                x[: n // 3] *= 1e-3
                xs.append(x.to(dtype))
            q, s = ck.int8_quantize(xs[0], seed=3)
            qp, sp = ck.int8_quantize_plain(xs[0], 3)
            torch.cuda.synchronize()
            if not (torch.equal(q, qp) and torch.equal(s, sp)):
                cs.fail(f"int8_quantize {label} {dtype}: differs from "
                        "plain")
            ms = min(cs._time_ms(lambda i: ck.int8_quantize(
                xs[i % copies], seed=i), iters=2 * copies)
                for _ in range(2))
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for i in range(copies):
                    ck.int8_quantize(xs[i], seed=i)
                torch.cuda.synchronize()
            per_kernel = {
                e.key[:60]: e.self_device_time_total / max(e.count, 1) / 1e3
                for e in prof.key_averages()
                if "quantize" in e.key or "absmax" in e.key}
            print(json.dumps({
                "kernel": "int8_quantize", "name": f"{label}",
                "dtype": str(dtype).split(".")[1], "n": n,
                "copies": copies, "ms": ms, "per_kernel_ms": per_kernel,
                "bound_ms": (n * esize + n + 4) / cs.HBM_BYTES_PER_S * 1e3,
                "two_read_floor_ms":
                (2 * n * esize + n + 4) / cs.HBM_BYTES_PER_S * 1e3,
                "card": card,
            }, sort_keys=True), flush=True)
            del xs


def _b3_cases(cs):
    """Phase 7's B3 cases: (label, x, block, rows), from a generator of
    their own; x as phase 7 makes it (a third of it 1e-3 smaller)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 7)

    def draw(m):
        x = torch.randn(m, generator=gen, device="cuda")
        x[: m // 3] *= 1e-3
        return x

    for label, m in cs.WIRE_N.items():
        x = draw(m)
        for block in (512, 1000):
            yield f"{label}, block {block}", x, block, False
    n = cs.WIRE_N["fusion-64MiB"]
    x = draw(n)
    yield "rows 4 x 4194304, block 512", x.view(4, -1), 512, True
    yield "fusion-64MiB, bf16, block 512", x.to(torch.bfloat16), 512, False
    yield "rows 4 x 4194303, block 512", x[: n - 4].view(4, -1), 512, True
    yield ("misaligned x[3:], rows 1 x 16777213, block 512",
           x[3:].view(1, -1), 512, True)


def block_quantize_rows(cs, gen, card):
    """B3 at phase 7's cases: bitwise against plain, then graph-replayed
    on the same x as ``chip_smoke.py`` times it, twice (the lower),
    beside the one-read bound; the variant where the checkout names
    one."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    variant = getattr(ck, "block_quantize_variant", lambda b: "parent")
    for label, x, block, rows in _b3_cases(cs):
        q, s = ck.int8_block_quantize(x, block, seed=5, rows=rows)
        qp, sp = ck.int8_block_quantize_plain(x, block, 5, rows=rows)
        torch.cuda.synchronize()
        if not (torch.equal(q, qp) and torch.equal(s, sp)):
            cs.fail(f"int8_block_quantize[{label}]: differs from plain")
        ms = [cs._time_ms(lambda i: ck.int8_block_quantize(
            x, block, seed=i, rows=rows), iters=20) for _ in range(2)]
        nbytes = x.numel() * (x.element_size() + 1) + s.numel() * 4
        print(json.dumps({
            "kernel": "int8_block_quantize", "name": label, "ms": min(ms),
            "ms_both": ms, "variant": variant(block),
            "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3, "card": card,
        }, sort_keys=True), flush=True)
        del q, qp


def wire_step(cs, gen, card):
    """``chip_smoke.py``'s phase 8: GPT-2 medium trained on the int8 wire;
    its lines carry the profiled step's device time (and, where the
    checkout has it, the split by class). The 0.27 wire-byte check runs
    against the fp32 parameter bytes, which phase 5's fp32 wire carries
    a step."""
    import torch

    from horovod_tpu_torch import Transformer, TransformerConfig

    meta = Transformer(TransformerConfig.gpt2_medium(),
                       device=torch.device("meta"))
    fp32_bytes = sum(p.numel() * 4 for p in meta.parameters())
    del meta
    cs.phase_train_int8(gen, card, fp32_bytes)


def _fp32_head(self, x):
    """The LM head's product before it took bf16 operands with an fp32
    result: the fp32 product of the rounded operands, through autograd
    (a bisection arm; the package never runs it)."""
    w = self.kernel
    if self.cfg.head_mixed_precision:
        x = x.to(self.cfg.dtype)
        w = w.to(self.cfg.dtype)
    return x.float() @ w.float() + self.bias


def _cpu_probe_ms(reps=5, calls=20000):
    """The median of ``reps`` timings of one fixed pure-CPU workload
    (small CPU tensor ops and views, as a step's host side makes)."""
    import time

    import torch

    t = torch.zeros(16)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            t.view(4, 4).add_(1.0).view(-1)
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[len(out) // 2]


def train_host(cs, card, steps, head, imports):
    """Phase 5's model, batch and optimizer (GPT-2 medium, 8 × 512
    tokens, bf16 on fp32 masters, remat, ``DistributedOptimizer(SGD
    momentum)`` in a world of one): ``steps`` host-clock steps after two
    warm-up steps, with what the host clock depends on (see the module's
    docstring)."""
    import dataclasses
    import importlib
    import resource
    import time

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import transformer as tmod

    for mod in imports:
        importlib.import_module(mod)
    if head == "fp32":
        tmod.LMHead.forward = _fp32_head
    probe_before = _cpu_probe_ms()
    hvd.init()
    try:
        cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
        g = torch.Generator(device="cuda")
        g.manual_seed(cs.SEED)
        model = Transformer(cfg, device="cuda", generator=g)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters(), op=hvd.Average)
        tokens, labels = cs._lm_batch(cfg.vocab_size, cs.TRAIN_BATCH,
                                      cs.TRAIN_SEQ)
        fusion = basics.state().fusion
        host, span, losses = [], [], []
        cpu0, wall0 = None, None
        for i in range(2 + steps):
            if i == 2:
                fusion.dispatched_batches = 0
                torch.cuda.reset_peak_memory_stats()
                ru = resource.getrusage(resource.RUSAGE_SELF)
                cpu0, wall0 = ru.ru_utime + ru.ru_stime, time.monotonic()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            start.record()
            opt.zero_grad(set_to_none=True)
            loss = cs._loss(model, tokens, labels)
            loss.backward()
            opt.step()
            end.record()
            losses.append(float(loss.detach()))
            ms = (time.monotonic() - t0) * 1e3
            torch.cuda.synchronize()
            if i >= 2:
                host.append(ms)
                span.append(start.elapsed_time(end))
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu_share = (ru.ru_utime + ru.ru_stime - cpu0) / (
            time.monotonic() - wall0)
        batches = fusion.dispatched_batches / steps
        opt.remove_hooks()
        stats = torch.cuda.memory_stats()
    finally:
        hvd.shutdown()
    with open("/proc/self/status") as f:
        threads = int(next(line for line in f
                           if line.startswith("Threads:")).split()[1])

    def med(v):
        return sorted(v)[len(v) // 2]

    keys = ("num_alloc_retries", "num_device_alloc", "num_device_free",
            "num_ooms", "allocated_bytes.all.peak",
            "reserved_bytes.all.peak", "allocation.all.allocated")
    print(json.dumps({
        "root": os.path.abspath(cs.HERE), "head": head,
        "imports": list(imports), "steps": steps,
        "host_step_ms_median": med(host), "host_step_ms": host,
        "event_span_ms_median": med(span), "losses": losses,
        "cpu_probe_ms_before": probe_before,
        "cpu_probe_ms_after": _cpu_probe_ms(),
        "process_cpu_over_wall": cpu_share, "threads": threads,
        "fused_batches_per_step": batches,
        "torch_threads": torch.get_num_threads(),
        "memory_stats": {k: stats.get(k) for k in keys}, "card": card,
    }, sort_keys=True))


def backward_rows(cs, gen, card):
    """The flash backward's variants (``hvd_flash_bwd_dq``/``_dkv`` on the
    CUDA cores, ``_tc`` on the tensor cores) given the same delta, beside
    the delta pass, the whole backward as ``FlashAttentionFunction`` runs
    it (delta, dQ, dK/dV) and SDPA's backward (forward and backward
    replayed together, less the forward)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    for case in cs.FLASH_CASES:
        name, b, t, h, kvh, d, causal, lengths, window = case
        if name not in FLASH_SHAPES:
            continue
        q, k, v, do = (
            torch.randn((b, t, n, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
            for n in (h, kvh, kvh, h)
        )
        o, lse = fa.flash_fwd_plain(q, k, v, causal)
        a = fa._bwd_inputs(q, k, v, o, lse, do, causal, None, window)
        delta = fa._delta(a.o, a.do)
        dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(q, k, v, o, lse, do,
                                                    causal)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))

        def cuda_cores(entry, out, out2):
            fa._launch(entry, a.q,
                       [a.q, a.k, a.v, None, a.do, out, out2, a.lse, None,
                        delta],
                       [a.q, a.k, a.v, None, a.do, out, out2], causal,
                       window, kvh)

        arms = {
            "dq": (lambda i: cuda_cores("hvd_flash_bwd_dq", dq, None),
                   lambda i: fa._dq(a, delta)),
            "dkv": (lambda i: cuda_cores("hvd_flash_bwd_dkv", dk, dv),
                    lambda i: fa._dkv(a, delta)),
        }
        arms["dq"][0](0)
        arms["dkv"][0](0)
        got = (dq, dk, dv, fa._dq(a, delta), *fa._dkv(a, delta))
        torch.cuda.synchronize()
        for label, g, want in zip(
                ("dq cuda cores", "dk cuda cores", "dv cuda cores",
                 "dq tensor cores", "dk tensor cores", "dv tensor cores"),
                got, (dq_ref, dk_ref, dv_ref) * 2):
            cs._check_one_rounding(f"{name} {label}", g, want)
        row = {"kernel": "flash_bwd", "name": name, "card": card}
        for kind, (slow, fast) in arms.items():
            c1 = cs._time_ms(slow, iters=10)
            t1 = cs._time_ms(fast, iters=20)
            t2 = cs._time_ms(fast, iters=20)
            c2 = cs._time_ms(slow, iters=10)
            row[f"{kind}_cuda_cores_ms"] = min(c1, c2)
            row[f"{kind}_tensor_cores_ms"] = min(t1, t2)
            row[f"{kind}_speedup"] = min(c1, c2) / min(t1, t2)
        row["delta_ms"] = cs._time_ms(lambda i: fa._delta(a.o, a.do))

        def backward(i):
            dl = fa._delta(a.o, a.do)
            fa._dq(a, dl)
            fa._dkv(a, dl)

        row["backward_ms"] = cs._time_ms(backward)
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
        kw = dict(is_causal=causal, enable_gqa=h != kvh)

        def fwd_bwd(i):
            out = F.scaled_dot_product_attention(*leaves, **kw)
            torch.autograd.grad(out, leaves, doh)

        fwd_ms = cs._time_ms(
            lambda i: F.scaled_dot_product_attention(qh, kh, vh, **kw))
        row["sdpa_backward_ms"] = cs._time_ms(fwd_bwd) - fwd_ms
        row["backward_over_sdpa"] = (row["backward_ms"]
                                     / row["sdpa_backward_ms"])
        print(json.dumps(row, sort_keys=True), flush=True)


def serve_burst(cs, gen, card):
    """``chip_smoke.py``'s phase 3: GPT-2 medium in bf16, random weights
    from the seed, and the same 9 prompts."""
    from horovod_tpu_torch import Transformer, TransformerConfig

    cfg = TransformerConfig.gpt2_medium()
    model = Transformer(cfg, device="cuda", generator=gen)
    prompts, _ = cs.serve_prompts(cfg.vocab_size)
    cs.phase_serve(model, prompts, 32, card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--backward", action="store_true",
                      help="time the flash backward's variants instead")
    mode.add_argument("--train", action="store_true",
                      help="run chip_smoke.py's phase 5 instead")
    mode.add_argument("--train-host", action="store_true",
                      help="phase 5's steps with what the host clock "
                      "depends on")
    mode.add_argument("--serve", action="store_true",
                      help="run chip_smoke.py's phase 3 instead")
    mode.add_argument("--decode", action="store_true",
                      help="time the decode kernel instead")
    mode.add_argument("--quantize", action="store_true",
                      help="time the per-tensor int8 quantizer instead")
    mode.add_argument("--block-quantize", action="store_true",
                      help="time the block int8 quantizer and run phase 8 "
                      "instead")
    ap.add_argument("--steps", type=int, default=16,
                    help="--train-host: timed steps")
    ap.add_argument("--head", choices=("mixed", "fp32"), default="mixed",
                    help="--train-host: fp32 puts back the LM head's "
                    "earlier product")
    ap.add_argument("--import", dest="imports", action="append", default=[],
                    help="--train-host: a module to import first")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import from")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a "
                "CUDA device")
    card = cs.card_line()
    from horovod_tpu_torch.ops import _build

    # every kernel built before anything is timed (a build inside the
    # burst would land in its TTFT)
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    if args.train:
        cs.phase_train(gen, card)
    elif args.train_host:
        train_host(cs, card, args.steps, args.head, args.imports)
    elif args.serve:
        serve_burst(cs, gen, card)
    elif args.backward:
        backward_rows(cs, gen, card)
    elif args.decode:
        decode_rows(cs, gen, card)
    elif args.quantize:
        quantize_rows(cs, gen, card)
    elif args.block_quantize:
        block_quantize_rows(cs, gen, card)
        wire_step(cs, gen, card)
    else:
        flash_rows(cs, gen, card)
        paged_rows(cs, gen, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
