#!/usr/bin/env python3
"""Drive the PyTorch port (``horovod_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``)
and no network; it imports no JAX. Phases, each printing its own lines:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   build of every kernel from the repository's sources, timed.
2. Kernels against their plain PyTorch versions on the card, at the
   shapes the main paths give them (paged attention: serving, and the
   decode kernel at the edges of its 64-key splits in bf16, fp32 and
   fp16; flash
   attention forward, the backward's delta pass, dQ and dK/dV:
   training; each paged and flash row names the variant that ran:
   decode, tensor cores or CUDA cores), with the tolerance stated; each
   timed beside its plain version, a PyTorch library call computing the
   same function (timed only, never used by the port) and its bound.
3. Main path: ``serve()`` of GPT-2 medium (full width, random weights
   from a seed, bf16) answering HTTP ``POST /generate`` requests; the
   kernel launch counters are zeroed just before and read just after.
   Decode and chunk launches are reported apart; every chunk launch
   (more than 4 packed rows a KV head) must take the tensor cores.
4. Correctness at full width: the same weights in fp32 serve two
   requests whose greedy tokens must equal the uncached full-forward
   argmax loop; fp32 launches no tensor-core kernel, and its decode
   steps launch the decode kernel.
5. Training, the second main path: GPT-2 medium (full width, random
   weights from the seed, bf16 compute on fp32 master weights, remat)
   takes a few steps through ``hvd.init()`` (a world of one on NCCL),
   ``hvd.broadcast_parameters`` and ``hvd.DistributedOptimizer(SGD)``
   on the learnable sequence of examples/transformer_lm.py, with the
   flash-attention launch counters zeroed just before. The loss must
   fall, each step must launch the forward kernel 48 times (24 layers,
   and 24 again in the remat recompute), the delta pass and each
   backward kernel 24 times, every forward, dQ and dK/dV launch on the
   tensor cores, and the fusion layer must dispatch fused allreduces.
   One more step runs under ``torch.profiler``.
6. The flash kernels inside the whole backward: one fp32 training step
   at full width through the kernels (the CUDA-core variants, by the
   dispatch rule: no tensor-core launch) and through dense attention
   must give the same loss and gradients.
7. The wire kernels (scale-cast, the two int8 quantizers, Adasum's dots
   and apply passes) against their plain versions at the sizes the
   paths use: bit for bit for the first three (the per-tensor quantizer
   in fp32 and bf16; the block quantizer in each of its variants, in
   fp32, bf16 and fp16, flat, as rows and on a misaligned view), within
   1e-5 (fp32) or one rounding (bf16) for Adasum; the stochastic
   contract on the card.
8. Training on the int8 wire: phase 5 again through
   ``DistributedOptimizer(compression=Compression.int8_block,
   error_feedback=True)``; the loss must fall, each fused batch must run
   the block quantizer twice, and the wire bytes a step must stay under
   0.27 × phase 5's. One more step runs under ``torch.profiler``, its
   device time split by class: B3, the exchanges, and the wire's
   plain-PyTorch pack, dequantize-sum, residual and unpack passes.
9. Adasum and the codec: GPT-2 medium's gradients of 4 microbatches
   combined tensor by tensor with Adasum's tree (882 launches each of
   the dots and apply kernels), held against the plain tree and the
   fp64 host oracle, then an SGD step; ``hvd.allreduce(op=hvd.Adasum)``
   in the world of one returns its input; every parameter through
   ``Compression.int8`` compress → ``hvd.broadcast`` → decompress.
10. ViT-B/16 at full width (bf16 on fp32 masters): 197 tokens
   right-padded to 200 with lengths 197 (``flash_pad="auto"``), 64
   images of 224² from the seed, a few steps through ``hvd.init`` and
   ``DistributedOptimizer``. The loss must fall; each step must launch
   the flash forward, delta, dQ and dK/dV kernels 12 times each (12
   layers), all on the tensor cores. Phase 2 holds the kernels against their plain versions at
   this shape (``vit-b16-t200``).
11. ResNet-50 at full width, 64 images of 224², its batch statistics
   synced through the port's ``SyncBatchNorm`` reductions in the world
   of one: the loss must fall and the running statistics move; one step
   synced must equal it with local batch norm (the loss in fp32; the
   gradients and running statistics in fp64). Then one step each
   of the MNIST ConvNet, VGG-16 (32 at 224²) and Inception V3 (32 at
   299²), each with a finite falling loss.
12. GPT-2 medium with ``fused_linear_cross_entropy`` on the
   Transformer's ``return_hidden``: the loss and its gradients (hidden
   states, kernel, bias) within one bf16 rounding of the dense loss's on
   the same hidden states; the whole model's gradients no farther from
   the dense loss's than 1.25 times what one bf16 rounding of the
   hidden states' gradient moves them (measured in the run, beside a
   planted fault the check must see); the peak memory of
   training steps each way beside phase 5's; ``flush()`` after 6
   passes at ``backward_passes_per_step=4``; a guarded step with an
   injected NaN, which must skip.
13. The two-level route: 4 processes on the one card in a gloo world
   (NCCL refuses two ranks on one device) that each makes and
   ``hvd.init`` adopts, ``HOROVOD_INTRA_SIZE=2`` and
   ``HOROVOD_HIERARCHICAL=on`` (2 nodes of 2). On integer-valued fp32
   the two-level allreduce equals the flat route and the exact sum bit
   for bit, as do reducescatter (even, uneven), alltoall (equal, with
   splits), the grouped ops and a join-masked Average;
   ``Compression.hier_int8`` on a 64 MiB batch stays within its
   two-stage quantum budget; hierarchical Adasum within 2.0e-7 of the
   fp64 host oracle in fp32 and within 6 quanta on the int8 inter wire;
   GPT-2 medium at full width trains 3 steps through
   ``DistributedOptimizer(compression=Compression.hier_int8,
   error_feedback=True)``, the mean loss falling and every rank's
   parameters bitwise equal after every step. It prints the step time,
   the bytes a step by hop beside the model and phase 5's, and each
   rank's peak memory. B3, B4 and the flash kernels must launch.
14. The bucketed overlap and the in-step collectives (``hvd.traced``).
   (a) Phase 5's GPT-2 medium through
   ``DistributedOptimizer(overlap_buckets=4)`` and with overlap off, on
   the same state and 3 batches, in turns: the parameters bitwise equal
   after every step, one collective a bucket a step and no fused batch,
   bucket 0's collective issued before backward's last kernel ends (CUDA
   events on the compute stream), one step profiled with a range a
   bucket; the host-clock step, busy share and peak printed beside
   phase 5's. (b) The parameters through ``overlap_boundary``: the
   gradients bitwise (a)'s reduced ones. (c) ``torch.compile(fullgraph=
   True)`` (Inductor, without fma contraction) of ``traced.allreduce``,
   ``traced.quantized_allreduce`` (per-row and block 512) and
   ``bucketed_allreduce(compression=Compression.int8_block,
   residuals=)`` on a 64 MiB batch: bitwise the eager call, B2 and B3
   launched inside the compiled call, within the two-stage budget; both
   timed. (d) A gloo world of 4 on the card as phase 13's: ``traced``'s
   allreduce, reducescatter, allgather and alltoall and the two-level
   recipe at fp32 bit for bit on integers, the quantized wires within
   their budgets, and 2 steps of GPT-2 medium through
   ``DistributedOptimizer(overlap_buckets=4,
   compression=Compression.hier_int8, error_feedback=True)``, every
   rank's parameters equal after each step.
15. ZeRO (``ShardedDistributedOptimizer``, AdamW lr 1e-4, 4 buckets).
   (a) Phase 5's GPT-2 medium in the world of one on NCCL, stages 1, 2
   and 3 on the fp32 wire, each beside ``DistributedOptimizer(AdamW)``
   on the same state and 3 batches, in turns: the parameters bitwise
   equal after every step, one reduce-scatter and one all-gather a
   bucket a step (counted), the flash kernels on the tensor cores; the
   host-clock step each way, and each stage's bytes resident between
   steps and peak of a step. (b) A gloo world of 4 processes on the card
   (as phase 13's), a quarter of the batch a rank, 3 steps each of
   stages 1, 2, 3 on fp32 and stage 2 on ``wire="int8"`` with error
   feedback: every rank's parameters bitwise equal after every step,
   stages 2 and 3 bitwise stage 1, the int8 arm's loss falling with B3
   launched, stage 3's live parameter-and-gradient bytes at least 1.8×
   below stage 1's a rank (``bench_zero.py:20-31``'s count) and stage
   2's peak below stage 1's, beside the allocator's readings.
16. Local SGD (``local_sgd_steps=2``): a flat gloo world of 4 processes
   on the card (as phase 13's), 2 slices of 2 (``local_sgd_intra=2``), a
   quarter of phase 5's batch a rank. (a) GPT-2 medium through
   ``DistributedOptimizer(SGD momentum, op=Average,
   local_sgd_inter_wire="int8")`` and (b) through
   ``ShardedDistributedOptimizer(AdamW, zero_stage=2)``, 4 steps each
   driven by ``local_sgd.maybe_sync``: after a local step each slice's
   ranks bitwise equal and the slices apart, after each round all four
   equal; every collective of a local step inside its slice (counted at
   the calls by ``horovod_tpu_torch.testing.recorder``); B3 and B4
   launched in every round; the ``local_sgd.*`` counters, and
   ``inter_bytes`` equal to ``round_inter_bytes`` beside the bytes handed
   to the inter group's calls; the residual bitwise the remainder of
   B3's plain pre-quantization; the mean loss falling; each rank's
   resident and peak memory. (c) One 1 M-element vector a slice through
   the grouped Adasum: fp32 within rtol 1e-5, atol 1e-6 of the fp64
   host oracle, int8 within 2 quanta of fp32, every rank the same bits.
   (d) On (a)'s optimizer after one more local step,
   ``local_sgd.sync@1:reset;local_sgd.sync@2:reset`` on rank 0 with 2
   attempts: the round defers on every rank, leaving the parameters,
   and the next one reconciles them; the world runs under a time limit.
17. Model parallelism (``horovod_tpu_torch/parallel/``): the composed
   dp × pp × ep × sp × tp transformer in a gloo world of 4 processes on
   the card (as phase 13's), GPT-2 medium's widths (24 layers, d_model
   1024, 16 heads of 64, d_ff 4096, max_len 1024) with the vocabulary
   50304 (GPT-2's 50257 padded to a multiple of 128, as Megatron-LM
   pads it, so that tp = 2 splits the vocab-parallel head), 4 experts,
   weights from the seed, 8 sequences of 1024 tokens of the learnable
   sequence. (a) ``MeshSpec(sp=2, tp=2)`` on the flash ring
   (``flash_ring=True``), bf16 on fp32 masters, SGD lr 0.1, 3 steps: the
   mean loss falls, each rank's B5/B6 launches (forward, delta, dQ,
   dK/dV) equal the counts predicted from the ring's live hops, every
   launch on the tensor cores, replicated leaves bitwise equal on the
   ranks that hold them. (b) ``MeshSpec(pp=2, ep=2)``, 1F1B with 4
   microbatches and ``moe_wire="int8"``: the same, B3 launched at every
   dispatch and return (its count exact) and the 1F1B stash within
   ``max_in_flight + 1``. (c) One fp32 SGD step at 4 layers (capacity
   8.0) on dp 4, sp 2 × tp 2 (flash ring), pp 2 × ep 2 (1F1B) and dp 2 ×
   sp 2 (dense ring): every rank's parameters within rtol 5e-4, atol
   1e-5 of dp 4's, the losses within rtol 1e-5. (d) ``ulysses_attention``
   over sp 4 (b 8, t 1024, 16 heads of 64, bf16, causal) and
   ``ring_flash_attention`` over sp 4 with 16 q heads over 4 KV heads,
   forward and gradients through B5/B6, each against its plain twin on
   the same rank: Ulysses within one bf16 rounding, the ring within one
   a live hop; ``hierarchical_alltoall`` (2 nodes of 2) bitwise the flat
   alltoall on integer-valued fp32 and on the int32 expert map, and
   ``quantized_alltoall`` within one quantum of its block, pad slots
   exact zeros. It prints each arm's step times, each rank's peak
   memory and the launch counts.
   The flash counts of phases 5, 10, 12, 13, 14, 15, 16 and 17, and the
   wire counts of phases 8, 9, 13, 14, 15, 16 and 17, add up in the
   ``kernels`` line.

``python3 chip_smoke.py --only 17`` builds the kernels and runs phase 17
alone (a development aid; it prints no ``ok`` line). ``--log FILE``
also writes every line printed after the card and the package are found
to ``FILE``.

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
FP32_FLOPS = 67e12         # H100 SXM fp32 peak outside the tensor cores
SEED = 1234


# with --log FILE every line also goes to FILE once main() has found the
# card and the package: a runner that keeps only the end of the output
# would lose the phases' lines behind the kernels line
_keep = {"file": None}


def _write(line: str) -> None:
    if _keep["file"]:
        with open(_keep["file"], "a") as f:
            f.write(line + "\n")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    _write(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)
    _write(msg)


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
    (a decode step reads each layer's pool cold). The case's
    ``variant``: None takes the dispatch rule's kernel, a name forces
    that variant."""
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
        "variant": None, "esize": 2,
        "b": b, "t": t, "h": h, "kvh": kvh, "d": d,
        "page_tokens": page_tokens, "n_logical": n_logical,
        "starts": list(starts),
    }


def _bound(c):
    """Least time for the work: the bytes the function must move (q and
    the output once, each slot's live K/V once, table and lengths) over
    the memory rate, or its multiply-adds over the peak of their type
    (bf16 and fp16 on the tensor cores, fp32 outside them)."""
    b, t, h, kvh, d, e = (c["b"], c["t"], c["h"], c["kvh"], c["d"],
                          c["esize"])
    cap = c["n_logical"] * c["page_tokens"]
    live = sum(min(s + t, cap) for s in c["starts"])
    nbytes = (2 * b * t * h * d * e + 2 * live * kvh * d * e
              + b * c["n_logical"] * 4 + b * 4)
    attended = sum(
        min(s + i + 1, cap) for s in c["starts"] for i in range(t)
    )
    flops = 4 * h * d * attended
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (FP32_FLOPS if e == 4 else BF16_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(gen):
    """The paged-attention kernels against their plain version at the
    main paths' shapes, each row naming the variant that ran (decode,
    or the tiled kernel on the tensor cores or CUDA cores).
    Tolerance in bf16: 2 bf16 ulp of the output (floored at 2^-6): both
    paths compute in fp32 and round once to bf16; the order of the fp32
    sums differs, and the tensor-core kernel feeds P to P·V as a bf16
    pair (about 2^-17 relative a term). In fp32 (phase 4's serve, on the
    CUDA cores): 1e-5 absolute plus 1e-5 relative, the order of the sums
    alone."""
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
    # the tiled kernel on the CUDA cores, on prefill256's inputs: phase
    # 4's fp32 chunk, and the bf16 chunk forced past the rule
    base = cases[1]
    cases[3:3] = [
        dict(base, name="prefill256-fp32", esize=4, q=base["q"].float(),
             pools=[(k.float(), v.float()) for k, v in base["pools"]]),
        dict(base, name="prefill256-cuda-cores", variant="cuda_cores"),
    ]
    # the decode kernel at its split edges (64-key splits of a 64-page
    # table): lengths 0, one below a split, exactly one, one above, two
    # splits, the full table; in bf16, and in fp32 (phase 4's serve) and
    # fp16
    edges = _paged_case("decode-edges", 7, 1, 16, 16, 64, 16, 64,
                        [0, 62, 63, 64, 65, 127, 64 * 16 - 1], gen=gen)
    cases += [
        edges,
        dict(edges, name="decode-edges-fp32", esize=4,
             q=edges["q"].float(),
             pools=[(k.float(), v.float()) for k, v in edges["pools"]]),
        dict(edges, name="decode-edges-fp16", q=edges["q"].half(),
             pools=[(k.half(), v.half()) for k, v in edges["pools"]]),
        _paged_case("gqa-decode-edges", 7, 1, 32, 8, 128, 16, 64,
                    [0, 62, 63, 64, 65, 127, 64 * 16 - 1], gen=gen),
    ]
    results = []
    for c in cases:
        k0, v0 = c["pools"][0]
        args = (c["q"], k0, v0, c["table"], c["lengths"])
        n = len(c["pools"])

        def kern(i, c=c):
            k, v = c["pools"][i % n]
            if c["variant"] is None:
                return pa.paged_attention(c["q"], k, v, c["table"],
                                          c["lengths"])
            return pa._launch(c["q"], k, v, c["table"], c["lengths"], True,
                              c["variant"])

        before = (pa.paged_attention.chunk_launches,
                  pa.paged_attention.tc_launches)
        got = kern(0)
        variant = c["variant"] or (
            "decode" if pa.paged_attention.chunk_launches == before[0]
            else "tensor_cores" if pa.paged_attention.tc_launches
            > before[1] else "cuda_cores")
        ref = pa.paged_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"paged_attention {c['name']}: non-finite output")
        diff = (got.float() - ref.float()).abs()
        if got.dtype == torch.float32:
            tol, what = 1e-5 + 1e-5 * ref.abs(), "1e-5 + 1e-5 relative"
        else:
            tol = 2 * _ulp_bf16(torch.maximum(got.float().abs(),
                                              ref.float().abs()))
            what = "2 bf16 ulp"
        max_err = float(diff.max())
        if bool((diff > tol).any()):
            fail(
                f"paged_attention {c['name']} ({variant}): max |kernel - "
                f"plain| {max_err:.3g} exceeds {what}"
            )

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
            "variant": variant,
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


FLASH_CASES = [
    # (name, b, t, h, kvh, d, causal, lengths, window)
    # GPT-2 medium training, the main path's shape
    ("gpt2-t512", 8, 512, 16, 16, 64, True, None, None),
    ("gpt2-t1024", 8, 1024, 16, 16, 64, True, None, None),
    # BERT-large's bidirectional attention
    ("bert-full-t512", 8, 512, 16, 16, 64, False, None, None),
    # grouped-query attention, 4 query heads per KV head, d = 128
    ("gqa-t1024", 4, 1024, 32, 8, 128, True, None, None),
    # right-padded batch
    ("lengths-t512", 8, 512, 16, 16, 64, True,
     [512, 500, 431, 300, 257, 129, 64, 1], None),
    # causal sliding window
    ("window-t1024", 8, 1024, 16, 16, 64, True, None, 256),
    # a length that is no multiple of the 64-row tile
    ("ragged-t1000", 8, 1000, 16, 16, 64, True, None, None),
    # ViT-B/16 (phase 10): bidirectional, 197 tokens right-padded to 200
    # (the last 64-key tile partial), lengths 197 in every row
    ("vit-b16-t200", 64, 200, 12, 12, 64, False, [197] * 64, None),
]


def _flash_pairs(t, causal, lengths, window, b, pad_rows):
    """Attended (query, key) pairs of one head, summed over the batch:
    the work this run's masks leave."""
    import torch

    q = torch.arange(t)[:, None]
    k = torch.arange(t)[None, :]
    valid = torch.ones((t, t), dtype=torch.bool)
    if causal:
        valid = k <= q
    if window:
        valid = valid & (q - k < window)
    if lengths is None:
        return b * int(valid.sum())
    total = 0
    for n in lengths:
        v = valid & (k < n)
        if pad_rows:
            v = v & (q < n)
        total += int(v.sum())
    return total


def _flash_bound(kind, c):
    """Least time for one kernel's work: each input read once and each
    output written once over the memory rate, or its multiply-adds (2
    FLOP each) over the bf16 peak. Forward: q, k, v in, o and the fp32
    lse out, QKᵀ and PV (4·d FLOP a pair). Delta: o and dO in, the fp32
    delta out, d multiply-adds a row. dQ: q, k, v, dO, lse and delta in,
    dq out, S, dP and dS·K (6·d). dK/dV: the same in, dk and dv out, S,
    dP, Pᵀ·dO and dSᵀ·Q (8·d). The products count once: the hi/lo
    halves the tensor-core kernels issue are their own cost."""
    name, b, t, h, kvh, d, causal, lengths, window = c
    q_bytes, kv_bytes = b * t * h * d * 2, b * t * kvh * d * 2
    row_bytes = b * h * t * 4  # one fp32 per (batch-head, row)
    lse_bytes = row_bytes + (b * 4 if lengths else 0)
    if kind == "delta":
        nbytes = 2 * q_bytes + row_bytes
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2 * b * t * h * d / BF16_FLOPS
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")
    if kind == "fwd":
        nbytes = 2 * q_bytes + 2 * kv_bytes + lse_bytes
        flop_per_pair = 4 * d
    elif kind == "dq":
        nbytes = 3 * q_bytes + 2 * kv_bytes + lse_bytes + row_bytes
        flop_per_pair = 6 * d
    else:
        nbytes = 2 * q_bytes + 4 * kv_bytes + lse_bytes + row_bytes
        flop_per_pair = 8 * d
    pairs = h * _flash_pairs(t, causal, lengths, window, b,
                             pad_rows=kind != "fwd")
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * flop_per_pair / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_one_rounding(label, got, ref):
    """|kernel − plain| within one bf16 ulp of the larger magnitude
    (floored at 2^-6): both compute in fp32 and round once to bf16, so
    only a rounding that the fp32 sum order tips may differ."""
    import torch

    if not torch.isfinite(got.float()).all():
        fail(f"{label}: non-finite output")
    diff = (got.float() - ref.float()).abs()
    tol = _ulp_bf16(torch.maximum(got.float().abs(), ref.float().abs()))
    if bool((diff > tol).any()):
        fail(f"{label}: max |kernel - plain| {float(diff.max()):.3g} "
             f"exceeds one bf16 rounding")
    return float(diff.max())


def phase_flash_kernels(gen):
    """The flash-attention kernels (forward, the backward's delta pass,
    dQ and dK/dV) against their plain versions at the training path's
    shapes, each timed beside its plain version, its bound and the
    PyTorch library call computing the same function
    (``scaled_dot_product_attention``: its forward for the forward
    kernel, its backward for dQ and dK/dV together; timed only, never
    used by the port). dQ and dK/dV are timed given delta, as the
    backward calls them; each forward, dQ and dK/dV row names the
    variant that ran (``tensor_cores`` or ``cuda_cores``) by the launch
    counters."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import flash_attention as fa

    results = {"fwd": [], "delta": [], "dq": [], "dkv": []}
    dev = torch.device("cuda")
    for c in FLASH_CASES:
        name, b, t, h, kvh, d, causal, lengths, window = c

        def rnd(heads):
            return torch.randn((b, t, heads, d), generator=gen,
                               device=dev).to(torch.bfloat16)

        q, k, v, do = rnd(h), rnd(kvh), rnd(kvh), rnd(h)
        lens = (None if lengths is None else
                torch.tensor(lengths, dtype=torch.int32, device=dev))
        kw = dict(causal=causal, lengths=lens, window=window)
        fwd_tc_before = fa.flash_fwd.tc_launches
        o, lse = fa.flash_fwd(q, k, v, **kw)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
        delta = fa.flash_bwd_delta(o_ref, do)
        tc_before = (fa.flash_bwd_dq.tc_launches,
                     fa.flash_bwd_dkv.tc_launches)
        dq = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, delta=delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do, delta=delta,
                                  **kw)
        variant = {
            kind: ("tensor_cores" if fn.tc_launches > before
                   else "cuda_cores")
            for kind, fn, before in (("fwd", fa.flash_fwd, fwd_tc_before),
                                     ("dq", fa.flash_bwd_dq, tc_before[0]),
                                     ("dkv", fa.flash_bwd_dkv,
                                      tc_before[1]))
        }
        dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(q, k, v, o_ref, lse_ref,
                                                    do, **kw)
        delta_ref = fa.flash_bwd_delta_plain(o_ref, do)
        torch.cuda.synchronize()
        lse_err = float((lse - lse_ref).abs().max())
        if lse_err > 1e-4:  # fp32 sums of up to t terms, lse up to ~10
            fail(f"flash_fwd {name}: lse differs from plain by {lse_err}")
        # fp32 sums of d products in another order: within 1e-5 of the
        # row's magnitude (at least 1)
        delta_err = float(((delta - delta_ref).abs()
                           / delta_ref.abs().clamp_min(1.0)).max())
        if not delta_err <= 1e-5:
            fail(f"flash_bwd_delta {name}: differs from plain by "
                 f"{delta_err:.3g} relative")
        errs = {
            "fwd": _check_one_rounding(f"flash_fwd {name}", o, o_ref),
            "delta": float((delta - delta_ref).abs().max()),
            "dq": _check_one_rounding(f"flash_bwd_dq {name}", dq, dq_ref),
            "dkv": max(
                _check_one_rounding(f"flash_bwd_dkv {name} dk", dk, dk_ref),
                _check_one_rounding(f"flash_bwd_dkv {name} dv", dv, dv_ref),
            ),
        }
        # the library yardstick: SDPA on [b, h, t, d] copies (made
        # outside the timed calls), the mask as a boolean bias where
        # lengths or a window need one
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        mask = None
        if lens is not None or window:
            rows = torch.arange(t, device=dev)[:, None]
            cols = torch.arange(t, device=dev)[None, :]
            m = (cols <= rows) if causal else torch.ones(
                (t, t), dtype=torch.bool, device=dev)
            if window:
                m = m & (rows - cols < window)
            m = m[None, None]
            if lens is not None:
                m = m & (cols < lens.long()[:, None, None, None])
            mask = m
        sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None,
                       enable_gqa=h != kvh)
        leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]

        def lib_fwd(i):
            F.scaled_dot_product_attention(qh, kh, vh, **sdpa_kw)

        def lib_fwd_bwd(i):
            out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
            torch.autograd.grad(out, leaves, doh)

        lib_fwd_ms = _time_ms(lib_fwd, iters=20)
        # SDPA's backward alone: forward and backward captured together
        # in one graph (a backward runs on its forward's stream), less
        # the forward; where the capture is refused, timed eagerly
        # (Python and launch cost included) and labelled so
        try:
            lib_bwd_ms = _time_ms(lib_fwd_bwd, iters=20) - lib_fwd_ms
            how = "graph-replayed, forward+backward less forward"
        except RuntimeError as e:
            log(f"flash {name}: SDPA backward capture refused ({e}); "
                "timing it eagerly")
            out = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
            lib_bwd_ms = _time_ms(
                lambda i: torch.autograd.grad(out, leaves, doh,
                                              retain_graph=True),
                iters=20, graph=False)
            how = "eager"

        timed = {
            "fwd": (lambda i: fa.flash_fwd(q, k, v, **kw),
                    lambda i: fa.flash_fwd_plain(q, k, v, **kw)),
            "delta": (lambda i: fa.flash_bwd_delta(o_ref, do),
                      lambda i: fa.flash_bwd_delta_plain(o_ref, do)),
            "dq": (lambda i: fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do,
                                             delta=delta, **kw),
                   lambda i: fa.flash_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                                **kw)),
            "dkv": (lambda i: fa.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do,
                                               delta=delta, **kw),
                    lambda i: fa.flash_bwd_plain(q, k, v, o_ref, lse_ref,
                                                 do, **kw)),
        }
        # SDPA's backward computes dQ, dK and dV in one call: the same
        # number stands beside both backward kernels; no one call
        # computes delta in fp32 from bf16 inputs
        bwd_call = ("scaled_dot_product_attention backward (dQ, dK and dV "
                    f"together, {how})")
        library = {"fwd": (lib_fwd_ms,
                           "scaled_dot_product_attention forward"),
                   "delta": (None, None), "dq": (lib_bwd_ms, bwd_call),
                   "dkv": (lib_bwd_ms, bwd_call)}
        for kind, (kern, plain) in timed.items():
            # in turns: plain, kernel, kernel, plain, all graph-replayed
            p1 = _time_ms(plain, iters=10)
            k1 = _time_ms(kern, iters=20)
            k2 = _time_ms(kern, iters=20)
            p2 = _time_ms(plain, iters=10)
            bound_ms, bound_by = _flash_bound(kind, c)
            r = {
                "name": name,
                "shape": {"b": b, "t": t, "h": h, "kvh": kvh, "d": d,
                          "causal": causal, "lengths": lengths,
                          "window": window, "dtype": "bfloat16"},
                "max_abs_err": errs[kind],
                "ms": min(k1, k2),
                "plain_ms": min(p1, p2),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library[kind][0],
                "library_call": library[kind][1],
            }
            if kind in variant:
                r["variant"] = variant[kind]
            log(f"kernel flash_{kind}[{name}]: "
                + json.dumps(r, sort_keys=True))
            results[kind].append(r)
        bwd_ms = sum(results[k][-1]["ms"] for k in ("delta", "dq", "dkv"))
        log(f"flash backward[{name}]: delta + dQ + dK/dV {bwd_ms:.5f} ms, "
            f"SDPA backward {lib_bwd_ms:.5f} ms ({how})")
        del leaves
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


def serve_prompts(vocab_size):
    """Phase 3's burst, from the seed: 9 prompts of 16-700 tokens, two
    of them starting with the same full page; and the maker of further
    prompts from the same stream (phase 4's)."""
    import numpy as np

    rng = np.random.default_rng(SEED)

    def prompt(n):
        return rng.integers(0, vocab_size, n).tolist()

    shared = prompt(16)  # one full page both requests below start with
    prompts = [prompt(n) for n in (16, 33, 64, 129, 250, 400, 700)]
    prompts += [shared + prompt(24), shared + prompt(41)]
    return prompts, prompt


def phase_serve(model, prompts, max_tokens, card):
    """serve() of the bf16 GPT-2 medium model over HTTP; every request
    must come back ``done`` with ``max_tokens`` tokens, through the
    kernels and with no fallback: decode steps on the decode kernel,
    every prefill chunk of more than 4 tokens on the tiled kernel's
    tensor-core variant. Returns the launches of each, apart."""
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.ops import paged_attention as pa

    fn = pa.paged_attention
    fn.launches = fn.chunk_launches = fn.tc_launches = 0
    handle = serve(model, None, port=0, slots=8, prefill_ceiling=256,
                   max_new_tokens=max_tokens, addr="127.0.0.1",
                   handle_sigterm=False, device="cuda")
    try:
        results, wall = _burst(handle.port, prompts, max_tokens)
        launches = {"decode": fn.launches - fn.chunk_launches,
                    "tiled": fn.chunk_launches,
                    "tiled_tensor_cores": fn.tc_launches}
        stats = handle.engine.stats()
        mgr = handle.engine.manager.stats()
        slo = handle.batcher.recorder.summaries()
    finally:
        handle.stop()
    _check_burst("serve", results, prompts, max_tokens)
    if not handle.engine.paged_attn:
        fail("serve: the engine resolved paged_attn off on the card")
    if (launches["decode"] <= 0 or launches["tiled"] <= 0
            or stats["paged_attn_calls"] <= 0):
        fail(f"serve: paged attention launches {launches}, engine "
             f"paged_attn_calls {stats['paged_attn_calls']}")
    if launches["tiled_tensor_cores"] != launches["tiled"]:
        fail(f"serve: {launches['tiled'] - launches['tiled_tensor_cores']} "
             f"of {launches['tiled']} bf16 chunk launches (more than 4 "
             "packed rows a KV head) missed the tensor cores")
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
    equal the uncached full-forward argmax loop, on the CUDA-core
    kernels (fp32 takes no tensor-core variant)."""
    from horovod_tpu_torch import serve
    from horovod_tpu_torch.ops import paged_attention as pa

    fn = pa.paged_attention
    before = (fn.tc_launches, fn.launches - fn.chunk_launches)
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
    if fn.tc_launches != before[0]:
        fail("fp32: a paged launch took the tensor-core kernel")
    decode = fn.launches - fn.chunk_launches - before[1]
    if decode <= 0:
        fail("fp32: no decode step launched the decode kernel")
    for prompt, (_, body) in zip(prompts, results):
        want = _full_forward_greedy(model32, prompt, max_tokens)
        if body["tokens"] != want:
            fail(f"fp32: served tokens {body['tokens']} differ from the "
                 f"full-forward argmax loop {want}")
    log(f"fp32: {len(prompts)} requests of {[len(p) for p in prompts]} "
        f"prompt tokens match the full-forward argmax loop "
        f"({max_tokens} tokens each; {decode} decode-kernel launches)")


# ------------------------------------------------------- phase 5 training

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8


def _lm_batch(vocab, batch, seq, seed=SEED):
    """The learnable sequence of examples/transformer_lm.py: next token
    = (token + 1) mod vocab, from the seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab - 1, size=(batch, 1))
    rows = (base + np.arange(seq + 1)[None, :]) % vocab
    dev = torch.device("cuda")
    return (torch.as_tensor(rows[:, :-1], device=dev),
            torch.as_tensor(rows[:, 1:], device=dev))


def _loss(model, tokens, labels):
    import torch.nn.functional as F

    logits = model(tokens)  # fp32, as optax's integer-label xent
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _wire_split(prof, busy_ms):
    """The int8 wire's device time in a profiled step, by class: B3 and
    the NCCL kernels by kernel name, the plain-PyTorch passes by the
    fusion layer's ranges (``fusion.WIRE_RANGES``): the kernels that the
    ops under each range launched (the range's own span on the device,
    which the profiler also records, is not counted). The exchanges are
    the larger of their range and the NCCL kernels."""
    from horovod_tpu_torch.ops.fusion import WIRE_RANGES

    names = {v: k for k, v in WIRE_RANGES.items()}

    def kernels_ms(e):
        own = sum(k.duration for k in e.kernels if k.name not in names)
        return own / 1e3 + sum(kernels_ms(c) for c in e.cpu_children)

    by_range = {k: 0.0 for k in WIRE_RANGES}
    for e in prof.events():
        if e.name in names and e.device_type.name == "CPU":
            by_range[names[e.name]] += kernels_ms(e)
    b3 = nccl = 0.0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            if "block_quantize" in e.key:
                b3 += e.self_device_time_total / 1e3
            elif "nccl" in e.key.lower():
                nccl += e.self_device_time_total / 1e3
    split = {"b3_ms": b3, "nccl_kernels_ms": nccl,
             "exchange_ms": max(by_range.pop("exchange"), nccl)}
    split.update({f"{k}_ms": v for k, v in by_range.items()})
    split["wire_ms"] = sum(v for k, v in split.items()
                           if k != "nccl_kernels_ms")
    split["rest_of_step_ms"] = busy_ms - split["wire_ms"]
    split["device_busy_ms"] = busy_ms
    return split


def _profile_step(step, wire_split=False, range_prefix=None):
    """One step under torch.profiler: the device-busy share (the sum of
    kernel time over the step's wall time; streams that overlap would
    count twice) and the kernels by device time; with ``wire_split``,
    the int8 wire's share by class (:func:`_wire_split`); with
    ``range_prefix``, each host range of that prefix: its start from the
    step's first host event and its length, in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    from horovod_tpu_torch.ops.fusion import WIRE_RANGES

    kernels, host = [], []
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            # a range's span on the device is no kernel of its own
            if e.self_device_time_total > 0 and (
                    e.key not in WIRE_RANGES.values()):
                kernels.append((e.key, e.self_device_time_total / 1e3,
                                e.count))
        elif e.self_cpu_time_total > 0:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    host.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    extra = {"wire_split": _wire_split(prof, busy_ms)} if wire_split else {}
    if range_prefix is not None:
        cpu = [e for e in prof.events() if e.device_type.name == "CPU"]
        t0 = min(e.time_range.start for e in cpu)
        extra["ranges"] = sorted(
            (e.name, (e.time_range.start - t0) / 1e3,
             (e.time_range.end - e.time_range.start) / 1e3)
            for e in cpu if e.name.startswith(range_prefix))
    return {**extra,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "host_ms": sum(k[1] for k in host),
        "host_ops": sum(k[2] for k in host),
        "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                        for n, ms, c in kernels[:14]],
        "top_host_ops": [{"name": n[:60], "self_ms": ms, "count": c}
                         for n, ms, c in host[:14]],
    }


def phase_train(gen, card):
    """GPT-2 medium at full width (bf16 compute, fp32 master weights,
    remat) trained through ``hvd.init`` (a world of one on NCCL),
    ``broadcast_parameters`` and ``DistributedOptimizer(SGD momentum,
    op=Average)``, with the flash launch counters and the fusion counters
    zeroed just before the steps. Returns the launch counts, the fused
    bytes of the last step, the peak memory and the step's readings
    (host-clock ms, device-busy share, peak) that phase 14 prints beside
    its own."""
    import dataclasses

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import paged_attention as pa

    hvd.init()
    try:
        cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
        model = Transformer(cfg, device="cuda", generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters(), op=hvd.Average,
        )
        tokens, labels = _lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        fusion = basics.state().fusion

        def step():
            opt.zero_grad(set_to_none=True)
            loss = _loss(model, tokens, labels)
            loss.backward()
            opt.step()
            return loss

        counters = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
                    fa.flash_bwd_dkv, pa.paged_attention)
        tc_counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        for c in counters:
            c.launches = 0
        for c in tc_counters:
            c.tc_launches = 0
        fusion.dispatched_batches = fusion.dispatched_bytes = 0
        torch.cuda.reset_peak_memory_stats()

        def read():  # fwd, delta, dq, dkv, fwd, dq and dkv on tensor
            # cores, fused batches, fused bytes
            return ([c.launches for c in counters[:4]]
                    + [c.tc_launches for c in tc_counters]
                    + [fusion.dispatched_batches, fusion.dispatched_bytes])

        losses, step_ms, per_step = [], [], []
        for _ in range(TRAIN_STEPS):
            before = read()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loss = step()
            losses.append(float(loss.detach()))  # waits for the step
            step_ms.append((time.monotonic() - t0) * 1e3)
            per_step.append([a - b for a, b in zip(read(), before)])
        launches = {c.__name__: c.launches for c in counters}
        tc_launches = {c.__name__: c.tc_launches for c in tc_counters}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n = cfg.num_layers
        for i, counts in enumerate(per_step):
            (fwd, delta, dq, dkv, fwd_tc, dq_tc, dkv_tc, batches,
             nbytes) = counts
            want = (2 * n, n, n, n, 2 * n, n, n)
            if (fwd, delta, dq, dkv, fwd_tc, dq_tc, dkv_tc) != want:
                fail(f"train step {i}: flash launches fwd/delta/dq/dkv "
                     f"{fwd}/{delta}/{dq}/{dkv}, fwd/dq/dkv on the tensor "
                     f"cores {fwd_tc}/{dq_tc}/{dkv_tc}, expected {want} "
                     "(remat reruns the forward; bf16 at head_dim 64 "
                     "takes the tensor-core kernels)")
            if batches < 1:
                fail(f"train step {i}: no fused allreduce was dispatched")
        if not all(math.isfinite(x) for x in losses):
            fail(f"train: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"train: loss did not fall: {losses}")
        steady = step_ms[1:]
        mean_ms = sum(steady) / len(steady)
        prof = _profile_step(step)
        summary = {
            "model": "gpt2_medium", "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
            "dtype": "bfloat16 compute, fp32 master weights",
            "world": hvd.size(), "losses": losses, "step_ms": step_ms,
            "step_ms_mean_after_first": mean_ms,
            "samples_per_s": TRAIN_BATCH / (mean_ms / 1e3),
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3),
            "peak_memory_gb": peak_gb,
            "flash_launches_per_step": dict(zip(
                ("fwd", "delta", "dq", "dkv", "fwd_tensor_cores",
                 "dq_tensor_cores", "dkv_tensor_cores"), per_step[-1][:7])),
            "fused_batches_per_step": per_step[-1][7],
            "fused_bytes_per_step": per_step[-1][8],
            "launches": launches, "tc_launches": tc_launches, "card": card,
        }
        log("train: " + json.dumps(summary, sort_keys=True))
        log("train profile: " + json.dumps(prof, sort_keys=True))
        opt.remove_hooks()
        del model, opt
        readings = {"step_ms_mean_after_first": mean_ms,
                    "device_busy_share": prof["device_busy_share"],
                    "peak_memory_gb": peak_gb}
        return launches, tc_launches, per_step[-1][8], peak_gb, readings
    finally:
        hvd.shutdown()


def phase_train_fp32(gen):
    """One training step of GPT-2 medium at full width in fp32, batch 2
    × seq 256, through the flash kernels and through dense attention,
    from the same weights: the loss within 1e-5 relative and every
    gradient within 1e-3 of its largest magnitude (fp32 sums in other
    orders, carried through 24 layers of backward)."""
    import dataclasses

    import torch

    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.ops import flash_attention as fa

    cfg = dataclasses.replace(TransformerConfig.gpt2_medium(),
                              dtype=torch.float32)
    tokens, labels = _lm_batch(cfg.vocab_size, 2, 256)
    runs = []
    state = None

    def count():  # fwd, dq; fwd, dq and dkv on the tensor cores
        return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
                fa.flash_fwd.tc_launches, fa.flash_bwd_dq.tc_launches,
                fa.flash_bwd_dkv.tc_launches)

    for flash in (True, False):
        model = Transformer(dataclasses.replace(cfg, flash_attention=flash),
                            device="cuda", generator=gen)
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        before = count()
        loss = _loss(model, tokens, labels)
        loss.backward()
        ran = tuple(a - b for a, b in zip(count(), before))
        if flash and ran != (cfg.num_layers, cfg.num_layers, 0, 0, 0):
            fail(f"fp32 train: flash fwd/dq/tensor-core launches {ran}, "
                 f"expected {cfg.num_layers}/{cfg.num_layers}/0/0/0 (fp32 "
                 "takes the CUDA-core kernels)")
        runs.append((float(loss.detach()), {n: p.grad for n, p
                                   in model.named_parameters()}))
        del model
    (l_flash, g_flash), (l_dense, g_dense) = runs
    if abs(l_flash - l_dense) > 1e-5 * abs(l_dense):
        fail(f"fp32 train: loss {l_flash} (flash) vs {l_dense} (dense)")
    worst = 0.0
    for name, gd in g_dense.items():
        scale = float(gd.abs().max())
        err = float((g_flash[name] - gd).abs().max())
        rel = err / scale if scale else err
        worst = max(worst, rel)
        if rel > 1e-3:
            fail(f"fp32 train: gradient {name} differs by {err:.3g} "
                 f"({rel:.3g} of its largest magnitude)")
    log(f"fp32 train: loss flash {l_flash:.8f} dense {l_dense:.8f}, "
        f"{len(g_dense)} gradients, worst relative difference {worst:.3g}")


# ------------------------------------------------ phase 7 wire kernels

WIRE_N = {"fusion-64MiB": 16_777_216, "wte": 50257 * 1024,
          "ragged": 1_000_003}
# each kernel's row at the shape its path gives it: the codec's and the
# Adasum tree's largest tensor (wte), the int8 wire's 64 MiB batch
WIRE_MAIN = {
    "scale_cast": "scale_cast[wte, int8 to fp32]",
    "int8_quantize": "int8_quantize[wte]",
    "int8_block_quantize": "int8_block_quantize[fusion-64MiB, block 512]",
    "adasum_dots": "adasum_dots[wte]",
    "adasum_apply": "adasum_apply[wte]",
}


def _wire_bound(nbytes):
    """Least time: the bytes read once and written once over the memory
    rate (the kernels' fp32 arithmetic is far below the fp32 peak)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def _timed_pair(kern, plain, iters=20, plain_iters=3):
    """In turns (plain, kernel, kernel, plain), graph-replayed; the lower
    of each pair."""
    p1 = _time_ms(plain, iters=plain_iters, warmup=1)
    k1 = _time_ms(kern, iters=iters)
    k2 = _time_ms(kern, iters=iters)
    p2 = _time_ms(plain, iters=plain_iters, warmup=1)
    return min(k1, k2), min(p1, p2)


def _wire_result(name, shape, err, ms, plain_ms, nbytes, library_ms=None):
    bound_ms, bound_by = _wire_bound(nbytes)
    r = {"name": name, "shape": shape, "max_abs_err": err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": library_ms}
    log(f"kernel wire[{name}]: " + json.dumps(r, sort_keys=True))
    return r


def _b3_row(label, x, block, rows=False, seed=5, stream=1, timed=True):
    """B3 on x against its plain version, bit for bit (values and
    scales), then timed in turns with it; the row names the variant that
    ran."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    q, s = ck.int8_block_quantize(x, block, seed=seed, stream=stream,
                                  rows=rows)
    qp, sp = ck.int8_block_quantize_plain(x, block, seed=seed,
                                          stream=stream, rows=rows)
    torch.cuda.synchronize()
    if not (torch.equal(s, sp) and torch.equal(q, qp)):
        fail(f"int8_block_quantize[{label}]: kernel differs from plain "
             f"({int((q != qp).sum())} values, {int((s != sp).sum())} "
             "scales)")
    if not timed:
        return None
    shape = ({"rows": x.shape[0], "cols": x.shape[1]} if rows
             else {"n": x.numel()})
    shape.update(block=block, dtype=str(x.dtype).split(".")[1],
                 aligned=x.data_ptr() % 16 == 0)
    ms, plain_ms = _timed_pair(
        lambda i: ck.int8_block_quantize(x, block, seed=i, rows=rows),
        lambda i: ck.int8_block_quantize_plain(x, block, i, rows=rows))
    r = _wire_result(f"int8_block_quantize[{label}]", shape, 0.0, ms,
                     plain_ms,
                     x.numel() * (x.element_size() + 1) + s.numel() * 4)
    r["variant"] = ck.block_quantize_variant(block)
    return r


def _b3_new_rows():
    """B3's further rows, from a generator of their own (the draws
    of the later phases stay as they were): bf16 at 64 MiB; rows of 4 ×
    4 194 303, so every block of rows 1-3 starts and ends inside a
    16-byte vector; a view ``x[3:]`` whose base is not 16-byte aligned
    (the scalar loads); then, untimed, block sizes on each side of every
    variant limit at 1 000 003 elements, fp32, bf16 and fp16."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    n = WIRE_N["fusion-64MiB"]
    x = torch.randn(n, generator=gen, device="cuda")
    x[: n // 3] *= 1e-3
    out = [_b3_row("fusion-64MiB, bf16, block 512", x.to(torch.bfloat16),
                   512),
           _b3_row("rows 4 x 4194303, block 512", x[: n - 4].view(4, -1),
                   512, rows=True),
           _b3_row("misaligned x[3:], rows 1 x 16777213, block 512",
                   x[3:].view(1, -1), 512, rows=True)]
    ragged = x[: WIRE_N["ragged"]]
    blocks = (1, 3, 31, 32, 33, ck.WARP_MAX_BLOCK, ck.WARP_MAX_BLOCK + 1,
              4096, ck.CTA_STAGE_MAX + 1)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xd = ragged.to(dtype)
        for block in blocks:
            _b3_row(f"ragged, {dtype}, block {block}", xd, block,
                    timed=False)
    log(f"int8_block_quantize: bitwise at blocks {list(blocks)} "
        "(variants " + ", ".join(sorted({ck.block_quantize_variant(b)
                                         for b in blocks})) + ") in fp32, "
        "bf16 and fp16")
    return out


def phase_wire_kernels(gen):
    """Kernels B1-B4 against their plain versions at the sizes the paths
    give them: a 64 MiB fusion batch (16 777 216 fp32), GPT-2 medium's
    largest gradient (wte, 50257 × 1024 fp32), a ragged 1 000 003, bf16
    input for B1, B2 and B4, B3 at blocks 512 and 1000, as the fused
    wire's [4, chunk] rows, in bf16, on rows whose blocks start inside a
    16-byte vector, on a misaligned view and at block sizes on each side
    of its variant limits. B1, B2 and B3 must equal their plain versions
    bit for bit (values and scales: the same Philox bits, IEEE
    divisions); B4's dots within 1e-5 relative, its apply within 1e-5 of
    the output's largest magnitude in fp32 and one rounding in bf16. Then
    the stochastic contract on the card: the mean of 32 seeds of B3 is
    unbiased within 4σ, and a tail block of small values keeps its own
    scale. Returns the rows of the kernels line, by kernel."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    rows = {k: [] for k in ("scale_cast", "int8_quantize",
                            "int8_block_quantize", "adasum_dots",
                            "adasum_apply")}
    for label, n in WIRE_N.items():
        x = torch.randn(n, generator=gen, device=dev)
        y = torch.randn(n, generator=gen, device=dev)
        x[: n // 3] *= 1e-3  # regions of other magnitude
        shape = {"n": n, "dtype": "float32"}

        # B2, per-tensor quantize, fp32 then bf16: timed over copies of
        # x that together exceed L2 (the codec quantizes each tensor
        # once, cold)
        for xd in (x.to(torch.bfloat16), x):
            tag = "" if xd.dtype == torch.float32 else ", bf16"
            q, s = ck.int8_quantize(xd, seed=3)
            qp, sp = ck.int8_quantize_plain(xd, seed=3)
            torch.cuda.synchronize()
            if not (torch.equal(s, sp) and torch.equal(q, qp)):
                fail(f"int8_quantize {label}{tag}: kernel differs from "
                     f"plain ({int((q != qp).sum())} values, scales "
                     f"{float(s)} vs {float(sp)})")
            esize = xd.element_size()
            xs = [xd] + [xd.clone() for _ in range(
                max(1, min(31, -(-120_000_000 // (n * esize)) - 1)))]
            ms, plain_ms = _timed_pair(
                lambda i: ck.int8_quantize(xs[i % len(xs)], seed=i),
                lambda i: ck.int8_quantize_plain(xs[i % len(xs)], i),
                iters=max(20, 2 * len(xs)))
            rows["int8_quantize"].append(_wire_result(
                f"int8_quantize[{label}{tag}]",
                dict(shape, dtype=str(xd.dtype).split(".")[1]), 0.0, ms,
                plain_ms, n * esize + n + 4))
            del xs

        # B1 on the dequantize path: int8 values × the scale, to fp32
        out = ck.scale_cast(q, s, torch.float32)
        if not torch.equal(out, ck.scale_cast_plain(q, s, torch.float32)):
            fail(f"scale_cast {label}: kernel differs from plain")
        dst = torch.empty(n, device=dev)
        ms, plain_ms = _timed_pair(
            lambda i: ck.scale_cast(q, s, torch.float32),
            lambda i: ck.scale_cast_plain(q, s, torch.float32))
        lib_ms = _time_ms(lambda i: torch.mul(q, s, out=dst))
        rows["scale_cast"].append(_wire_result(
            f"scale_cast[{label}, int8 to fp32]", dict(shape, dtype="int8"),
            0.0, ms, plain_ms, n + n * 4 + 4, lib_ms))

        # B3, flat at blocks 512 and 1000
        for block in (512, 1000):
            rows["int8_block_quantize"].append(_b3_row(
                f"{label}, block {block}", x, block))

        # B4, dots then apply
        d = ck.adasum_dots(x, y)
        dp = ck.adasum_dots_plain(x, y)
        again = ck.adasum_dots(x, y)
        torch.cuda.synchronize()
        if not torch.equal(d, again):
            fail(f"adasum_dots {label}: two runs differ")
        d_err = float(((d - dp).abs() / dp.abs().clamp_min(1e-30)).max())
        if d_err > 1e-5:
            fail(f"adasum_dots {label}: {d.tolist()} vs plain "
                 f"{dp.tolist()}")
        out = ck.adasum_apply(x, y, d)
        want = ck.adasum_apply_plain(x, y, d)
        a_err = float((out - want).abs().max())
        if a_err > 1e-5 * float(want.abs().max()):
            fail(f"adasum_apply {label}: max |kernel - plain| {a_err}")
        ms, plain_ms = _timed_pair(lambda i: ck.adasum_dots(x, y),
                                   lambda i: ck.adasum_dots_plain(x, y))
        rows["adasum_dots"].append(_wire_result(
            f"adasum_dots[{label}]", shape, d_err, ms, plain_ms,
            2 * n * 4 + 12))
        ms, plain_ms = _timed_pair(
            lambda i: ck.adasum_apply(x, y, d),
            lambda i: ck.adasum_apply_plain(x, y, d))
        rows["adasum_apply"].append(_wire_result(
            f"adasum_apply[{label}]", shape, a_err, ms, plain_ms,
            3 * n * 4 + 12))
        del x, y, q, qp, out, want, dst

    # the fused wire's [n, chunk] rows: one 64 MiB batch over 4 ranks
    n = WIRE_N["fusion-64MiB"]
    chunks = torch.randn((4, n // 4), generator=gen, device=dev)
    chunks[:, -100:] *= 1e-4
    rows["int8_block_quantize"].append(_b3_row(
        "rows 4 x 4194304, block 512", chunks, 512, rows=True))
    del chunks
    rows["int8_block_quantize"] += _b3_new_rows()

    # bf16 inputs for B1 and B4
    n = WIRE_N["wte"]
    xb = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    yb = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    shape = {"n": n, "dtype": "bfloat16"}
    scale = torch.tensor(0.37, device=dev)
    out = ck.scale_cast(xb, scale, torch.float32)
    if not torch.equal(out, ck.scale_cast_plain(xb, scale, torch.float32)):
        fail("scale_cast bf16: kernel differs from plain")
    ms, plain_ms = _timed_pair(
        lambda i: ck.scale_cast(xb, scale, torch.float32),
        lambda i: ck.scale_cast_plain(xb, scale, torch.float32))
    dst = torch.empty(n, device=dev)
    lib_ms = _time_ms(lambda i: torch.mul(xb, scale, out=dst))
    rows["scale_cast"].append(_wire_result(
        "scale_cast[wte, bf16 to fp32]", shape, 0.0, ms, plain_ms,
        n * 2 + n * 4 + 4, lib_ms))
    d = ck.adasum_dots(xb, yb)
    dp = ck.adasum_dots_plain(xb, yb)
    d_err = float(((d - dp).abs() / dp.abs().clamp_min(1e-30)).max())
    if d_err > 1e-5:
        fail(f"adasum_dots bf16: {d.tolist()} vs plain {dp.tolist()}")
    got = ck.adasum_apply(xb, yb, d)
    want = ck.adasum_apply_plain(xb, yb, d)
    if got.dtype != torch.bfloat16:
        fail("adasum_apply bf16: output dtype is not bf16")
    err = _check_one_rounding("adasum_apply bf16", got, want)
    ms, plain_ms = _timed_pair(lambda i: ck.adasum_apply(xb, yb, d),
                               lambda i: ck.adasum_apply_plain(xb, yb, d))
    rows["adasum_apply"].append(_wire_result(
        "adasum_apply[wte, bf16]", shape, err, ms, plain_ms,
        3 * n * 2 + 12))
    del xb, yb, got, want, dst

    # the stochastic contract on the card: unbiased over 32 seeds, and a
    # small tail block keeps its own scale
    n = 1_000_003
    x = torch.randn(n, generator=gen, device=dev)
    x[-(n % 512):] *= 1e-3
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    for seed in range(32):
        q, s = ck.int8_block_quantize(x, 512, seed=seed)
        acc += ck.int8_block_dequantize(q, s, 512).double()
    per = s.double().repeat_interleave(512)[:n]
    xd = x.double()
    frac = xd / per - torch.floor(xd / per)
    sigma = float(torch.sqrt((per ** 2 * frac * (1 - frac)).sum() / 32))
    bias = float((acc / 32 - xd).sum())
    if abs(bias) > 4 * sigma:
        fail(f"int8_block_quantize: mean of 32 seeds biased by {bias} "
             f"(4 sigma = {4 * sigma})")
    tail = x[-(n % 512):].abs().max().clamp_min(1e-30) * (1.0 / 127.0)
    if float(s[-1]) != float(tail):
        fail(f"int8_block_quantize: tail scale {float(s[-1])} is not its "
             f"own absmax / 127 ({float(tail)})")
    log(f"wire contract: 32-seed bias {bias:.4g} within 4 sigma "
        f"{4 * sigma:.4g}; tail block scale {float(s[-1]):.4g} is its own")
    return rows


# ---------------------------------------------- phase 8 int8 training


def phase_train_int8(gen, card, fp32_bytes_per_step):
    """Phase 5's training through ``DistributedOptimizer(compression=
    Compression.int8_block, error_feedback=True)``: the fused gradient
    batches go over the int8 wire, each quantized twice on kernel B3
    (the reduce-scatter stage and the allgather stage; in a world of one
    the exchanges are local copies, the quantizers run at full size).
    The counters are zeroed just before the steps. Returns B3's
    launches."""
    import dataclasses

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import cuda_kernels as ck

    hvd.init()
    try:
        cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
        model = Transformer(cfg, device="cuda", generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters(), op=hvd.Average,
            compression=hvd.Compression.int8_block, error_feedback=True,
        )
        tokens, labels = _lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        fusion = basics.state().fusion

        for k in ck.KERNELS:
            k.launches = 0
        fusion.dispatched_batches = fusion.dispatched_bytes = 0
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, per_step = [], [], []
        for _ in range(TRAIN_STEPS):
            before = (ck.int8_block_quantize.launches,
                      fusion.dispatched_batches, fusion.dispatched_bytes)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            opt.zero_grad(set_to_none=True)
            loss = _loss(model, tokens, labels)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            step_ms.append((time.monotonic() - t0) * 1e3)
            after = (ck.int8_block_quantize.launches,
                     fusion.dispatched_batches, fusion.dispatched_bytes)
            per_step.append([a - b for a, b in zip(after, before)])
        launches = ck.int8_block_quantize.launches
        others = {k.__name__: k.launches for k in ck.KERNELS
                  if k is not ck.int8_block_quantize}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for i, (b3, batches, nbytes) in enumerate(per_step):
            if batches < 1 or b3 != 2 * batches:
                fail(f"int8 train step {i}: {b3} B3 launches for "
                     f"{batches} fused batches (2 a batch expected)")
            if nbytes > 0.27 * fp32_bytes_per_step:
                fail(f"int8 train step {i}: {nbytes} wire bytes, over "
                     f"0.27 x phase 5's {fp32_bytes_per_step}")
        if fusion.last_wire_format != "int8":
            fail(f"int8 train: the last batch rode the "
                 f"{fusion.last_wire_format} wire")
        if not all(math.isfinite(x) for x in losses):
            fail(f"int8 train: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            fail(f"int8 train: loss did not fall: {losses}")
        steady = step_ms[1:]
        mean_ms = sum(steady) / len(steady)
        residual_norm = opt.residual_norm()

        def step():
            opt.zero_grad(set_to_none=True)
            _loss(model, tokens, labels).backward()
            opt.step()

        prof = _profile_step(step, wire_split=True)
        split = prof.pop("wire_split")
        summary = {
            "model": "gpt2_medium", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "remat": cfg.remat, "world": hvd.size(),
            "compression": "int8_block (block 512), error_feedback",
            "losses": losses, "step_ms": step_ms,
            "step_ms_mean_after_first": mean_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3),
            "peak_memory_gb": peak_gb,
            "fused_batches_per_step": per_step[-1][1],
            "wire_bytes_per_step": per_step[-1][2],
            "fp32_wire_bytes_per_step_phase5": fp32_bytes_per_step,
            "wire_ratio": per_step[-1][2] / fp32_bytes_per_step,
            "b3_launches_per_step": per_step[-1][0],
            "residual_norm_after_last_step": residual_norm,
            "quant_blocks": fusion.quant_blocks,
            "other_wire_kernel_launches": others, "card": card,
        }
        log("int8 train: " + json.dumps(summary, sort_keys=True))
        log("int8 train profile: " + json.dumps(prof, sort_keys=True))
        log("int8 train wire split: " + json.dumps(split, sort_keys=True))
        if split["b3_ms"] <= 0:
            fail("int8 train: the profiled step shows no B3 device time")
        opt.remove_hooks()
        del model, opt
        return launches
    finally:
        hvd.shutdown()


# ----------------------------------- phase 9 Adasum and the int8 codec


def _tree_plain(vals):
    """The tree of ``adasum._tree_combine`` on B4's plain versions."""
    from horovod_tpu_torch.ops import cuda_kernels as ck

    vals = list(vals)
    while len(vals) > 1:
        nxt = [ck.adasum_pair_plain(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def phase_adasum(gen, card):
    """(a) GPT-2 medium's gradients from 4 microbatches, standing in for
    4 ranks, combined tensor by tensor with ``adasum._tree_combine`` (what
    process-set Adasum runs after its allgather): 3 pairs a tensor, so
    882 dots and 882 apply launches for the 294 tensors. Every tensor
    within 1e-5 of its largest magnitude of the plain tree, three against
    the fp64 host oracle; then one SGD step on the result. (b) In the
    world of one ``hvd.allreduce(op=hvd.Adasum)`` returns its input,
    launching nothing. (c) Every parameter through
    ``Compression.int8.compress`` → ``hvd.broadcast`` → ``decompress``
    (the codec's manual use): 294 launches each of B2 and B1, the round
    trip within one quantum. Returns the launches of (a) and (c)."""
    import dataclasses

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops import cuda_kernels as ck

    cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
    model = Transformer(cfg, device="cuda", generator=gen)
    params = [p for p in model.parameters()]
    grads = []
    for micro in range(4):
        tokens, labels = _lm_batch(cfg.vocab_size, 2, TRAIN_SEQ)
        tokens = (tokens + 7919 * micro) % cfg.vocab_size
        labels = (labels + 7919 * micro) % cfg.vocab_size
        model.zero_grad(set_to_none=True)
        _loss(model, tokens, labels).backward()
        grads.append([p.grad.detach().clone() for p in params])
    model.zero_grad(set_to_none=True)

    for k in ck.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    combined = [adasum._tree_combine([g[i] for g in grads])
                for i in range(len(params))]
    torch.cuda.synchronize()
    tree_ms = (time.monotonic() - t0) * 1e3
    dots, apply_ = ck.adasum_dots.launches, ck.adasum_apply.launches
    want_pairs = 3 * len(params)
    if (dots, apply_) != (want_pairs, want_pairs):
        fail(f"adasum tree: {dots} dots and {apply_} apply launches, "
             f"expected {want_pairs} each")
    worst = 0.0
    for i, got in enumerate(combined):
        want = _tree_plain([g[i] for g in grads])
        scale = float(want.abs().max()) or 1.0
        err = float((got - want).abs().max()) / scale
        worst = max(worst, err)
        if err > 1e-5:
            fail(f"adasum tree: tensor {i} differs from the plain tree by "
                 f"{err:.3g} of its largest magnitude")
    order = sorted(range(len(params)), key=lambda i: params[i].numel())
    checked = []
    for i in (order[0], order[len(order) // 2], order[-1]):
        stack = np.stack([g[i].double().cpu().numpy() for g in grads])
        want = adasum.adasum_tree_host(stack)
        got = combined[i].double().cpu().numpy()
        err = float(np.abs(got - want).max()) / (float(
            np.abs(want).max()) or 1.0)
        if err > 1e-5:
            fail(f"adasum tree: tensor {i} differs from the fp64 host "
                 f"oracle by {err:.3g}")
        checked.append({"numel": params[i].numel(), "rel_err": err})
    sgd = torch.optim.SGD(params, lr=0.01)
    for p, g in zip(params, combined):
        p.grad = g
    sgd.step()
    if not all(bool(torch.isfinite(p).all()) for p in params):
        fail("adasum tree: the SGD step made a parameter non-finite")
    del grads, combined

    hvd.init()
    try:
        g = torch.randn(4096, generator=gen, device="cuda")
        for k in ck.KERNELS:
            k.launches = 0
        out = hvd.allreduce(g, op=hvd.Adasum)
        torch.cuda.synchronize()
        if not torch.equal(out, g):
            fail("adasum world of one: the result is not the input")
        if any(k.launches for k in ck.KERNELS):
            fail("adasum world of one launched a wire kernel")

        for k in ck.KERNELS:
            k.launches = 0
        worst_q = 0.0
        int8 = hvd.Compression.int8
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for i, p in enumerate(params):
            vals, ctx = int8.compress(p.detach(), seed=i)
            vals = hvd.broadcast(vals, root_rank=0, name=f"codec.{i}")
            back = int8.decompress(vals, ctx)
            err = float((back - p.detach()).abs().max() / ctx[1])
            worst_q = max(worst_q, err)
            if err > 1.0 + 1e-6:
                fail(f"int8 codec: parameter {i} round trip off by "
                     f"{err:.3g} quanta")
        torch.cuda.synchronize()
        codec_ms = (time.monotonic() - t0) * 1e3
        b2, b1 = ck.int8_quantize.launches, ck.scale_cast.launches
        if (b2, b1) != (len(params), len(params)):
            fail(f"int8 codec: {b2} B2 and {b1} B1 launches for "
                 f"{len(params)} parameters")
    finally:
        hvd.shutdown()
    log("adasum: " + json.dumps({
        "tensors": len(params), "pairs": want_pairs, "dots_launches": dots,
        "apply_launches": apply_, "tree_ms": tree_ms,
        "worst_rel_err_vs_plain": worst, "host_oracle": checked,
        "codec_tensors": len(params), "codec_ms": codec_ms,
        "codec_worst_quanta": worst_q, "card": card,
    }, sort_keys=True))
    return {"scale_cast": b1, "int8_quantize": b2, "adasum_dots": dots,
            "adasum_apply": apply_}


# ------------------------------------------------------ phase 10 ViT-B/16

IMAGE_BATCH, IMAGE_STEPS = 64, 4


def _image_batch(n, side, classes, channels=3):
    """Images of N(0, 1) pixels and uniform labels, from the seed, on
    the card."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    x = torch.randn((n, channels, side, side), generator=g, device="cuda")
    y = torch.randint(0, classes, (n,), generator=g, device="cuda")
    return x, y


def _flash_counters():
    from horovod_tpu_torch.ops import flash_attention as fa

    return (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
            fa.flash_bwd_dkv)


def _zero_flash():
    for c in _flash_counters():
        c.launches = 0
        if hasattr(c, "tc_launches"):
            c.tc_launches = 0


def _read_flash():
    """Launches and tensor-core launches of the flash kernels by name."""
    cs = _flash_counters()
    return ({c.__name__: c.launches for c in cs},
            {c.__name__: c.tc_launches for c in cs
             if hasattr(c, "tc_launches")})


def _step(opt, loss_fn):
    """One training step through ``opt``; returns the loss."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss


def _train_steps(label, opt, loss_fn, steps, after_step=None):
    """``steps`` training steps through ``opt``; the losses and the
    host-clock ms of each (``after_step()`` runs after each, outside the
    clock). Fails unless the losses are finite and the last is below the
    first."""
    import torch

    losses, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = _step(opt, loss_fn)
        losses.append(float(loss.detach()))
        step_ms.append((time.monotonic() - t0) * 1e3)
        if after_step is not None:
            after_step()
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: {losses}")
    return losses, step_ms


def phase_vit(card):
    """ViT-B/16 at full width (bf16 compute on fp32 masters, the
    tokens padded 197 → 200 with lengths 197, ``flash_pad="auto"``)
    trained on 64 images of 224² from the seed through ``hvd.init`` (a
    world of one on NCCL) and ``DistributedOptimizer(SGD momentum)``,
    the flash counters zeroed just before the steps. Each step must
    launch the forward, delta, dQ and dK/dV kernels 12 times each (one a
    layer), every forward, dQ and dK/dV launch on the tensor cores; the
    loss must fall. Returns the flash launches and tensor-core
    launches."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import ViT, ViTConfig

    hvd.init()
    try:
        cfg = ViTConfig.b16()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        model = ViT(cfg, device="cuda", generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters(), op=hvd.Average)
        images, labels = _image_batch(IMAGE_BATCH, cfg.image_size,
                                      cfg.num_classes)
        if not cfg.pads(images.device):
            fail("vit: flash_pad='auto' does not pad on the card")
        loss_fn = lambda: F.cross_entropy(model(images), labels)  # noqa
        per_step, seen = [], [{}, {}]

        def count():  # this step's launches, all and on the tensor cores
            now = _read_flash()
            step = {k: v - seen[0].get(k, 0) for k, v in now[0].items()}
            step.update({f"{k}_tensor_cores": v - seen[1].get(k, 0)
                         for k, v in now[1].items()})
            per_step.append(step)
            seen[:] = now

        _zero_flash()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = _train_steps("vit", opt, loss_fn,
                                       IMAGE_STEPS, count)
        launches, tc_launches = _read_flash()
        n = cfg.num_layers
        want = {"flash_fwd": n, "flash_bwd_delta": n, "flash_bwd_dq": n,
                "flash_bwd_dkv": n, "flash_fwd_tensor_cores": n,
                "flash_bwd_dq_tensor_cores": n,
                "flash_bwd_dkv_tensor_cores": n}
        for i, counts in enumerate(per_step):
            if counts != want:
                fail(f"vit step {i}: flash launches {counts}, expected "
                     f"{want} (t 200 with lengths 197, bf16, head_dim 64)")
        mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
        summary = {
            "model": "vit_b16", "layers": n, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "tokens": cfg.tokens,
            "padded_tokens": -(-cfg.tokens // 8) * 8,
            "batch": IMAGE_BATCH, "image": cfg.image_size,
            "dtype": "bfloat16 compute, fp32 master weights",
            "world": hvd.size(), "losses": losses, "step_ms": step_ms,
            "step_ms_mean_after_first": mean_ms,
            "images_per_s": IMAGE_BATCH / (mean_ms / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_launches_per_step": per_step[-1], "card": card,
        }
        log("vit: " + json.dumps(summary, sort_keys=True))
        log("vit profile: " + json.dumps(
            _profile_step(lambda: _step(opt, loss_fn)), sort_keys=True))
        opt.remove_hooks()
        del model, opt
        return launches, tc_launches
    finally:
        hvd.shutdown()


# ---------------------------------------------- phase 11 the CNN zoo


def _bn_layers(model):
    from horovod_tpu_torch.models.layers import BatchNorm

    return [m for m in model.modules() if isinstance(m, BatchNorm)]


def _sync_step(dtype, sync, state):
    """One ResNet-50 step in ``dtype`` on 8 images of 224² from
    ``state`` (None: weights from the seed): the loss, the gradients and
    the buffers after it, and the starting state."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch import ResNet50

    images, labels = _image_batch(8, 224, 1000)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = ResNet50(dtype=dtype, sync=sync, device="cuda",
                     generator=gen).to(dtype)
    if state is not None:
        model.load_state_dict(state)
    # copies: the forward moves the running statistics
    start = {k: v.clone() for k, v in model.state_dict().items()}
    loss = F.cross_entropy(model(images.to(dtype)), labels)
    loss.backward()
    return (float(loss.detach()),
            {n: p.grad.double() for n, p in model.named_parameters()},
            {n: b.double() for n, b in model.named_buffers()}, start)


def _worst_rel(got, want):
    """The largest |got − want| over each tensor's largest |want|."""
    return max(float((got[n] - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-300)
               for n, w in want.items())


def _sync_check(card):
    """One ResNet-50 step on 8 images of 224² with the statistics synced
    (one fused allreduce a batch norm each way, in the world of one) and
    local, from the same weights. In fp32 the loss must agree within
    1e-5 relative. The gradients are held in fp64, within 1e-9 of each
    one's largest magnitude, with the running statistics: in fp32 the
    reference's ``E[x²] − E[x]²`` statistics leave the late layers'
    gradients far from exact either way (reported beside: synced
    against local, and local against its own fp64 step)."""
    import torch

    l32_sync, g32_sync, _, start = _sync_step(torch.float32, True, None)
    l32, g32, _, _ = _sync_step(torch.float32, False, start)
    if abs(l32_sync - l32) > 1e-5 * abs(l32):
        fail(f"resnet fp32: loss {l32_sync} (synced) vs {l32} (local)")
    start64 = {k: v.double() if v.is_floating_point() else v
               for k, v in start.items()}
    l64_sync, g64_sync, b64_sync, _ = _sync_step(torch.float64, True,
                                                 start64)
    l64, g64, b64, _ = _sync_step(torch.float64, False, start64)
    grad_rel = _worst_rel(g64_sync, g64)
    stats_rel = _worst_rel(b64_sync, b64)
    if abs(l64_sync - l64) > 1e-12 * abs(l64) or grad_rel > 1e-9 \
            or stats_rel > 1e-9:
        fail(f"resnet fp64: synced vs local: loss {l64_sync} vs {l64}, "
             f"gradients {grad_rel:.3g}, running statistics "
             f"{stats_rel:.3g} of their largest magnitudes")
    return {"fp32_loss_synced": l32_sync, "fp32_loss_local": l32,
            "fp64_loss_synced": l64_sync, "fp64_loss_local": l64,
            "fp64_worst_gradient_rel_diff": grad_rel,
            "fp64_worst_running_stat_rel_diff": stats_rel,
            "fp32_worst_gradient_rel_diff": _worst_rel(g32_sync, g32),
            "fp32_local_vs_fp64_worst_gradient_rel_diff": _worst_rel(
                g32, g64), "card": card}


def _one_step(label, model, images, labels, lr, rng=None):
    """One SGD step through ``DistributedOptimizer``: the loss before
    and after it on the same batch (the dropout masks drawn again from
    the same seed), which must be finite and fall."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd

    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr),
        named_parameters=model.named_parameters(), op=hvd.Average)
    kw = {}

    def loss_fn():
        if rng is not None:
            rng.manual_seed(SEED)
            kw["rng"] = rng
        return F.cross_entropy(model(images, **kw), labels)

    torch.cuda.synchronize()
    t0 = time.monotonic()
    opt.zero_grad(set_to_none=True)
    before = loss_fn()
    before.backward()
    opt.step()
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    with torch.no_grad():
        after = float(loss_fn())
    before = float(before.detach())
    opt.remove_hooks()
    if not (math.isfinite(before) and math.isfinite(after)
            and after < before):
        fail(f"{label}: one step took the loss {before} -> {after}")
    return {"loss_before": before, "loss_after": after, "step_ms": ms,
            "batch": int(images.shape[0]), "image": int(images.shape[-1])}


def phase_cnn(card):
    """ResNet-50 at full width (bf16 compute on fp32 masters and
    statistics, the statistics synced through the port's
    ``SyncBatchNorm`` reductions in the world of one on NCCL) trained on
    64 images of 224² through ``DistributedOptimizer(SGD momentum)``:
    the loss must fall and the running statistics move. One step synced
    must equal it with local batch norm (:func:`_sync_check`). Then one
    step each of
    the MNIST ConvNet (64 at 28²), VGG-16 (32 at 224²) and Inception V3
    (32 at 299²), each with a finite falling loss."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import VGG16, InceptionV3, MNISTConvNet, ResNet50

    hvd.init()
    try:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        model = ResNet50(sync=True, device="cuda", generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters(), op=hvd.Average)
        images, labels = _image_batch(IMAGE_BATCH, 224, 1000)
        stats0 = torch.cat([b.running_var for b in _bn_layers(model)])
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = _train_steps(
            "resnet50", opt,
            lambda: F.cross_entropy(model(images), labels), IMAGE_STEPS)
        moved = float((torch.cat([b.running_var for b in _bn_layers(model)])
                       - stats0).abs().max())
        if not moved > 0:
            fail("resnet50: the running statistics did not move")
        mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
        summary = {
            "model": "resnet50", "batch": IMAGE_BATCH, "image": 224,
            "sync_batch_norm": True, "batch_norms": len(_bn_layers(model)),
            "dtype": "bfloat16 compute, fp32 master weights and statistics",
            "world": hvd.size(), "losses": losses, "step_ms": step_ms,
            "step_ms_mean_after_first": mean_ms,
            "images_per_s": IMAGE_BATCH / (mean_ms / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "running_var_max_change": moved, "card": card,
        }
        log("resnet50: " + json.dumps(summary, sort_keys=True))
        log("resnet50 profile: " + json.dumps(_profile_step(
            lambda: _step(opt, lambda: F.cross_entropy(model(images),
                                                       labels))),
            sort_keys=True))
        opt.remove_hooks()
        del model, opt
        torch.cuda.empty_cache()
        log("resnet50 synced vs local: "
            + json.dumps(_sync_check(card), sort_keys=True))
        torch.cuda.empty_cache()
        rng = torch.Generator(device="cuda")
        for label, make, side, lr, drop in (
                ("mnist", lambda g: MNISTConvNet(device="cuda", generator=g),
                 28, 0.05, True),
                ("vgg16", lambda g: VGG16(device="cuda", generator=g),
                 224, 0.01, True),
                ("inception_v3", lambda g: InceptionV3(
                    sync=True, device="cuda", generator=g), 299, 0.02,
                 True)):
            gen.manual_seed(SEED)
            model = make(gen)
            channels = 1 if label == "mnist" else 3
            n = 64 if label == "mnist" else 32
            classes = 10 if label == "mnist" else 1000
            images, labels = _image_batch(n, side, classes, channels)
            r = _one_step(label, model, images, labels, lr,
                          rng if drop else None)
            log(f"{label}: " + json.dumps(r | {"card": card},
                                          sort_keys=True))
            del model
            torch.cuda.empty_cache()
    finally:
        hvd.shutdown()


# ------------------------------------- phase 12 the fused LM loss

def _fused_loss(model, tokens, labels):
    from horovod_tpu_torch import fused_linear_cross_entropy

    h = model(tokens, return_hidden=True)
    head, cfg = model.lm_head, model.cfg
    return fused_linear_cross_entropy(
        h.reshape(-1, h.shape[-1]), head.kernel, head.bias,
        labels.reshape(-1),
        compute_dtype=cfg.dtype if cfg.head_mixed_precision else None).mean()


def _loss_grads_on_h(model, tokens, labels):
    """The dense loss (the LM head's product, then ``cross_entropy``)
    and the fused loss on the same hidden states: both losses, the
    largest difference of their gradients (hidden states, kernel, bias),
    each over its largest magnitude, and the largest absolute difference
    of the hidden states' gradients."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch import fused_linear_cross_entropy
    from horovod_tpu_torch.ops.fused_xent import mixed_linear

    cfg, head = model.cfg, model.lm_head
    dtype = cfg.dtype if cfg.head_mixed_precision else None
    with torch.no_grad():
        h = model(tokens, return_hidden=True).reshape(-1, cfg.d_model)
    leaves = [h.requires_grad_(), head.kernel, head.bias]
    logits = mixed_linear(h, head.kernel, head.bias, dtype)
    dense = F.cross_entropy(logits, labels.reshape(-1))
    g_d = torch.autograd.grad(dense, leaves)
    del logits
    fused = fused_linear_cross_entropy(h, head.kernel, head.bias,
                                       labels.reshape(-1),
                                       compute_dtype=dtype).mean()
    g_f = torch.autograd.grad(fused, leaves)
    rel = {name: float((f - d).abs().max()) / max(float(d.abs().max()),
                                                  1e-30)
           for name, d, f in zip(("hidden", "kernel", "bias"), g_d, g_f)}
    dh_abs = float((g_f[0] - g_d[0]).abs().max())
    return float(dense), float(fused), rel, dh_abs


# a planted fault in the fused loss's input gradient, which the whole
# model's check must see
PLANTED_DH_SCALE = 1.0 + 2.0 ** -6
# the whole model's gradients under the fused loss may sit this many
# times as far from the dense loss's as one bf16 rounding of the hidden
# states' gradient (or noise at the fused loss's own difference there)
# moves them; the two readings differ by about a tenth
READING_MARGIN = 1.25


def _model_grads(model, loss_fn, dh=None):
    """The model's gradients of ``loss_fn(model)``; ``dh`` (None, or a
    function of the gradient) rewrites the gradient of the hidden states
    the LM loss takes (the final LayerNorm's output: the LM head's input,
    or ``return_hidden``'s) before it flows into the model."""
    model.zero_grad(set_to_none=True)
    hooks = []
    if dh is not None:
        def on_hidden(_module, _args, out):
            out.register_hook(dh)
        hooks.append(model.ln_f.register_forward_hook(on_hidden))
    try:
        loss_fn(model).backward()
    finally:
        for hook in hooks:
            hook.remove()
    out = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def _spread(got, want):
    """Per parameter, the difference of two gradient sets by two
    measures: its largest element over the largest magnitude of
    ``want``, and its norm over ``want``'s norm. Returns the worst
    parameter of each and the five worst by the first."""
    mx, nrm = {}, {}
    for n, w in want.items():
        d = (got[n] - w).float()
        mx[n] = float(d.abs().max()) / max(float(w.abs().max()), 1e-30)
        nrm[n] = float(d.norm()) / max(float(w.float().norm()), 1e-30)
    top = sorted(mx.items(), key=lambda kv: -kv[1])[:5]
    return {"max_rel": max(mx.values()), "norm_rel": max(nrm.values()),
            "top5_max_rel": top}


def _gradient_readings(model, tokens, labels, dh_abs):
    """The fused loss's whole-model gradients against the dense loss's,
    beside readings that say what a difference of that size means: the
    dense loss run again (the run-to-run floor); the dense loss with the
    hidden states' gradient perturbed by ``dh_abs`` (the fused loss's
    own largest difference there) on every element, signs from the
    seed; the dense loss with that gradient rounded once to bf16; the
    fused loss with that gradient scaled by ``PLANTED_DH_SCALE`` (a
    planted fault). Each reading is a ``_spread`` against the dense
    loss's gradients; the fused loss's gradients are returned too."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def noise(g):
        sign = torch.randint(0, 2, g.shape, generator=gen,
                             device=g.device) * 2 - 1
        return g + dh_abs * sign.to(g.dtype)

    dense_fn = lambda m: _loss(m, tokens, labels)  # noqa: E731
    fused_fn = lambda m: _fused_loss(m, tokens, labels)  # noqa: E731
    g_d = _model_grads(model, dense_fn)
    readings = {}
    for name, fn, dh in (
            ("dense_again", dense_fn, None),
            ("dense_dh_noise", dense_fn, noise),
            ("dense_dh_bf16", dense_fn,
             lambda g: g.to(torch.bfloat16).to(g.dtype)),
            ("fused_planted", fused_fn, lambda g: g * PLANTED_DH_SCALE),
            ("fused", fused_fn, None)):
        g = _model_grads(model, fn, dh)
        readings[name] = _spread(g, g_d)
        if name == "fused":
            g_f = g
        del g
    return readings, g_f


def phase_fused_xent(card, phase5_peak_gb):
    """GPT-2 medium (phase 5's configuration, weights from the seed)
    with ``fused_linear_cross_entropy`` on ``return_hidden``: its loss
    and its gradients (hidden states, kernel, bias) against the dense
    loss's on the same hidden states within one bf16 rounding (2^-8
    relative; the gradients of each one's largest magnitude); the whole
    model's gradients within ``READING_MARGIN`` times what one bf16
    rounding of the hidden states' gradient moves the dense loss's (by
    the largest element and by the norm, each of a parameter over the
    dense loss's; ``_gradient_readings``), a limit that a planted fault
    (that gradient scaled by ``PLANTED_DH_SCALE``) must exceed; the peak
    memory of one forward and backward each
    way, and of two training steps each way (then one profiled step each
    way: its device time) through
    ``DistributedOptimizer`` with the peak memory of each beside phase
    5's; then ``flush()`` after 6 passes at ``backward_passes_per_step=
    4`` (the inner optimizer steps at pass 4 and at the flush), and a
    guarded step with a NaN injected into one gradient, which must skip
    (every parameter bitwise unchanged, the skip counted), followed by a
    guarded good step that applies. Returns the flash launches."""
    import dataclasses

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig

    hvd.init()
    try:
        cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        model = Transformer(cfg, device="cuda", generator=gen)
        tokens, labels = _lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        _zero_flash()
        l_d, l_f, head_rel, dh_abs = _loss_grads_on_h(model, tokens, labels)
        rounding = 2.0 ** -8
        if abs(l_f - l_d) > rounding * abs(l_d) or max(head_rel.values()) \
                > rounding:
            fail(f"fused xent: loss {l_f} vs dense {l_d}, gradients "
                 f"{head_rel} of their largest magnitudes (one bf16 "
                 f"rounding {rounding:.3g})")
        # the peak of one forward and backward alone
        fwd_bwd_peak = {}
        for name, fn in (("dense", _loss), ("fused", _fused_loss)):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn(model, tokens, labels).backward()
            torch.cuda.synchronize()
            fwd_bwd_peak[name] = torch.cuda.max_memory_allocated() / 1e9
        readings, g_f = _gradient_readings(model, tokens, labels, dh_abs)
        fused = readings["fused"]
        worst, top5 = fused["max_rel"], fused["top5_max_rel"]
        if not all(torch.isfinite(g).all() for g in g_f.values()):
            fail("fused xent: a non-finite gradient of the model")
        del g_f
        limits = {m: READING_MARGIN * max(readings["dense_dh_bf16"][m],
                                          readings["dense_dh_noise"][m])
                  for m in ("max_rel", "norm_rel")}
        for m, limit in limits.items():
            if fused[m] > limit:
                fail(f"fused xent: the model's gradients differ from the "
                     f"dense loss's by {fused[m]:.4g} ({m}; worst {top5}), "
                     f"over {limit:.4g}, {READING_MARGIN} times what one "
                     f"bf16 rounding of the hidden states' gradient moves "
                     f"them (readings {readings})")
            if readings["fused_planted"][m] <= limit:
                fail(f"fused xent: the check cannot see a planted fault "
                     f"(the hidden states' gradient scaled by "
                     f"{PLANTED_DH_SCALE}): {m} "
                     f"{readings['fused_planted'][m]:.4g} within {limit:.4g}")
        model.zero_grad(set_to_none=True)
        peaks = {}
        for name, fn in (("dense", _loss), ("fused", _fused_loss)):
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
                named_parameters=model.named_parameters(), op=hvd.Average)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = _train_steps(f"fused xent {name} steps", opt,
                                      lambda: fn(model, tokens, labels), 2)
            peaks[name] = {"peak_memory_gb":
                           torch.cuda.max_memory_allocated() / 1e9,
                           "losses": losses, "step_ms": ms}
            prof = _profile_step(
                lambda: _step(opt, lambda: fn(model, tokens, labels)))
            peaks[name]["device_busy_ms"] = prof["device_busy_ms"]
            peaks[name]["profiled_wall_ms"] = prof["wall_ms"]
            opt.remove_hooks()
            del opt
            model.zero_grad(set_to_none=True)
        # flush: 6 passes at k = 4
        inner = torch.optim.SGD(model.parameters(), lr=0.01)
        steps = [0]
        inner_step = inner.step

        def counted(closure=None):
            steps[0] += 1
            return inner_step(closure)

        inner.step = counted
        opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(),
            backward_passes_per_step=4)
        for _ in range(6):
            opt.zero_grad(set_to_none=True)
            _fused_loss(model, tokens, labels).backward()
            opt.step()
        w_before = model.lm_head.bias.detach().clone()
        opt.flush()
        flushed = not torch.equal(model.lm_head.bias, w_before)
        if steps[0] != 2 or not flushed or opt.flush() is not None:
            fail(f"flush: {steps[0]} inner steps after 6 passes at k=4 "
                 f"and a flush (2 expected), parameters moved: {flushed}")
        opt.remove_hooks()
        # the guard: a NaN in one gradient skips the step on every rank
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters(), grad_guard=True)
        skips0 = hvd.guard_status()["nonfinite_steps"]
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt.zero_grad(set_to_none=True)
        loss = _fused_loss(model, tokens, labels)
        (loss + model.lm_head.bias[0] * float("nan")).backward()
        opt.step()
        unchanged = all(torch.equal(p, before[n])
                        for n, p in model.named_parameters())
        skipped = hvd.guard_status()["nonfinite_steps"] - skips0
        opt.zero_grad(set_to_none=True)
        _fused_loss(model, tokens, labels).backward()
        opt.step()
        applied = not torch.equal(model.lm_head.bias, before["lm_head.bias"])
        if not unchanged or skipped != 1 or not applied:
            fail(f"guard: NaN step left the parameters unchanged: "
                 f"{unchanged}, skips counted {skipped} (1 expected), the "
                 f"next good step applied: {applied}")
        opt.remove_hooks()
        launches, tc_launches = _read_flash()
        summary = {
            "model": "gpt2_medium", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "vocab": cfg.vocab_size, "chunk": 8192,
            "compute_dtype": "bfloat16 operands, fp32 results",
            "loss_dense": l_d, "loss_fused": l_f,
            "loss_gradient_rel_diff": head_rel,
            "model_worst_gradient_rel_diff": worst,
            "model_top5_gradient_rel_diff": top5,
            "model_gradient_readings": readings,
            "model_gradient_limits": limits,
            "planted_dh_scale": PLANTED_DH_SCALE, "steps": peaks,
            "forward_backward_peak_memory_gb": fwd_bwd_peak,
            "phase5_peak_memory_gb": phase5_peak_gb,
            "flush_inner_steps": steps[0], "guard_skipped": skipped,
            "flash_launches": launches, "card": card,
        }
        log("fused xent: " + json.dumps(summary, sort_keys=True))
        del model
        return launches, tc_launches
    finally:
        hvd.shutdown()


# ------------------------------------------ phase 13 the two-level route

HIER_WORLD, HIER_INTRA = 4, 2
HIER_STEPS = 3
HIER_BATCH_ELEMS = 64 * 1024 * 1024 // 4  # one 64 MiB fp32 fused batch
HIER_ADASUM_ELEMS = 1 << 20
HIER_TIMEOUT_S = 360
ADASUM_REL_BOUND = 2.0e-7  # phase 9's reading of the tree against plain


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(*tensors) -> str:
    """One hash of the tensors' bits, to compare ranks bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_inputs(n, m, seed, lo=None, hi=None):
    """Every rank's input on the card, from ``seed + r``: integers in
    [lo, hi] as fp32, or N(0, 1) without bounds."""
    import torch

    rows = []
    for r in range(n):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + r)
        if lo is None:
            rows.append(torch.randn(m, generator=g, device="cuda"))
        else:
            rows.append(torch.randint(lo, hi + 1, (m,), generator=g,
                                      device="cuda").float())
    return rows


def _hier_kernels_vs_plain(n):
    """B3 at the inter hop's rows of a 64 MiB batch and B4 at
    hierarchical Adasum's shard halves, against their plain versions
    (B3 bit for bit, B4 within 1e-5 of the largest magnitude)."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    L, H = HIER_INTRA, n // HIER_INTRA
    chunks = _rank_inputs(1, HIER_BATCH_ELEMS // L, 41)[0].view(H, -1)
    q, s = ck.int8_block_quantize(chunks, 512, seed=3, stream=5, rows=True)
    qp, sp = ck.int8_block_quantize_plain(chunks, 512, seed=3, stream=5,
                                          rows=True)
    b3 = torch.equal(q, qp) and torch.equal(s, sp)
    a, b = (x.view(-1) for x in _rank_inputs(2, HIER_ADASUM_ELEMS // (
        2 * L), 43))
    dots = ck.adasum_dots(a, b)
    out = ck.adasum_apply(a, b, dots)
    want = ck.adasum_apply_plain(a, b, ck.adasum_dots_plain(a, b))
    b4 = float((out - want).abs().max() / want.abs().max())
    return {"b3_rows": list(chunks.shape), "b3_bitwise": b3,
            "b4_numel": a.numel(), "b4_rel_err": b4}


def _handed_bounds(P, batches, L, H, block):
    """Bounds on the bytes a step of ``batches`` two-level hier_int8
    batches with a residual, ``P`` elements in all, hands each hop's
    collectives: a batch of m elements pads to m_pad (below m + L) and
    hands the intra hops ``2 m_pad`` (the bf16 reduce-scatter), ``2 m_pad
    / L`` (the allgather) and ``4 m_pad / L`` (the fp32 residual shard),
    and the inter hop ``(H + 1) (chunk + 4 nb)``, chunk = ceil(m_pad / L /
    H) int8 values and nb = ceil(chunk / block) fp32 scales."""
    per = (2 * L + 6) / L
    intra = (P * per, (P + batches * (L - 1)) * per)
    shards = P / (L * H)
    inter = ((H + 1) * shards * (1 + 4 / block),
             (H + 1) * ((shards + 2 * batches) * (1 + 4 / block)
                        + 4 * batches))
    return intra, inter


def _staged_step(opt, loss_fn):
    """:func:`_step`, reading the allocator after each stage: returns the
    loss and GB allocated after the stage (``state``: once the gradients
    are let go) and at its peak."""
    import torch

    mem = {}

    def read(stage):
        mem[stage] = torch.cuda.memory_allocated() / 1e9
        mem[stage + "_peak"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    opt.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    mem["state"] = torch.cuda.memory_allocated() / 1e9
    loss = loss_fn()
    read("forward")
    loss.backward()
    read("backward")
    opt.step()
    read("step")
    return loss, mem


def _hier_rank(rank, n, port, results):
    """One rank of phase 13: its own process on the one card, in a gloo
    world that it makes and ``hvd.init`` adopts. Puts ``(rank, readings)``
    on ``results``; any failed check is a reading the parent fails on,
    and an exception ends the process non-zero."""
    os.environ.update(HOROVOD_INTRA_SIZE=str(HIER_INTRA),
                      HOROVOD_HIERARCHICAL="on", HOROVOD_RANK=str(rank),
                      HOROVOD_SIZE=str(n))
    sys.path.insert(0, HERE)
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.ops.fusion import hop_bytes

    hvd.init(device="cuda")
    st = basics.state()
    fusion = st.fusion
    L, H = hvd.local_size(), hvd.cross_size()
    out = {"rank": rank, "adopted": not st.owns_group, "L": L, "H": H}
    if rank == 0:
        out["kernels_vs_plain"] = _hier_kernels_vs_plain(n)
    for k in ck.KERNELS:
        k.launches = 0
    _zero_flash()
    dev = torch.device("cuda")
    checks = {}

    # (a) integer-valued fp32: the two-level route against the flat
    # route (an empty join mask keeps a batch flat) and the exact sum
    xs = _rank_inputs(n, 1 << 20, 100, -1000, 1000)
    exact = torch.stack(xs).sum(0)
    h0 = fusion.hier_dispatches
    two = [hvd.allreduce(xs[rank], op=op) for op in (hvd.Sum, hvd.Average)]
    checks["allreduce_took_two_level"] = fusion.hier_dispatches - h0 == 2
    with hvd.join_ranks([]):
        flat = [hvd.allreduce(xs[rank], op=op)
                for op in (hvd.Sum, hvd.Average)]
    checks["allreduce_sum_equals_flat_and_exact"] = (
        torch.equal(two[0], flat[0]) and torch.equal(two[0], exact))
    checks["allreduce_avg_equals_flat"] = (
        torch.equal(two[1], flat[1]) and torch.equal(two[1], exact / n))
    panes = _rank_inputs(n, 2 * n * 1000, 200, -1000, 1000)
    got = hvd.reducescatter(panes[rank].view(2 * n, 1000), op=hvd.Sum)
    want = torch.stack(panes).sum(0).view(2 * n, 1000)[2 * rank:2 * rank + 2]
    checks["reducescatter_even"] = torch.equal(got, want)
    uneven = _rank_inputs(n, (n + 1) * 1000, 300, -1000, 1000)
    got = hvd.reducescatter(uneven[rank].view(n + 1, 1000), op=hvd.Average)
    rows = slice(0, 2) if rank == 0 else slice(rank + 1, rank + 2)
    want = (torch.stack(uneven).sum(0).view(n + 1, 1000) / n)[rows]
    checks["reducescatter_uneven"] = torch.equal(got, want)
    base = torch.arange(2 * n * 7, device=dev, dtype=torch.float32).view(
        2 * n, 7)
    got = hvd.alltoall(base + 1000 * rank)
    want = torch.cat([(base + 1000 * s)[2 * rank:2 * rank + 2]
                      for s in range(n)])
    checks["alltoall_equal"] = torch.equal(got, want)
    sends = torch.full((sum(range(1, n + 1)), 3), float(rank), device=dev)
    got, splits = hvd.alltoall(sends, splits=list(range(1, n + 1)))
    want = torch.cat([torch.full((rank + 1, 3), float(s), device=dev)
                      for s in range(n)])
    checks["alltoall_splits"] = (torch.equal(got, want)
                                 and splits.tolist() == [rank + 1] * n)
    gathered = hvd.grouped_allgather([xs[rank][:5], panes[rank][:3]])
    checks["grouped_allgather"] = (
        torch.equal(gathered[0], torch.cat([x[:5] for x in xs]))
        and torch.equal(gathered[1], torch.cat([p[:3] for p in panes])))
    grouped = hvd.grouped_reducescatter(
        [panes[rank].view(2 * n, 1000), uneven[rank].view(n + 1, 1000)],
        op=hvd.Sum)
    checks["grouped_reducescatter"] = (
        torch.equal(grouped[0], torch.stack(panes).sum(0).view(
            2 * n, 1000)[2 * rank:2 * rank + 2])
        and torch.equal(grouped[1], torch.stack(uneven).sum(0).view(
            n + 1, 1000)[rows]))
    with hvd.join_ranks([n - 1]):
        got = hvd.allreduce(xs[rank], op=hvd.Average)
    checks["join_masked_average"] = torch.equal(
        got, torch.stack(xs[:n - 1]).sum(0) / (n - 1))

    # (b) hier_int8 on one 64 MiB fused batch: integers bf16 carries
    # exactly, so the intra hops are exact and the error is the inter
    # hop's two stages plus the last bf16 rounding
    xs = _rank_inputs(n, HIER_BATCH_ELEMS, 400, -64, 64)
    exact = torch.stack(xs).sum(0)
    nodes = [torch.stack(xs[h * L:(h + 1) * L]).sum(0) for h in range(H)]
    counters = ("wire_bytes_intra", "wire_bytes_inter", "handed_bytes_intra",
                "handed_bytes_inter")
    before = [getattr(fusion, c) for c in counters]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = hvd.allreduce(xs[rank], op=hvd.Sum,
                        compression=hvd.Compression.hier_int8)
    torch.cuda.synchronize()
    moved = [getattr(fusion, c) - b for c, b in zip(counters, before)]
    chunk = -(-HIER_BATCH_ELEMS // (L * H))
    shaped = [2 * HIER_BATCH_ELEMS + 2 * HIER_BATCH_ELEMS // L,
              (H + 1) * (chunk + 4 * -(-chunk // 512))]
    big = float(exact.abs().max())
    budget = (sum(float(s.abs().max()) for s in nodes) + 1.01 * big) / 127 \
        + big * 2.0 ** -8
    out["hier_int8"] = {
        "elems": HIER_BATCH_ELEMS, "ms": (time.monotonic() - t0) * 1e3,
        "max_abs_err": float((got - exact).abs().max()), "budget": budget,
        "digest": _digest(got),
        "intra_bytes": moved[0], "inter_bytes": moved[1],
        "handed_intra_bytes": moved[2], "handed_inter_bytes": moved[3],
        "shape_handed_bytes": shaped,
        "model_intra_bytes": hop_bytes(HIER_BATCH_ELEMS, "bf16", 4, L,
                                       512)[0],
        "model_inter_bytes": hop_bytes(-(-HIER_BATCH_ELEMS // L), "int8", 4,
                                       H, 512)[0]}
    checks["hier_int8_within_budget"] = (
        out["hier_int8"]["max_abs_err"] <= budget)
    # counted at the collectives' calls, against the batch's shapes
    checks["hier_int8_handed_bytes"] = moved[2:] == shaped
    del xs, exact, nodes, got

    # (c) hierarchical Adasum: fp32 against the fp64 host oracle over the
    # per-node sums, int8 within its quanta; every rank bitwise equal
    xs = _rank_inputs(n, HIER_ADASUM_ELEMS, 500)
    fp32 = hvd.adasum_allreduce(xs[rank], hierarchical=True)
    int8 = hvd.adasum_allreduce(xs[rank], hierarchical=True,
                                inter_wire="int8", seed=11)
    want = adasum.adasum_vhdd_host([
        torch.stack(xs[h * L:(h + 1) * L]).double().sum(0).cpu().numpy()
        for h in range(H)])
    scale = float(np.abs(want).max())
    rel = float(np.abs(fp32.double().cpu().numpy() - want).max()) / scale
    quanta = float(np.abs(int8.double().cpu().numpy() - want).max()) / (
        scale / 127)
    out["adasum"] = {"elems": HIER_ADASUM_ELEMS, "fp32_rel_err": rel,
                     "int8_err_quanta": quanta,
                     "fp32_digest": _digest(fp32),
                     "int8_digest": _digest(int8)}
    checks["adasum_fp32_within_bound"] = rel <= ADASUM_REL_BOUND
    checks["adasum_int8_within_quanta"] = quanta <= 6.0
    del xs

    # (d) GPT-2 medium at full width through DistributedOptimizer on
    # hier_int8 with error feedback: each rank a quarter of phase 5's batch
    cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = Transformer(cfg, device="cuda", generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters(), op=hvd.Average,
        compression=hvd.Compression.hier_int8, error_feedback=True)
    tokens, labels = _lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    per = TRAIN_BATCH // n
    mine = slice(rank * per, (rank + 1) * per)
    params = list(model.parameters())
    counters = {"intra_bytes": "wire_bytes_intra",
                "inter_bytes": "wire_bytes_inter",
                "hier_batches": "hier_dispatches",
                "handed_intra_bytes": "handed_bytes_intra",
                "handed_inter_bytes": "handed_bytes_inter"}
    train = {"losses": [], "step_ms": [], "param_digests": [],
             "memory_gb": [], **{key: [] for key in counters}}
    for _ in range(HIER_STEPS):
        before = {key: getattr(fusion, c) for key, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss, mem = _staged_step(
            opt, lambda: _loss(model, tokens[mine], labels[mine]))
        train["losses"].append(float(loss.detach()))
        train["step_ms"].append((time.monotonic() - t0) * 1e3)
        train["param_digests"].append(_digest(*params))
        train["memory_gb"].append(mem)
        for key, c in counters.items():
            train[key].append(getattr(fusion, c) - before[key])
    numel = sum(p.numel() for p in params)
    handed_ok = True
    for step in range(HIER_STEPS):
        bounds = _handed_bounds(numel, train["hier_batches"][step], L, H, 512)
        for (lo, hi), key in zip(bounds, ("handed_intra_bytes",
                                          "handed_inter_bytes")):
            handed_ok &= lo <= train[key][step] <= hi
    checks["train_handed_bytes_within_shapes"] = handed_ok
    train.update(
        params=numel, handed_bounds=_handed_bounds(
            numel, train["hier_batches"][-1], L, H, 512),
        peak_memory_gb=max(v for m in train["memory_gb"]
                           for k, v in m.items() if k.endswith("_peak")),
        residual_norm=opt.residual_norm(),
        model_intra_bytes=hop_bytes(numel, "bf16", 4, L, 512)[0],
        model_inter_bytes=hop_bytes(-(-numel // L), "int8", 4, H, 512)[0])
    out["train"] = train
    out["launches"] = {k.__name__: k.launches for k in ck.KERNELS}
    out["flash"] = _read_flash()
    out["checks"] = checks
    opt.remove_hooks()
    hvd.shutdown()
    dist.destroy_process_group()
    results.put((rank, out))


def phase_hier(card, fp32_bytes_per_step):
    """Phase 13: the two-level route in a world of 4 processes, all on
    the one card, over gloo (NCCL refuses two ranks on one device), with
    ``HOROVOD_INTRA_SIZE=2`` and ``HOROVOD_HIERARCHICAL=on``: 2 nodes of
    2 ranks. Each rank (:func:`_hier_rank`, started fresh, its counters
    at 0) holds B3 and B4 against their plain versions at this phase's
    shapes (rank 0), then on integer-valued fp32 compares the two-level
    allreduce with the flat route and the exact sum, reducescatter even
    and uneven, alltoall equal and with splits, the grouped allgather
    and reducescatter and a join-masked Average, bit for bit; runs
    ``Compression.hier_int8`` on a 64 MiB batch within the two-stage
    quantum budget, the bytes it handed each hop's collectives equal to
    its shapes'; hierarchical Adasum in fp32 (within 2.0e-7 of the
    fp64 host oracle over the node sums) and with the int8 inter wire
    (within 6 quanta); and trains GPT-2 medium at full width 3 steps
    through ``DistributedOptimizer(compression=Compression.hier_int8,
    error_feedback=True)``, each rank a quarter of phase 5's batch, the
    bytes handed each hop within :func:`_handed_bounds` and the
    allocator read after each stage of a step. Every rank must give the
    same bits, and the parameters must agree after
    every step. Returns the launches of B3, B4 and the flash kernels,
    summed over the ranks."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    n = HIER_WORLD
    procs = [ctx.Process(target=_hier_rank, args=(r, n, port, results),
                         daemon=True) for r in range(n)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    while len(got) < n:
        waited = time.monotonic() - t0
        dead = [r for r, p in enumerate(procs)
                if p.exitcode not in (None, 0)]
        if dead or waited > HIER_TIMEOUT_S:
            for p in procs:
                p.kill()
            fail(f"hier: ranks {dead} ended with "
                 f"{[procs[r].exitcode for r in dead]}" if dead else
                 f"hier: the world did not finish in {HIER_TIMEOUT_S} s")
        try:
            rank, out = results.get(timeout=5)
        except queue.Empty:
            continue
        got[rank] = out
    for p in procs:
        p.join(timeout=60)
        if p.exitcode != 0:
            p.kill()
            fail(f"hier: a rank exited with {p.exitcode}")
    wall_s = time.monotonic() - t0
    outs = [got[r] for r in range(n)]
    for o in outs:
        bad = [k for k, ok in o["checks"].items() if not ok]
        if bad:
            fail(f"hier rank {o['rank']}: failed {bad}")
        if not o["adopted"] or (o["L"], o["H"]) != (HIER_INTRA,
                                                    n // HIER_INTRA):
            fail(f"hier rank {o['rank']}: world {o['L']} x {o['H']}, "
                 f"adopted {o['adopted']}")
    kvp = outs[0]["kernels_vs_plain"]
    if not kvp["b3_bitwise"] or kvp["b4_rel_err"] > 1e-5:
        fail(f"hier: kernels against plain {kvp}")
    for key in (("hier_int8", "digest"), ("adasum", "fp32_digest"),
                ("adasum", "int8_digest")):
        if len({o[key[0]][key[1]] for o in outs}) != 1:
            fail(f"hier: the ranks' {'/'.join(key)} differ")
    for step in range(HIER_STEPS):
        if len({o["train"]["param_digests"][step] for o in outs}) != 1:
            fail(f"hier train step {step}: the ranks' parameters differ")
    losses = [sum(o["train"]["losses"][s] for o in outs) / n
              for s in range(HIER_STEPS)]
    step_ms = [max(o["train"]["step_ms"][s] for o in outs)
               for s in range(HIER_STEPS)]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < \
            losses[0]:
        fail(f"hier train: the mean loss did not fall: {losses}")
    if max(step_ms) > 60e3:
        fail(f"hier train: a step took {max(step_ms):.0f} ms (over 60 s)")
    t = outs[0]["train"]
    if any(b < 1 for b in t["hier_batches"]) or any(
            b != t["model_intra_bytes"] for b in t["intra_bytes"]):
        fail(f"hier train: two-level batches {t['hier_batches']}, intra "
             f"bytes {t['intra_bytes']} (model {t['model_intra_bytes']})")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in outs[0]["launches"]}
    flash = ({k: sum(o["flash"][0][k] for o in outs)
              for k in outs[0]["flash"][0]},
             {k: sum(o["flash"][1][k] for o in outs)
              for k in outs[0]["flash"][1]})
    for name in ("int8_block_quantize", "adasum_dots", "adasum_apply"):
        if launches[name] < 1:
            fail(f"hier: {name} never launched in the phase")
    if min(flash[1].values()) < 1:
        fail(f"hier: a flash kernel took no tensor-core launch {flash[1]}")
    log("hier: " + json.dumps({
        "world": n, "intra": HIER_INTRA, "backend": "gloo, one card",
        "wall_s": wall_s, "mean_losses": losses, "step_ms_max_rank":
        step_ms, "step_ms_by_rank": [o["train"]["step_ms"] for o in outs],
        "bytes_per_step": {
            "intra": t["intra_bytes"], "inter": t["inter_bytes"],
            "model_intra": t["model_intra_bytes"],
            "model_inter": t["model_inter_bytes"],
            "handed_intra": t["handed_intra_bytes"],
            "handed_inter": t["handed_inter_bytes"],
            "handed_bounds_last_step": t["handed_bounds"],
            "phase5_fp32": fp32_bytes_per_step,
            "intra_over_phase5": t["intra_bytes"][-1] / fp32_bytes_per_step,
            "inter_over_phase5": t["inter_bytes"][-1] / fp32_bytes_per_step},
        "two_level_batches_per_step": t["hier_batches"],
        "params": t["params"],
        "peak_memory_gb_by_rank": [o["train"]["peak_memory_gb"]
                                   for o in outs],
        "memory_gb_by_stage_rank0": t["memory_gb"],
        "residual_norm": t["residual_norm"],
        "hier_int8": {k: v for k, v in outs[0]["hier_int8"].items()
                      if k != "digest"},
        "adasum": {k: v for k, v in outs[0]["adasum"].items()
                   if "digest" not in k},
        "kernels_vs_plain": kvp, "launches": launches,
        "flash_launches": flash[0], "flash_tensor_core_launches": flash[1],
        "card": card,
    }, sort_keys=True))
    return launches, flash


# ----------------------- phase 14 the bucketed overlap and in-step collectives

OVERLAP_BUCKETS = 4
OVERLAP_STEPS = 3
OVERLAP_WORLD = 4
OVERLAP_RANK_STEPS = 2
COMPILED_ELEMS = 64 * 1024 * 1024 // 4  # one 64 MiB fp32 batch
COMPILED_LEAVES = 8
OVERLAP_TIMEOUT_S = 240


def _overlap_opt(hvd, model, buckets, **kw):
    import torch

    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters(), op=hvd.Average,
        overlap_buckets=buckets, **kw)


def _timed_dispatch(opt, events):
    """Wrap ``opt``'s bucket dispatch so that bucket 0 records a CUDA
    event on the compute stream when it is issued and one on the side
    stream once its exchange is enqueued there (done when it is done)."""
    import torch

    inner = opt._overlap.dispatch

    def dispatch(b, passes):
        if b == 0:
            events["issued"] = torch.cuda.Event(enable_timing=True)
            events["issued"].record()
        inner(b, passes)
        if b == 0:
            events["done"] = torch.cuda.Event(enable_timing=True)
            events["done"].record(opt._overlap.stream)

    opt._overlap.dispatch = dispatch


def _overlap_step(opt, model, tokens, labels, events=None):
    """One step of ``opt``; with ``events``, the end of backward on the
    compute stream is recorded as ``events["backward_end"]``."""
    import torch

    opt.zero_grad(set_to_none=True)
    loss = _loss(model, tokens, labels)
    loss.backward()
    if events is not None:
        events["backward_end"] = torch.cuda.Event(enable_timing=True)
        events["backward_end"].record()
    opt.step()
    return loss


def _compiled_exchange(x, tree, zeros):
    """Phase 14 (c)'s function: the exact allreduce, the per-row and
    block-512 int8 wires, and the bucketed int8_block exchange with
    error feedback."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import traced

    exact = traced.allreduce(x, op=hvd.Sum)
    rows = traced.quantized_allreduce(x, op=hvd.Sum, seed=3)
    blocks = traced.quantized_allreduce(x, op=hvd.Sum, seed=3, block_size=512,
                                        return_residual=True)
    red, res = hvd.bucketed_allreduce(
        tree, op=hvd.Sum, n_buckets=OVERLAP_BUCKETS,
        compression=hvd.Compression.int8_block, residuals=zeros, seed=5,
        min_bucket_bytes=0, hier_stages=None)
    return exact, rows, blocks, red, res


def _compiled_phase(gen):
    """Phase 14 (c): the eager call, then ``torch.compile(fullgraph=True)``
    of the same function, on one 64 MiB batch; bitwise equal under the
    same seed, B2 and B3 launched inside the compiled call, every output
    within the two-stage budget of the fp64 input."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    x = torch.randn(COMPILED_ELEMS, generator=gen, device="cuda")
    tree = {f"g{i}": torch.randn(COMPILED_ELEMS // COMPILED_LEAVES,
                                 generator=gen, device="cuda")
            for i in range(COMPILED_LEAVES)}
    zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
    counters = (ck.int8_quantize, ck.int8_block_quantize)
    launches = [0, 0]

    def timed(fn):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn(x, tree, zeros)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        got = [c.launches - b for c, b in zip(counters, before)]
        for i, g in enumerate(got):
            launches[i] += g
        return out, ms, got

    eager, _, _ = timed(_compiled_exchange)
    eager, eager_ms, eager_launches = timed(_compiled_exchange)
    # eager's arithmetic: no contraction of a product and a sum into one
    # fma (the residual's x − q·s would round once instead of twice)
    os.environ["TRITON_DEFAULT_FP_FUSION"] = "0"
    from torch._inductor import config as inductor_config

    with inductor_config.patch(emulate_precision_casts=True):
        compiled_fn = torch.compile(_compiled_exchange, fullgraph=True)
        compiled, compile_ms, _ = timed(compiled_fn)
    compiled, compiled_ms, compiled_launches = timed(compiled_fn)
    names = ["exact", "rows", "block512", "block512_residual"] + [
        f"bucketed.{k}" for k in tree] + [f"bucketed_residual.{k}"
                                          for k in tree]
    flat = lambda out: [out[0], out[1], out[2][0], out[2][1],  # noqa
                        *out[3].values(), *out[4].values()]
    unequal = [n for n, a, b in zip(names, flat(eager), flat(compiled))
               if not torch.equal(a, b)]
    bitwise = not unequal
    big = float(x.abs().max())
    budget = 2.02 * big / 127
    errs = {"exact": float((compiled[0] - x).abs().max()),
            "rows": float((compiled[1].double() - x.double()).abs().max()),
            "block512": float((compiled[2][0].double()
                               - x.double()).abs().max()),
            "bucketed": max(float((compiled[3][k].double()
                                   - v.double()).abs().max())
                            for k, v in tree.items())}
    leaf_big = max(float(v.abs().max()) for v in tree.values())
    checks = {"compiled_equals_eager_bitwise": bitwise,
              "exact_is_input": errs["exact"] == 0.0,
              "b2_in_compiled_call": compiled_launches[0] >= 1,
              "b3_in_compiled_call": compiled_launches[1] >= 1,
              "rows_within_budget": errs["rows"] <= budget,
              "block512_within_budget": errs["block512"] <= budget,
              "bucketed_within_budget":
                  errs["bucketed"] <= 2.02 * leaf_big / 127}
    return {"elems": COMPILED_ELEMS, "leaves": COMPILED_LEAVES,
            "eager_ms": eager_ms, "compiled_ms": compiled_ms,
            "first_compiled_call_ms": compile_ms,
            "eager_launches_b2_b3": eager_launches,
            "unequal_outputs": unequal,
            "compiled_launches_b2_b3": compiled_launches,
            "max_abs_err": errs, "budget": budget,
            "backend": "inductor"}, checks, launches


def _overlap_rank(rank, n, port, results):
    """One rank of phase 14 (d): its own process on the one card in a
    gloo world of 2 nodes of 2, as phase 13's. Puts ``(rank, readings)``
    on ``results``."""
    os.environ.update(HOROVOD_INTRA_SIZE=str(HIER_INTRA),
                      HOROVOD_HIERARCHICAL="on", HOROVOD_RANK=str(rank),
                      HOROVOD_SIZE=str(n))
    sys.path.insert(0, HERE)
    import dataclasses

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.common import topology
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.ops import traced

    hvd.init(device="cuda")
    for k in ck.KERNELS:
        k.launches = 0
    _zero_flash()
    checks, out = {}, {"rank": rank}
    stages = topology.hierarchy_stages()
    # integer-valued fp32: the in-step collectives against the exact sums
    # and the two-level recipe against the flat one, bit for bit
    xs = _rank_inputs(n, 1 << 20, 600, -1000, 1000)
    exact = torch.stack(xs).sum(0)
    flat = traced.allreduce(xs[rank], op=hvd.Sum)
    checks["allreduce"] = torch.equal(flat, exact)
    checks["allreduce_avg"] = torch.equal(traced.allreduce(xs[rank]),
                                          exact / n)
    hier = traced.hierarchical_allreduce_groups(xs[rank], op=hvd.Sum,
                                                stages=stages)
    checks["two_level_equals_flat"] = torch.equal(hier, flat)
    panes = _rank_inputs(n, 2 * n * 1000, 700, -1000, 1000)
    got = traced.reducescatter(panes[rank].view(2 * n, 1000), op=hvd.Sum)
    want = torch.stack(panes).sum(0).view(2 * n, 1000)[2 * rank:2 * rank + 2]
    checks["reducescatter"] = torch.equal(got, want)
    got = traced.allgather(xs[rank][:1000].view(10, 100))
    checks["allgather"] = torch.equal(
        got, torch.cat([x[:1000].view(10, 100) for x in xs]))
    got = traced.alltoall(panes[rank].view(2 * n, 1000))
    checks["alltoall"] = torch.equal(got, torch.cat(
        [p.view(2 * n, 1000)[2 * rank:2 * rank + 2] for p in panes]))
    # the quantized wires within their two-stage budgets
    ys = _rank_inputs(n, 1 << 20, 800)
    yexact = torch.stack(ys).double().sum(0)
    nodes = [torch.stack(ys[h * HIER_INTRA:(h + 1) * HIER_INTRA]).sum(0)
             for h in range(n // HIER_INTRA)]
    flat_budget = 1.01 * (sum(float(y.abs().max()) for y in ys)
                          + float(yexact.abs().max())) / 127
    hier_budget = 1.01 * (sum(float(v.abs().max()) for v in nodes)
                          + float(yexact.abs().max())) / 127
    q = traced.quantized_allreduce(ys[rank], op=hvd.Sum, seed=3,
                                   block_size=512)
    qrows = traced.quantized_allreduce(ys[rank], op=hvd.Sum, seed=3)
    hq = traced.hierarchical_quantized_allreduce(ys[rank], op=hvd.Sum,
                                                 seed=3)
    errs = {"block512": float((q.double() - yexact).abs().max()),
            "rows": float((qrows.double() - yexact).abs().max()),
            "hierarchical": float((hq.double() - yexact).abs().max())}
    checks["quantized_within_budget"] = max(errs["block512"],
                                            errs["rows"]) <= flat_budget
    checks["hierarchical_quantized_within_budget"] = (
        errs["hierarchical"] <= hier_budget)
    out["quantized"] = {"errs": errs, "flat_budget": flat_budget,
                        "hier_budget": hier_budget,
                        "digest": _digest(q, qrows, hq)}
    del xs, exact, panes, ys, nodes
    # GPT-2 medium: overlapped buckets on hier_int8 with error feedback
    cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = Transformer(cfg, device="cuda", generator=gen)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = _overlap_opt(hvd, model, OVERLAP_BUCKETS,
                       compression=hvd.Compression.hier_int8,
                       error_feedback=True)
    tokens, labels = _lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    per = TRAIN_BATCH // n
    mine = slice(rank * per, (rank + 1) * per)
    params = list(model.parameters())
    train = {"losses": [], "step_ms": [], "param_digests": [],
             "dispatched": []}
    for _ in range(OVERLAP_RANK_STEPS):
        before = opt._overlap.dispatched
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = _overlap_step(opt, model, tokens[mine], labels[mine])
        train["losses"].append(float(loss.detach()))
        train["step_ms"].append((time.monotonic() - t0) * 1e3)
        train["param_digests"].append(_digest(*params))
        train["dispatched"].append(opt._overlap.dispatched - before)
    checks["one_collective_a_bucket"] = all(
        d == opt._overlap.schedule.n_buckets for d in train["dispatched"])
    train["residual_norm"] = opt.residual_norm()
    train["buckets"] = list(opt._overlap.schedule.bucket_bytes)
    out["train"] = train
    out["launches"] = {k.__name__: k.launches for k in ck.KERNELS}
    out["flash"] = _read_flash()
    out["checks"] = checks
    opt.remove_hooks()
    hvd.shutdown()
    dist.destroy_process_group()
    results.put((rank, out))


def _overlap_world():
    """Phase 14 (d): :func:`_overlap_rank` in 4 processes; returns every
    rank's readings, in rank order."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    n = OVERLAP_WORLD
    procs = [ctx.Process(target=_overlap_rank, args=(r, n, port, results),
                         daemon=True) for r in range(n)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    while len(got) < n:
        dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if dead or time.monotonic() - t0 > OVERLAP_TIMEOUT_S:
            for p in procs:
                p.kill()
            fail(f"overlap world: ranks {dead} ended with "
                 f"{[procs[r].exitcode for r in dead]}" if dead else
                 f"overlap world: not done in {OVERLAP_TIMEOUT_S} s")
        try:
            rank, out = results.get(timeout=5)
        except queue.Empty:
            continue
        got[rank] = out
    for p in procs:
        p.join(timeout=60)
        if p.exitcode != 0:
            p.kill()
            fail(f"overlap world: a rank exited with {p.exitcode}")
    return [got[r] for r in range(n)], time.monotonic() - t0


def phase_overlap(gen, card, phase5):
    """Phase 14: (a) GPT-2 medium at full width (phase 5's configuration,
    a world of one on NCCL) through ``DistributedOptimizer(overlap_buckets
    =4)`` and with overlap off, on the same state and 3 batches, in turns:
    the parameters bitwise equal after every step, one collective a bucket
    a step and no fused batch, bucket 0's collective issued before
    backward's last kernel ends (CUDA events), one step profiled with a
    range a bucket; the host-clock step, busy share and peak beside phase
    5's (``phase5``), as readings. (b) The parameters through
    ``overlap_boundary`` (kept over backward, which remat recomputes):
    the gradients bitwise (a)'s reduced ones. (c) :func:`_compiled_phase`.
    (d) :func:`_overlap_world`. Returns the launches of B2, B3 and the
    flash kernels, the ranks' summed."""
    import dataclasses

    import torch
    from torch.nn.utils import stateless

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import overlap

    t_phase = time.monotonic()
    hvd.init()
    try:
        cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
        on_model = Transformer(cfg, device="cuda", generator=gen)
        off_model = Transformer(cfg, device="cuda")
        off_model.load_state_dict(on_model.state_dict())
        overlap.reset_schedule_cache()
        on = _overlap_opt(hvd, on_model, OVERLAP_BUCKETS)
        off = _overlap_opt(hvd, off_model, 0)
        sched = on._overlap.schedule
        batches = [_lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                             SEED + i) for i in range(OVERLAP_STEPS)]
        fusion = basics.state().fusion
        _zero_flash()
        torch.cuda.reset_peak_memory_stats()
        events = {}
        _timed_dispatch(on, events)
        readings = {"on": {"step_ms": [], "losses": []},
                    "off": {"step_ms": [], "losses": []},
                    "bucket0_issued_before_backward_end_ms": [],
                    "bucket0_done_before_backward_end_ms": [],
                    "dispatched": [], "fused_batches_on": []}
        bitwise = []
        for i, (tokens, labels) in enumerate(batches):
            order = (("on", on_model, on), ("off", off_model, off))
            for name, model, opt in (order if i % 2 == 0 else order[::-1]):
                d0, f0 = on._overlap.dispatched, fusion.dispatched_batches
                torch.cuda.synchronize()
                t0 = time.monotonic()
                loss = _overlap_step(opt, model, tokens, labels,
                                     events if name == "on" else None)
                readings[name]["losses"].append(float(loss.detach()))
                readings[name]["step_ms"].append(
                    (time.monotonic() - t0) * 1e3)
                if name == "on":
                    readings["dispatched"].append(on._overlap.dispatched - d0)
                    readings["fused_batches_on"].append(
                        fusion.dispatched_batches - f0)
                    readings["bucket0_issued_before_backward_end_ms"].append(
                        events["issued"].elapsed_time(events["backward_end"]))
                    readings["bucket0_done_before_backward_end_ms"].append(
                        events["done"].elapsed_time(events["backward_end"]))
            bitwise.append(all(torch.equal(a, b) for a, b in zip(
                on_model.parameters(), off_model.parameters())))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not all(bitwise):
            fail(f"overlap: parameters with overlap on and off differ after "
                 f"steps {[i for i, b in enumerate(bitwise) if not b]}")
        if any(d != sched.n_buckets for d in readings["dispatched"]) or any(
                readings["fused_batches_on"]):
            fail(f"overlap: bucket collectives a step "
                 f"{readings['dispatched']} (schedule {sched.n_buckets}), "
                 f"fused batches {readings['fused_batches_on']}")
        if not min(readings["bucket0_issued_before_backward_end_ms"]) > 0:
            fail("overlap: bucket 0's collective was not issued before "
                 "backward's last kernel ended: "
                 f"{readings['bucket0_issued_before_backward_end_ms']}")
        losses = readings["on"]["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"overlap: non-finite loss {losses}")
        tokens, labels = batches[0]
        prof = _profile_step(
            lambda: _overlap_step(on, on_model, tokens, labels),
            range_prefix="hvd.overlap.bucket")
        if len(prof["ranges"]) != sched.n_buckets:
            fail(f"overlap: profiled bucket ranges {prof['ranges']}")

        # (b) the boundary's gradients against (a)'s reduced gradients
        on.zero_grad(set_to_none=True)
        _loss(on_model, tokens, labels).backward()
        on.synchronize()
        reduced = [p.grad.clone() for p in on_model.parameters()]
        on.remove_hooks()
        off.remove_hooks()
        off_model.load_state_dict(on_model.state_dict())
        off_model.zero_grad(set_to_none=True)
        params = dict(off_model.named_parameters())
        through = hvd.overlap_boundary(params, n_buckets=OVERLAP_BUCKETS)
        with stateless._reparametrize_module(off_model, through):
            _loss(off_model, tokens, labels).backward()
        boundary = [p.grad for p in off_model.parameters()]
        if not all(g is not None and torch.equal(g, r)
                   for g, r in zip(boundary, reduced)):
            fail("overlap: the boundary's gradients differ from the "
                 "optimizer's reduced gradients")
        flash = _read_flash()
        del on_model, off_model, on, off, reduced, boundary, through, params
        torch.cuda.empty_cache()

        # (c) the compiled exchange
        t0 = time.monotonic()
        compiled, checks, wire = _compiled_phase(gen)
        compiled["s"] = time.monotonic() - t0
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"overlap compiled exchange: failed {bad}: "
                 f"{json.dumps(compiled, sort_keys=True)}")
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()

    # (d) the gloo world of 4
    outs, wall_s = _overlap_world()
    for o in outs:
        bad = [k for k, ok in o["checks"].items() if not ok]
        if bad:
            fail(f"overlap rank {o['rank']}: failed {bad}: "
                 f"{json.dumps(o['quantized'], sort_keys=True)}")
    if len({o["quantized"]["digest"] for o in outs}) != 1:
        fail("overlap world: the ranks' quantized outputs differ")
    for step in range(OVERLAP_RANK_STEPS):
        if len({o["train"]["param_digests"][step] for o in outs}) != 1:
            fail(f"overlap world step {step}: the ranks' parameters differ")
    rank_losses = [sum(o["train"]["losses"][s] for o in outs) / len(outs)
                   for s in range(OVERLAP_RANK_STEPS)]
    if not all(math.isfinite(x) for x in rank_losses):
        fail(f"overlap world: non-finite loss {rank_losses}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in outs[0]["launches"]}
    launches["int8_quantize"] += wire[0]
    launches["int8_block_quantize"] += wire[1]
    for name in ("int8_quantize", "int8_block_quantize"):
        if launches[name] < 1:
            fail(f"overlap: {name} never launched in the phase")
    flash = ({k: flash[0][k] + sum(o["flash"][0][k] for o in outs)
              for k in flash[0]},
             {k: flash[1][k] + sum(o["flash"][1][k] for o in outs)
              for k in flash[1]})
    on_ms = readings["on"]["step_ms"][1:]
    off_ms = readings["off"]["step_ms"][1:]
    log("overlap: " + json.dumps({
        "model": "gpt2_medium", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "world": 1, "buckets": sched.n_buckets,
        "bucket_bytes": list(sched.bucket_bytes),
        "bucket_members": [len(b) for b in sched.buckets],
        "schedule_cache": overlap.schedule_cache_stats(),
        "params_bitwise_equal_each_step": bitwise,
        "collectives_per_step": readings["dispatched"],
        "bucket0_issued_before_backward_end_ms":
            readings["bucket0_issued_before_backward_end_ms"],
        "bucket0_done_before_backward_end_ms":
            readings["bucket0_done_before_backward_end_ms"],
        "step_ms_on": readings["on"]["step_ms"],
        "step_ms_off": readings["off"]["step_ms"],
        "step_ms_mean_after_first": {"on": sum(on_ms) / len(on_ms),
                                     "off": sum(off_ms) / len(off_ms),
                                     "phase5": phase5[
                                         "step_ms_mean_after_first"]},
        "device_busy_share": {"on": prof["device_busy_share"],
                              "phase5": phase5["device_busy_share"]},
        "peak_memory_gb": {"on_and_off_models": peak_gb,
                           "phase5": phase5["peak_memory_gb"]},
        "profiled_bucket_ranges_ms": prof["ranges"],
        "profiled_wall_ms": prof["wall_ms"],
        "profiled_device_busy_ms": prof["device_busy_ms"],
        "losses_on": readings["on"]["losses"],
        "boundary_gradients_bitwise": True,
        "compiled": compiled,
        "gloo_world": {
            "world": OVERLAP_WORLD, "intra": HIER_INTRA, "wall_s": wall_s,
            "mean_losses": rank_losses,
            "step_ms_by_rank": [o["train"]["step_ms"] for o in outs],
            "collectives_per_step": outs[0]["train"]["dispatched"],
            "bucket_bytes": outs[0]["train"]["buckets"],
            "residual_norm": outs[0]["train"]["residual_norm"],
            "quantized": {k: v for k, v in outs[0]["quantized"].items()
                          if k != "digest"}},
        "launches": launches, "flash_launches": flash[0],
        "flash_tensor_core_launches": flash[1],
        "phase_s": time.monotonic() - t_phase, "card": card,
    }, sort_keys=True))
    return launches, flash


# ------------------------------------------------------------ phase 15 ZeRO

ZERO_BUCKETS = 4
ZERO_STEPS = 3
ZERO_WORLD = 4
ZERO_RANK_STEPS = 3
ZERO_LR = 1e-4  # bench_zero.py's inner transform is AdamW
ZERO_GATE = 1.8  # bench_zero.py's gate: stage 3's live bytes below stage 1's
ZERO_TIMEOUT_S = 420


def _zero_opt(hvd, model, stage, **kw):
    """AdamW through ``ShardedDistributedOptimizer(zero_stage=stage)``,
    or through ``DistributedOptimizer`` at stage 0."""
    import torch

    inner = torch.optim.AdamW(model.parameters(), lr=ZERO_LR)
    if stage == 0:
        return hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(), op=hvd.Average)
    return hvd.ShardedDistributedOptimizer(
        inner, named_parameters=model.named_parameters(), op=hvd.Average,
        zero_stage=stage, overlap_buckets=ZERO_BUCKETS, **kw)


def _zero_step(opt, model, stage, tokens, labels):
    """One step: ``backward()`` and ``step()`` at stages 0–2, the
    sharded tape at stage 3."""
    opt.zero_grad(set_to_none=True)
    if stage == 3:
        loss, _ = opt.value_and_grad(
            lambda: _loss(model, tokens, labels), model)()
    else:
        loss = _loss(model, tokens, labels)
        loss.backward()
    opt.step()
    return loss


def _zero_params(opt, model, stage):
    """The model's full parameters in order (gathered at stage 3)."""
    if stage == 3:
        full = opt.gather_params(model)
        return [full[name] for name, _ in model.named_parameters()]
    return [p.detach() for p in model.parameters()]


def _device_digest(tensors) -> str:
    """A fingerprint of the tensors' bits taken on the card (the sum of
    each 32-bit word and of each word times its position, in wrapping
    int64), hashed on the host: equal bits give equal digests."""
    import hashlib

    import torch

    sums = []
    for t in tensors:
        v = t.detach().contiguous().view(-1).view(torch.int32).to(torch.int64)
        pos = torch.arange(1, v.numel() + 1, device=v.device,
                           dtype=torch.int64)
        sums += [int(v.sum()), int((v * pos).sum())]
        del v, pos
    return hashlib.sha256(repr(sums).encode()).hexdigest()


def _zero_live_bytes(opt, stage):
    """``bench_zero.py:20-31``'s live parameter-and-gradient bytes of one
    rank, counted from what the optimizer holds: the resident parameters
    (the model's parameter storage, none at stage 3, plus the flat
    shards), the gradient storage (the shards' reduced gradients, the
    shards' geometry) and the largest in-step exchange buffer (stage 1:
    the full gradient tree plus a bucket's panes; stage 2: a bucket's
    panes; stage 3: a bucket's gathered panes and its cotangent's)."""
    def nbytes(t):
        return t.numel() * t.element_size()

    n, params = opt._n, opt._params
    resident = (sum(p.untyped_storage().nbytes() for p in params)
                + sum(nbytes(s) for s in opt._shards))
    grads = sum(nbytes(s) for s in opt._shards)
    pane = max(sum(n * -(-params[i].numel() // n) * params[i].element_size()
                   for i in ids) for ids in opt._members)
    transient = {1: sum(nbytes(p) for p in params) + pane, 2: pane,
                 3: 2 * pane}[stage]
    return {"resident_params_bytes": resident, "grad_storage_bytes": grads,
            "transient_exchange_bytes": transient,
            "live_params_grads_bytes": resident + grads + transient}


ZERO_ARMS = (("z1", 1, {}), ("z2", 2, {}), ("z3", 3, {}),
             ("z2_int8", 2, {"wire": "int8", "error_feedback": True}))


def _zero_rank(rank, n, port, results):
    """One rank of phase 15 (b): its own process on the one card in a
    flat gloo world. Puts ``(rank, readings)`` on ``results``."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n))
    sys.path.insert(0, HERE)
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.ops import cuda_kernels as ck

    hvd.init(device="cuda")
    for k in ck.KERNELS:
        k.launches = 0
    _zero_flash()
    cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
    tokens, labels = _lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    per = TRAIN_BATCH // n
    mine = slice(rank * per, (rank + 1) * per)
    out = {"rank": rank, "arms": {}}
    for key, stage, kw in ZERO_ARMS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        model = Transformer(cfg, device="cuda", generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = _zero_opt(hvd, model, stage, hierarchical=False, **kw)
        b3 = ck.int8_block_quantize.launches
        arm = {"losses": [], "step_ms": [], "digests": [], "resident_gb": [],
               "peak_gb": []}
        for _ in range(ZERO_RANK_STEPS):
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            arm["resident_gb"].append(torch.cuda.memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            loss = _zero_step(opt, model, stage, tokens[mine], labels[mine])
            torch.cuda.synchronize()
            arm["step_ms"].append((time.monotonic() - t0) * 1e3)
            arm["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
            arm["losses"].append(float(loss.detach()))
            arm["digests"].append(_device_digest(
                _zero_params(opt, model, stage)))
        arm["live"] = _zero_live_bytes(opt, stage)
        arm["b3_launches"] = ck.int8_block_quantize.launches - b3
        if kw.get("error_feedback"):
            res = opt.state_dict()["wire"]
            arm["residual_norm"] = {k: float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(r) for r in
                             res[k].values()]))) for k in ("rs", "ag")}
        arm["buckets"] = list(opt.schedule.bucket_bytes)
        out["arms"][key] = arm
        opt.remove_hooks()
        del opt, model, gen, loss
        gc.collect()  # the model's reference cycles hold its tensors
        torch.cuda.empty_cache()
    out["launches"] = {k.__name__: k.launches for k in ck.KERNELS}
    out["flash"] = _read_flash()
    hvd.shutdown()
    dist.destroy_process_group()
    results.put((rank, out))


def _zero_world():
    """Phase 15 (b): :func:`_zero_rank` in 4 processes; every rank's
    readings in rank order, and the wall time."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    n = ZERO_WORLD
    procs = [ctx.Process(target=_zero_rank, args=(r, n, port, results),
                         daemon=True) for r in range(n)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    while len(got) < n:
        dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if dead or time.monotonic() - t0 > ZERO_TIMEOUT_S:
            for p in procs:
                p.kill()
            fail(f"zero world: ranks {dead} ended with "
                 f"{[procs[r].exitcode for r in dead]}" if dead else
                 f"zero world: not done in {ZERO_TIMEOUT_S} s")
        try:
            rank, out = results.get(timeout=5)
        except queue.Empty:
            continue
        got[rank] = out
    for p in procs:
        p.join(timeout=60)
        if p.exitcode != 0:
            p.kill()
            fail(f"zero world: a rank exited with {p.exitcode}")
    return [got[r] for r in range(n)], time.monotonic() - t0


def phase_zero(gen, card, phase5):
    """Phase 15: (a) GPT-2 medium at full width (phase 5's configuration,
    a world of one on NCCL) through ``ShardedDistributedOptimizer(AdamW,
    zero_stage=1, 2, 3)`` on the fp32 wire with 4 buckets, each beside
    ``DistributedOptimizer(AdamW)`` on the same state and 3 batches, in
    turns: the parameters bitwise equal after every step (a world of one
    reduces nothing), one reduce-scatter and one all-gather a bucket a
    step, the flash kernels on the tensor cores; each stage's host-clock
    step beside the plain optimizer's, and alone its bytes resident
    between steps and peak of a step. (b) :func:`_zero_world`'s arms
    and their checks. Returns the launches of B3 and of the flash
    kernels, the ranks' summed."""
    import dataclasses
    import gc

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig
    from horovod_tpu_torch.ops import overlap

    t_phase = time.monotonic()
    failed = []

    def release():
        gc.collect()  # the models' reference cycles hold their tensors
        torch.cuda.empty_cache()
    hvd.init()
    try:
        cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
        base = Transformer(cfg, device="cuda", generator=gen)
        init = {k: v.detach().clone() for k, v in base.state_dict().items()}
        del base
        batches = [_lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                             SEED + 20 + i) for i in range(ZERO_STEPS)]
        release()
        floor_gb = torch.cuda.memory_allocated() / 1e9
        overlap.reset_schedule_cache()
        _zero_flash()

        def alone(opt, model, stage, r):
            """The arm's own memory: resident between steps, and the
            peak of one more step, above the phase's floor."""
            opt.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            r["resident_gb"] = torch.cuda.memory_allocated() / 1e9 - floor_gb
            torch.cuda.reset_peak_memory_stats()
            _zero_step(opt, model, stage, *batches[0])
            torch.cuda.synchronize()
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 - floor_gb

        def fresh():
            model = Transformer(cfg, device="cuda")
            model.load_state_dict(init)
            return model

        plain_model = fresh()
        plain = _zero_opt(hvd, plain_model, 0)
        arms = {"plain": {}}
        for tokens, labels in batches[:2]:
            _zero_step(plain, plain_model, 0, tokens, labels)
        alone(plain, plain_model, 0, arms["plain"])
        plain.remove_hooks()
        del plain, plain_model
        release()
        for stage in (1, 2, 3):
            plain_model, zero_model = fresh(), fresh()
            plain = _zero_opt(hvd, plain_model, 0)
            zero = _zero_opt(hvd, zero_model, stage)
            r = {"step_ms": [], "plain_step_ms": [], "losses": [],
                 "plain_losses": [], "bitwise": [], "legs": []}
            for i, (tokens, labels) in enumerate(batches):
                order = (("zero", zero_model, zero, stage),
                         ("plain", plain_model, plain, 0))
                for name, model, opt, s in (order if i % 2 == 0
                                            else order[::-1]):
                    legs = overlap.leg_stats()
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    loss = _zero_step(opt, model, s, tokens, labels)
                    torch.cuda.synchronize()
                    ms = (time.monotonic() - t0) * 1e3
                    prefix = "" if name == "zero" else "plain_"
                    r[prefix + "step_ms"].append(ms)
                    r[prefix + "losses"].append(float(loss.detach()))
                    if name == "zero":
                        r["legs"].append({k: v - legs[k] for k, v in
                                          overlap.leg_stats().items()})
                r["bitwise"].append(all(torch.equal(a, b) for a, b in zip(
                    _zero_params(zero, zero_model, stage),
                    plain_model.parameters())))
            plain.remove_hooks()
            del plain, plain_model, loss, order, model, opt
            release()
            alone(zero, zero_model, stage, r)
            r["live"] = _zero_live_bytes(zero, stage)
            r["buckets"] = list(zero.schedule.bucket_bytes)
            nb = zero.schedule.n_buckets
            if not all(r["bitwise"]):
                failed.append(f"(a) stage {stage}: parameters differ from "
                              f"DistributedOptimizer's after steps "
                              f"{[i for i, b in enumerate(r['bitwise']) if not b]}")
            if any(lg != {"reduce_scatter": nb, "all_gather": nb}
                   for lg in r["legs"]):
                failed.append(f"(a) stage {stage}: legs a step {r['legs']}, "
                              f"{nb} buckets")
            zero.remove_hooks()
            del zero, zero_model
            release()
            arms[f"z{stage}"] = r
        flash = _read_flash()
        if not flash[0]["flash_fwd"] or any(
                flash[1][k] != flash[0][k] for k in flash[1]):
            failed.append(f"(a) flash launches {flash}")
        del init, batches
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    log("zero world of one: " + json.dumps({
        "model": "gpt2_medium", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "inner": f"AdamW(lr={ZERO_LR})", "buckets": ZERO_BUCKETS,
        "bucket_bytes": arms["z1"]["buckets"],
        "arms": {k: {kk: v for kk, v in r.items() if kk != "legs"}
                 for k, r in arms.items()},
        "legs_per_step": {k: arms[k]["legs"] for k in ("z1", "z2", "z3")},
        "phase5_step_ms_mean_after_first": phase5[
            "step_ms_mean_after_first"],
        "flash_launches": flash[0], "flash_tensor_core_launches": flash[1],
        "failed": failed, "s": time.monotonic() - t_phase, "card": card,
    }, sort_keys=True))

    # (b) the gloo world of 4
    outs, wall_s = _zero_world()
    steps = range(ZERO_RANK_STEPS)
    for key, _, _ in ZERO_ARMS:
        for s in steps:
            if len({o["arms"][key]["digests"][s] for o in outs}) != 1:
                failed.append(f"(b) {key} step {s}: the ranks' parameters "
                              "differ")
    for key in ("z2", "z3"):
        if any(o["arms"][key]["digests"] != o["arms"]["z1"]["digests"]
               for o in outs):
            failed.append(f"(b) {key}: parameters differ from stage 1's")
    mean_loss = {key: [sum(o["arms"][key]["losses"][s] for o in outs)
                       / len(outs) for s in steps] for key, _, _ in ZERO_ARMS}
    if not mean_loss["z2_int8"][-1] < mean_loss["z2_int8"][0]:
        failed.append(f"(b) int8: loss did not fall {mean_loss['z2_int8']}")
    if not all(math.isfinite(x) for v in mean_loss.values() for x in v):
        failed.append(f"(b) non-finite loss {mean_loss}")
    ratios = [o["arms"]["z1"]["live"]["live_params_grads_bytes"]
              / o["arms"]["z3"]["live"]["live_params_grads_bytes"]
              for o in outs]
    if min(ratios) < ZERO_GATE:
        failed.append(f"(b) stage 3's live bytes only {min(ratios):.3f}x "
                      f"below stage 1's (gate {ZERO_GATE})")
    peaks = {key: [max(o["arms"][key]["peak_gb"]) for o in outs]
             for key, _, _ in ZERO_ARMS}
    if not all(a < b for a, b in zip(peaks["z2"], peaks["z1"])):
        failed.append(f"(b) stage 2's peak not below stage 1's: {peaks}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in outs[0]["launches"]}
    b3 = sum(o["arms"]["z2_int8"]["b3_launches"] for o in outs)
    if b3 < 1:
        failed.append("(b) B3 never launched on the int8 arm")
    flash = ({k: flash[0][k] + sum(o["flash"][0][k] for o in outs)
              for k in flash[0]},
             {k: flash[1][k] + sum(o["flash"][1][k] for o in outs)
              for k in flash[1]})
    world = {key: {
        "mean_losses": mean_loss[key],
        "step_ms_by_rank": [o["arms"][key]["step_ms"] for o in outs],
        "resident_gb_by_rank": [o["arms"][key]["resident_gb"] for o in outs],
        "peak_gb_by_rank": [o["arms"][key]["peak_gb"] for o in outs],
        "live_bytes_rank0": outs[0]["arms"][key]["live"],
        "b3_launches": sum(o["arms"][key]["b3_launches"] for o in outs),
        **({"residual_norm_rank0": outs[0]["arms"][key]["residual_norm"]}
           if "residual_norm" in outs[0]["arms"][key] else {}),
    } for key, _, _ in ZERO_ARMS}
    log("zero gloo world: " + json.dumps({
        "world": ZERO_WORLD, "wall_s": wall_s,
        "live_ratio_z1_over_z3": ratios, "arms": world,
        "launches": {"int8_block_quantize": b3}, "flash_launches": flash[0],
        "flash_tensor_core_launches": flash[1],
        "phase_s": time.monotonic() - t_phase, "card": card,
    }, sort_keys=True))
    if failed:
        fail("zero: " + "; ".join(failed))
    launches["int8_block_quantize"] = b3
    return launches, flash


# ------------------------------------------------------ phase 16 local SGD

LOCAL_WORLD, LOCAL_INTRA, LOCAL_K = 4, 2, 2
LOCAL_STEPS = 4
LOCAL_LR = 0.01  # phase 13's SGD; ZeRO's arm takes phase 15's AdamW
LOCAL_ORACLE_ELEMS = 1 << 20
LOCAL_RTOL, LOCAL_ATOL = 1e-5, 1e-6  # tests/test_local_sgd.py's bound
LOCAL_INT8_QUANTA = 2.0  # one rounding on each sweep of the VHDD
LOCAL_TIMEOUT_S = 300
LOCAL_DRILL = "local_sgd.sync@1:reset;local_sgd.sync@2:reset"


def _local_chunk(sizes, part, pos, L, H, device):
    """Elements ``[pos·c, (pos + 1)·c)`` of the concatenation of the flat
    fp32 tensors ``part(i)`` (``sizes[i]`` elements each; zeros past the
    end), ``c`` a round's chunk, built a part at a time."""
    import torch

    m = sum(sizes)
    chunk = (m + (-m) % (L * (1 << (H.bit_length() - 1)))) // L
    lo, hi = min(pos * chunk, m), min((pos + 1) * chunk, m)
    out = torch.zeros(chunk, device=device)
    off = 0
    for i, k in enumerate(sizes):
        s, e = max(lo, off), min(hi, off + k)
        if s < e:
            out[s - lo:e - lo] = part(i)[s - off:e - off]
        off += k
    return out


def _local_prequant_input(opt, sharded, pos, L):
    """What a round of ``opt`` pre-quantizes on this rank, as
    ``local_sgd`` builds it: the intra-position chunk of the slice's delta
    plus the carried residual, fp32, with the round's seed and rounding
    stream."""
    import torch

    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.parallel import fsdp

    with torch.no_grad():
        if sharded:
            segs, res = [], []
            for p, a, r in zip(opt._params, opt._anchor, opt._local_res):
                if p.dim() == 0:
                    keep = 1.0 if pos == 0 else 0.0
                    segs.append((p - a).float().reshape(1) * keep)
                    res.append(r.float().reshape(1) * keep)
                else:
                    segs.append(fsdp.dyn_shard(p.detach(), L, pos).float()
                                - a.float())
                    res.append(r.float())
            x = torch.cat(segs) + torch.cat(res)
            return x, opt._round, (adasum._PREQUANT << 20) | opt._r
        ps, anchor = opt._params, opt._anchor
        sizes, H, dev = [p.numel() for p in ps], len(opt.local_stages[1][0]), \
            ps[0].device
        x = _local_chunk(sizes, lambda i: (ps[i].detach().reshape(-1) - anchor[
            i].reshape(-1).to(ps[i].dtype)).float(), pos, L, H, dev)
        x += _local_residual_chunk(opt, False, pos, L)
        return x, opt._updates, (adasum._PREQUANT << 20) | pos


def _local_residual_chunk(opt, sharded, pos, L):
    """This rank's chunk of the carry the round left."""
    import torch

    res = opt._local_res
    if sharded:
        return torch.cat([r.float().reshape(-1) for r in res])
    return _local_chunk([r.numel() for r in res],
                        lambda i: res[i].reshape(-1).float(), pos, L,
                        len(opt.local_stages[1][0]), res[0].device)


def _local_conservation(x, res, seed, stream):
    """Error feedback at the pre-quantization point: the carry against
    ``x − dequant(quant(x))`` recomputed with B3's plain version (bit for
    bit), and how many elements ``quantized + carry`` gives back exactly
    (the rest within the subtraction's rounding)."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    block = min(512, x.numel())
    q, s = ck.int8_block_quantize_plain(x, block, seed=seed, stream=stream)
    q_x = ck.int8_block_dequantize(q, s, block)
    del q, s
    bitwise = bool(torch.equal(res, x - q_x))
    back = q_x + res
    del q_x
    exact = float((back == x).float().mean())
    slack = float((torch.abs(back - x) - 0.5 * (_ulp(res) + _ulp(x))).max())
    return {"residual_bitwise": bitwise, "exact_fraction": exact,
            "within_rounding": slack <= 0, "elems": x.numel(),
            "residual_norm": float(res.norm())}


def _ulp(t):
    import torch

    return torch.nextafter(t.abs(), torch.full_like(t, float("inf"))) - \
        t.abs()


def _local_train(hvd, opt, model, tokens, labels, sharded, rank, L, stages,
                 checks, tag):
    """``LOCAL_STEPS`` steps of ``opt`` driven by ``local_sgd.maybe_sync``:
    each step's collectives recorded (every one inside the slice), each
    round's B3/B4 launches, the bytes handed to the inter group's calls,
    the pre-quantization check on rank 0, digests, losses, times and the
    allocator's readings."""
    import torch

    from horovod_tpu_torch import local_sgd
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.testing.recorder import record_collectives

    slice_ranks = set(next(g for g in stages[0] if rank in g))
    inter = tuple(next(g for g in stages[1] if rank in g))
    sync = opt.sync_round if sharded else opt.sync
    pos = rank % L
    base = registry.snapshot()
    r = {"losses": [], "step_ms": [], "round_ms": [], "digests": [],
         "synced": [], "calls_per_step": [], "round_launches": [],
         "inter_handed_bytes": [], "resident_gb": [], "peak_gb": [],
         "conservation": []}
    for step in range(LOCAL_STEPS):
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        r["resident_gb"].append(torch.cuda.memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        with record_collectives() as calls:
            loss = _loss(model, tokens, labels)
            loss.backward()
            opt.step()
        torch.cuda.synchronize()
        r["step_ms"].append((time.monotonic() - t0) * 1e3)
        r["losses"].append(float(loss.detach()))
        r["calls_per_step"].append(len(calls))
        checks[f"{tag}_step{step}_within_slice"] = bool(calls) and all(
            set(c.ranks) <= slice_ranks for c in calls)
        r["digests"].append(_device_digest(model.parameters()))
        opt.zero_grad(set_to_none=True)  # the round needs no gradients
        pre = None
        if local_sgd.due(step, LOCAL_K) and rank == 0:
            pre = _local_prequant_input(opt, sharded, pos, L)
        before = {k.__name__: k.launches for k in ck.KERNELS}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with record_collectives() as calls:
            _, synced = local_sgd.maybe_sync(
                sync, step=step, k=LOCAL_K,
                payload_bytes=opt.local_payload_bytes, stages=stages)
        torch.cuda.synchronize()
        r["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        r["synced"].append(synced)
        if synced:
            r["round_ms"].append((time.monotonic() - t0) * 1e3)
            r["round_launches"].append({
                k.__name__: k.launches - before[k.__name__]
                for k in ck.KERNELS if k.launches > before[k.__name__]})
            r["inter_handed_bytes"].append(sum(
                c.nbytes for c in calls if c.ranks == inter))
            r["digests"][-1] = _device_digest(model.parameters())
        if pre is not None:
            x, seed, stream = pre
            res = _local_residual_chunk(opt, sharded, pos, L)
            r["conservation"].append(_local_conservation(x, res, seed,
                                                         stream))
            del x, res, pre
    snap = registry.snapshot()
    r["counters"] = {k: snap.get(k, 0) - base.get(k, 0) for k in (
        "local_sgd.local_steps", "local_sgd.sync_rounds",
        "local_sgd.rounds_deferred", "local_sgd.inter_bytes")}
    r["round_inter_bytes"] = local_sgd.round_inter_bytes(
        opt.local_payload_bytes, stages)
    rounds = [s for s, ok in enumerate(r["synced"]) if ok]
    checks[f"{tag}_rounds_on_cadence"] = rounds == [
        s for s in range(LOCAL_STEPS) if local_sgd.due(s, LOCAL_K)]
    checks[f"{tag}_counters"] = (
        r["counters"]["local_sgd.local_steps"] == LOCAL_STEPS
        and r["counters"]["local_sgd.sync_rounds"] == len(rounds)
        and r["counters"]["local_sgd.inter_bytes"]
        == len(rounds) * r["round_inter_bytes"])
    checks[f"{tag}_b3_b4_in_every_round"] = all(
        rl.get("int8_block_quantize", 0) > 0 and rl.get("adasum_dots", 0) > 0
        and rl.get("adasum_apply", 0) > 0 for rl in r["round_launches"])
    if rank == 0:
        checks[f"{tag}_ef_residual_bitwise"] = all(
            c["residual_bitwise"] and c["within_rounding"]
            for c in r["conservation"])
    return r


def _local_oracle(rank, L, H):
    """(c): the grouped Adasum of one 1 M-element vector a slice (the
    same on the slice's ranks) on the fp32 and the int8 wire."""
    import torch

    from horovod_tpu_torch.common import topology
    from horovod_tpu_torch.ops import adasum

    stages = topology.hierarchical_stage_groups(L * H, L)
    vals = _rank_inputs(H, LOCAL_ORACLE_ELEMS, 900)
    mine = vals[rank // L]
    fp32 = adasum.adasum_allreduce_groups(mine, stages, "fp32")
    int8 = adasum.adasum_allreduce_groups(mine, stages, "int8", seed=17)
    want = adasum.adasum_vhdd_host([v.double().cpu().numpy() for v in vals])
    got = fp32.double().cpu().numpy()
    import numpy as np

    scale = float(np.abs(want).max())
    quantum = float(fp32.abs().max()) / 127
    return {"elems": LOCAL_ORACLE_ELEMS,
            "fp32_max_abs_err": float(np.abs(got - want).max()),
            "fp32_within": bool(np.all(np.abs(got - want)
                                       <= LOCAL_ATOL + LOCAL_RTOL
                                       * np.abs(want))),
            "fp32_rel_err": float(np.abs(got - want).max()) / scale,
            "int8_err_quanta": float((int8 - fp32).abs().max()) / quantum,
            "fp32_digest": _device_digest([fp32]),
            "int8_digest": _device_digest([int8])}


def _local_kernels_vs_plain(L, P):
    """B3 at a round's chunk (P/L fp32 values, block 512) and B4 at its
    halves, against their plain versions (B3 bit for bit, B4 within 1e-5
    of the largest magnitude)."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck

    x = _rank_inputs(1, -(-P // L), 61)[0]
    q, s = ck.int8_block_quantize(x, 512, seed=7, stream=9)
    qp, sp = ck.int8_block_quantize_plain(x, 512, seed=7, stream=9)
    b3 = bool(torch.equal(q, qp) and torch.equal(s, sp))
    del x, q, s, qp, sp
    a, b = _rank_inputs(2, -(-P // (2 * L)), 63)
    out = ck.adasum_apply(a, b, ck.adasum_dots(a, b))
    want = ck.adasum_apply_plain(a, b, ck.adasum_dots_plain(a, b))
    b4 = float((out - want).abs().max() / want.abs().max())
    return {"b3_elems": -(-P // L), "b3_bitwise": b3,
            "b4_elems": a.numel(), "b4_rel_err": b4}


def _local_rank(rank, n, port, results):
    """One rank of phase 16: its own process on the one card in a flat
    gloo world (the local split's groups are its own, made by the
    optimizers). Puts ``(rank, readings)`` on ``results``."""
    # four ranks share the card: segments that grow keep the allocator's
    # reserve near what each rank holds
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    sys.path.insert(0, HERE)
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import Transformer, TransformerConfig, local_sgd
    from horovod_tpu_torch.common.metrics import registry
    from horovod_tpu_torch.common.retry import RetryPolicy
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.testing import chaos

    hvd.init(device="cuda")
    L, H = LOCAL_INTRA, n // LOCAL_INTRA
    out = {"rank": rank}
    checks = {}
    for k in ck.KERNELS:
        k.launches = 0
    _zero_flash()

    # (c) the merge against the fp64 oracle
    out["oracle"] = _local_oracle(rank, L, H)
    checks["oracle_fp32_within_bound"] = out["oracle"]["fp32_within"]
    checks["oracle_int8_within_quanta"] = (
        out["oracle"]["int8_err_quanta"] <= LOCAL_INT8_QUANTA)

    cfg = dataclasses.replace(TransformerConfig.gpt2_medium(), remat=True)
    tokens, labels = _lm_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    per = TRAIN_BATCH // n
    mine = slice(rank * per, (rank + 1) * per)
    tokens, labels = tokens[mine], labels[mine]

    def model_of():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        model = Transformer(cfg, device="cuda", generator=gen)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        return model

    # (a) the replicated optimizer, then (d) the fault drill on it
    model = model_of()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LOCAL_LR, momentum=0.9),
        named_parameters=model.named_parameters(), op=hvd.Average,
        local_sgd_steps=LOCAL_K, local_sgd_intra=L,
        local_sgd_inter_wire="int8")
    stages = opt.local_stages
    P = sum(p.numel() for p in model.parameters())
    out["replicated"] = _local_train(hvd, opt, model, tokens, labels, False,
                                     rank, L, stages, checks, "a")
    base = registry.snapshot()
    opt.zero_grad(set_to_none=True)
    _loss(model, tokens, labels).backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    diverged = _device_digest(model.parameters())
    policy = RetryPolicy.from_env("local_sgd.sync", attempts=2,
                                  backoff_ms=1.0, circuit_threshold=0)
    if rank == 0:
        chaos.configure(LOCAL_DRILL)
    try:
        _, first = local_sgd.run_round(opt.sync, policy=policy)
        kept = _device_digest(model.parameters())
        _, second = local_sgd.run_round(opt.sync, policy=policy)
    finally:
        chaos.reset()
    snap = registry.snapshot()
    out["drill"] = {
        "first_synced": first, "second_synced": second,
        "deferred_left_params": kept == diverged,
        "diverged": diverged, "after": _device_digest(model.parameters()),
        "counters": {k: snap.get(k, 0) - base.get(k, 0) for k in (
            "local_sgd.rounds_deferred", "local_sgd.sync_rounds",
            "faults_injected", "retry.local_sgd.sync.attempts")}}
    c = out["drill"]["counters"]
    checks["drill_defers_then_completes"] = (
        not first and second and kept == diverged
        and c["local_sgd.rounds_deferred"] == 1
        and c["local_sgd.sync_rounds"] == 1
        and c["faults_injected"] == (2 if rank == 0 else 0))
    opt.remove_hooks()
    del opt, model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) ZeRO stage 2 in local mode
    model = model_of()
    opt = hvd.ShardedDistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=ZERO_LR),
        named_parameters=model.named_parameters(), op=hvd.Average,
        zero_stage=2, overlap_buckets=ZERO_BUCKETS, local_sgd_steps=LOCAL_K,
        local_sgd_intra=L, local_sgd_inter_wire="int8")
    out["zero"] = _local_train(hvd, opt, model, tokens, labels, True, rank,
                               L, stages, checks, "b")
    out["zero"]["anchor_gb"] = sum(
        a.numel() * a.element_size() for a in opt._anchor) / 1e9
    opt.remove_hooks()
    del opt, model
    gc.collect()
    torch.cuda.empty_cache()

    out["launches"] = {k.__name__: k.launches for k in ck.KERNELS}
    out["flash"] = _read_flash()
    if rank == 0:  # after the main path's counts are read
        out["kernels_vs_plain"] = _local_kernels_vs_plain(L, P)
    out["checks"] = checks
    hvd.shutdown()
    dist.destroy_process_group()
    results.put((rank, out))


def _local_world():
    """Phase 16's world: :func:`_local_rank` in 4 processes under a time
    limit (a hang fails the phase); every rank's readings in rank order,
    and the wall time."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    n = LOCAL_WORLD
    procs = [ctx.Process(target=_local_rank, args=(r, n, port, results),
                         daemon=True) for r in range(n)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    while len(got) < n:
        dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if dead or time.monotonic() - t0 > LOCAL_TIMEOUT_S:
            for p in procs:
                p.kill()
            fail(f"local world: ranks {dead} ended with "
                 f"{[procs[r].exitcode for r in dead]}" if dead else
                 f"local world: not done in {LOCAL_TIMEOUT_S} s")
        try:
            rank, out = results.get(timeout=5)
        except queue.Empty:
            continue
        got[rank] = out
    for p in procs:
        p.join(timeout=60)
        if p.exitcode != 0:
            p.kill()
            fail(f"local world: a rank exited with {p.exitcode}")
    return [got[r] for r in range(n)], time.monotonic() - t0


def phase_local(card):
    """Phase 16: local SGD in a gloo world of 4 processes on the one card,
    2 slices of 2 (``local_sgd_intra=2``), a quarter of phase 5's batch a
    rank, GPT-2 medium at full width (bf16 on fp32 masters, remat): (a)
    ``DistributedOptimizer(SGD momentum, op=Average, local_sgd_steps=2,
    local_sgd_inter_wire="int8")`` 4 steps through
    ``local_sgd.maybe_sync``; (b) ``ShardedDistributedOptimizer(AdamW,
    zero_stage=2, local_sgd_steps=2)`` the same; (c) one 1 M-element
    vector a slice through the grouped Adasum, fp32 against the fp64
    host oracle and int8 against fp32; (d) on (a)'s optimizer after one
    more local step, ``local_sgd.sync@1:reset;local_sgd.sync@2:reset``
    on rank 0 with 2 attempts: the round defers on every rank, leaving
    the parameters, and the next one completes. Checks: a slice's ranks
    bitwise equal and the slices apart after the local steps, all four
    equal after each round; every collective of a local step inside the
    slice (the recorder); B3 and B4 launched in every round; the
    counters; ``inter_bytes`` equal to ``round_inter_bytes`` beside the
    bytes handed to the inter group's calls; the carry bitwise the
    plain pre-quantization's remainder; the mean loss finite and
    falling. Returns the launches of the wire and flash kernels."""
    t_phase = time.monotonic()
    outs, wall_s = _local_world()
    failed = []
    for o in outs:
        bad = [k for k, ok in o["checks"].items() if not ok]
        if bad:
            failed.append(f"rank {o['rank']}: {bad}")
    n, L = LOCAL_WORLD, LOCAL_INTRA
    for key in ("fp32_digest", "int8_digest"):
        if len({o["oracle"][key] for o in outs}) != 1:
            failed.append(f"(c) the ranks' {key} differ")
    summary = {}
    for arm, tag in (("replicated", "a"), ("zero", "b")):
        rs = [o[arm] for o in outs]
        for s in range(LOCAL_STEPS):
            digests = [r["digests"][s] for r in rs]
            if rs[0]["synced"][s]:
                if len(set(digests)) != 1:
                    failed.append(f"({tag}) step {s}: ranks differ after "
                                  "the round")
            elif (len({digests[h * L + i] for h in range(n // L)
                       for i in range(L)}) != n // L
                  or any(len(set(digests[h * L:(h + 1) * L])) != 1
                         for h in range(n // L))):
                failed.append(f"({tag}) step {s}: a slice's replicas "
                              "differ or the slices agree")
        losses = [sum(r["losses"][s] for r in rs) / n
                  for s in range(LOCAL_STEPS)]
        if not all(math.isfinite(x) for x in losses) or not \
                losses[-1] < losses[0]:
            failed.append(f"({tag}) the mean loss did not fall: {losses}")
        summary[arm] = {
            "mean_losses": losses,
            "step_ms_by_rank": [r["step_ms"] for r in rs],
            "round_ms_by_rank": [r["round_ms"] for r in rs],
            "round_launches_rank0": rs[0]["round_launches"],
            "calls_per_step_rank0": rs[0]["calls_per_step"],
            "counters_rank0": rs[0]["counters"],
            "round_inter_bytes": rs[0]["round_inter_bytes"],
            "inter_handed_bytes_by_rank": [r["inter_handed_bytes"]
                                           for r in rs],
            "resident_gb_by_rank": [r["resident_gb"] for r in rs],
            "peak_gb_by_rank": [r["peak_gb"] for r in rs],
            "conservation_rank0": rs[0]["conservation"]}
    summary["zero"]["anchor_gb_rank0"] = outs[0]["zero"]["anchor_gb"]
    drills = [o["drill"] for o in outs]
    if len({d["after"] for d in drills}) != 1:
        failed.append("(d) the ranks differ after the completed round")
    kvp = outs[0]["kernels_vs_plain"]
    if not kvp["b3_bitwise"] or kvp["b4_rel_err"] > 1e-5:
        failed.append(f"kernels against plain {kvp}")
    launches = {name: sum(o["launches"][name] for o in outs)
                for name in outs[0]["launches"]}
    flash = ({k: sum(o["flash"][0][k] for o in outs)
              for k in outs[0]["flash"][0]},
             {k: sum(o["flash"][1][k] for o in outs)
              for k in outs[0]["flash"][1]})
    for name in ("int8_block_quantize", "adasum_dots", "adasum_apply"):
        if launches[name] < 1:
            failed.append(f"{name} never launched in the phase")
    log("local sgd: " + json.dumps({
        "world": n, "intra": L, "k": LOCAL_K, "steps": LOCAL_STEPS,
        "backend": "gloo, one card", "model": "gpt2_medium",
        "batch_per_rank": TRAIN_BATCH // n, "seq": TRAIN_SEQ,
        "wall_s": wall_s, "arms": summary,
        "oracle": {k: v for k, v in outs[0]["oracle"].items()
                   if "digest" not in k},
        "drill": {"plan_on_rank0": LOCAL_DRILL,
                  "by_rank": [{k: v for k, v in d.items()
                               if k not in ("diverged", "after")}
                              for d in drills]},
        "kernels_vs_plain": kvp, "launches": {
            k: launches[k] for k in ("int8_block_quantize", "adasum_dots",
                                     "adasum_apply")},
        "flash_launches": flash[0], "flash_tensor_core_launches": flash[1],
        "phase_s": time.monotonic() - t_phase, "card": card,
    }, sort_keys=True))
    if failed:
        fail("local sgd: " + "; ".join(failed))
    return launches, flash


# ------------------------------------------------ phase 17 model parallelism

MP_WORLD = 4
MP_STEPS = 3
MP_BATCH, MP_SEQ = 8, 1024
# GPT-2's vocabulary (50257 = 29 × 1733) padded to a multiple of 128 as
# Megatron-LM pads it: tp = 2 must split the vocab-parallel head
MP_VOCAB = 50304
MP_LR = 0.1  # examples/transformer_lm.py's SGD rate
MP_CROSS_LAYERS = 4
MP_CROSS_CAPACITY = 8.0  # no drops: routing independent of the layout
MP_TIMEOUT_S = 400


def _mp_cfg(**kw):
    import torch

    from horovod_tpu_torch.parallel.transformer import (
        ParallelTransformerConfig)

    base = dict(vocab_size=MP_VOCAB, num_layers=24, d_model=1024,
                num_heads=16, d_ff=4096, max_len=MP_SEQ, n_experts=4,
                learning_rate=MP_LR, dtype=torch.bfloat16)
    base.update(kw)
    return ParallelTransformerConfig(**base)


def _mp_predicted(cfg, mesh, schedule, n_micro):
    """Flash launches a step on this rank from the hop structure: a
    causal ring rank at sp index s runs s + 1 live hops (the diagonal and
    every earlier block), each one forward (B5) and one dQ and one dK/dV
    (B6), and the delta pass once a backward. 1F1B recomputes each
    stage's forward at its backward tick; GPipe runs n_micro + pp − 1
    ticks a stage."""
    live = mesh.coords["sp"] + 1
    layers = cfg.num_layers // mesh.size("pp")
    if schedule == "1f1b":
        calls = layers * n_micro
        return {"flash_fwd": 2 * calls * live, "flash_bwd_delta": calls,
                "flash_bwd_dq": calls * live, "flash_bwd_dkv": calls * live}
    calls = layers * (n_micro + mesh.size("pp") - 1)
    return {"flash_fwd": calls * live, "flash_bwd_delta": calls,
            "flash_bwd_dq": calls * live, "flash_bwd_dkv": calls * live}


def _mp_leaf_digests(params, specs):
    """(leaf path, the mesh axes it is sharded on, digest) of every
    leaf: the parent compares the ranks that hold the same block."""
    from torch.utils import _pytree as pytree

    from horovod_tpu_torch.parallel.transformer import _is_spec

    leaves = pytree.tree_flatten_with_path(params)[0]
    spec_leaves = pytree.tree_flatten(specs, is_leaf=_is_spec)[0]
    return [(pytree.keystr(path), tuple(a for a in spec if a), _digest(t))
            for (path, t), spec in zip(leaves, spec_leaves)]


def _mp_train(label, cfg, spec, steps, tokens, labels, gen_seed):
    """``steps`` SGD steps of the composed model on ``spec``'s mesh with
    the flash and B3 counters zeroed just before: losses, host-clock
    step times, launches, the peak memory and the leaves' digests."""
    import torch

    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.parallel import transformer as ptf

    mesh = spec.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(gen_seed)
    params = ptf.make_sharded_params(cfg, mesh, gen)
    step = ptf.make_train_step(cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash()
    ck.int8_block_quantize.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        params, loss = step(params, tokens, labels)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    flash = _read_flash()
    b3 = ck.int8_block_quantize.launches
    schedule = ("1f1b" if cfg.pipeline_schedule == "1f1b"
                and mesh.size("pp") > 1 else "gpipe")
    n_micro = ptf._pick_n_micro(MP_BATCH // (mesh.size("dp")
                                             * mesh.size("ep")),
                                cfg.n_microbatches)
    pred = _mp_predicted(cfg, mesh, schedule, n_micro)
    out = {
        "arm": label, "coords": dict(mesh.coords), "losses": losses,
        "step_ms": times, "flash": flash[0], "flash_tc": flash[1],
        "b3": b3, "predicted": {k: v * steps for k, v in pred.items()},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "stats": dict(step.stats), "n_micro": n_micro,
        "digests": _mp_leaf_digests(params, ptf.param_specs(cfg)),
    }
    if mesh.size("pp") > 1 and mesh.coords["pp"] == mesh.size("pp") - 1:
        out["b3_predicted"] = 2 * n_micro * steps  # dispatch + return
    elif mesh.size("pp") > 1:
        out["b3_predicted"] = 0
    return out


def _mp_cross(tokens, labels):
    """(c): one SGD step at full width, 4 layers, fp32, capacity 8.0, on
    dp 4 and three factorizations; every rank's shards against the dp-4
    step's, and the losses."""
    import torch

    from horovod_tpu_torch.parallel import MeshSpec
    from horovod_tpu_torch.parallel import transformer as ptf

    out = {}
    base = None
    for label, axes, over in (
            ("dp4", dict(dp=4), {}),
            ("sp2_tp2_flash", dict(sp=2, tp=2), dict(flash_ring=True)),
            ("pp2_ep2_1f1b", dict(pp=2, ep=2), {}),
            ("dp2_sp2_dense", dict(dp=2, sp=2), dict(flash_ring=False))):
        cfg = _mp_cfg(num_layers=MP_CROSS_LAYERS, dtype=torch.float32,
                      moe_capacity_factor=MP_CROSS_CAPACITY, **over)
        mesh = MeshSpec(**axes).build()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        params = ptf.make_sharded_params(cfg, mesh, gen)
        step = ptf.make_train_step(cfg, mesh)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, loss = step(params, tokens, labels)
        torch.cuda.synchronize()
        row = {"loss": float(loss), "ms": (time.monotonic() - t0) * 1e3}
        if base is None:
            base = (params, row["loss"])
        else:
            want = ptf.shard_params(base[0], cfg, mesh)
            worst, where = 0.0, None
            from torch.utils import _pytree as pytree

            for (path, a), b in zip(
                    pytree.tree_flatten_with_path(params)[0],
                    pytree.tree_leaves(want)):
                ratio = float(((a - b).abs() / (1e-5 + 5e-4 * b.abs()))
                              .max())
                if ratio > worst:
                    worst, where = ratio, pytree.keystr(path)
            row.update(worst_ratio=worst, worst_leaf=where,
                       loss_rel=abs(row["loss"] - base[1]) / abs(base[1]))
        out[label] = row
        del params
        torch.cuda.empty_cache()
    return out


class _PlainFlash:
    """The flash kernels' plain versions as one differentiable attention
    (the Ulysses inner attention's twin)."""

    @staticmethod
    def fn(q, k, v, causal):
        import torch

        from horovod_tpu_torch.ops import flash_attention as fa

        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v):
                o, lse = fa.flash_fwd_plain(q, k, v, causal)
                ctx.save_for_backward(q, k, v, o, lse)
                return o

            @staticmethod
            def backward(ctx, do):
                q, k, v, o, lse = ctx.saved_tensors
                return fa.flash_bwd_plain(q, k, v, o, lse, do.contiguous(),
                                          causal)

        return F.apply(q, k, v)


def _mp_within_roundings(label, got, ref):
    """Worst |kernel − plain| in bf16 roundings (phase 2's unit, floored
    at 2^-6), and whether it is within one."""
    import torch

    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{label}: non-finite output")
    diff = (got.float() - ref.float()).abs()
    tol = _ulp_bf16(torch.maximum(got.float().abs(), ref.float().abs()))
    return float((diff / tol).max()), bool((diff <= tol).all())


def _mp_site(label, q, k, v, do, causal, worst, checks, fwd=True, o=None,
             lse=None):
    """B5 and B6 at one call site against their plain versions on the
    same inputs (phase 2's check): the forward kernel when ``fwd``, the
    dQ and dK/dV kernels given ``o`` and ``lse`` (the plain forward's
    when None)."""
    from horovod_tpu_torch.ops import flash_attention as fa

    parts = []
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    if fwd:
        parts.append(("fwd", fa.flash_fwd(q, k, v, causal)[0], o_ref))
    o = o_ref if o is None else o
    lse = lse_ref if lse is None else lse
    delta = fa.flash_bwd_delta(o, do)
    got = ((fa.flash_bwd_dq(q, k, v, o, lse, do, causal, delta=delta),)
           + tuple(fa.flash_bwd_dkv(q, k, v, o, lse, do, causal,
                                    delta=delta)))
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do, causal)
    parts += list(zip(("dq", "dk", "dv"), got, ref))
    for part, a, b in parts:
        w, ok = _mp_within_roundings(f"{label} {part}", a, b)
        worst[f"{label} {part}"] = w
        checks[f"{label} {part} within one rounding"] = ok


def _mp_rel(a, b) -> float:
    """max |a − b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def _mp_kernels(rank, n):
    """(d): Ulysses over sp 4 and the GQA flash ring over sp 4, forward
    and backward through B5/B6. At each call site (Ulysses' inner
    attention on the exchanged heads; each live ring hop, its backward
    with the global o and lse) the kernels are held against their plain
    versions on the same inputs within one bf16 rounding; each whole
    function against its plain twin within 1e-2 of its largest value
    (the twin computes from its own rounded o and lse, so the difference
    compounds the forward's rounding through the backward). Then the
    two expert alltoalls on the fp32 wires bit for bit and the int8
    wire's contract."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.common import topology as topo_mod
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import traced
    from horovod_tpu_torch.parallel.mesh import world_axis
    from horovod_tpu_torch.parallel.ring_attention import (
        _flash_fwd_pass, _hops, ring_flash_attention,
        ring_flash_attention_plain)
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention

    worst, checks, rel = {}, {}, {}
    axis = world_axis()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 17)
    tl = MP_SEQ // n
    sl = slice(rank * tl, (rank + 1) * tl)
    seen = {}

    def inner(q, k, v, causal):
        seen["qkv"] = (q.detach(), k.detach(), v.detach())
        o = fa.FlashAttentionFunction.apply(q, k, v, None, causal, None)
        o.register_hook(lambda gr: seen.__setitem__(
            "do", gr.detach().contiguous()))
        return o

    for name, kvh, fn, twin in (
            ("ulysses", 16, lambda q, k, v: ulysses_attention(
                q, k, v, axis, causal=True, attn_fn=inner),
             lambda q, k, v: ulysses_attention(
                q, k, v, axis, causal=True, attn_fn=_PlainFlash.fn)),
            ("ring_gqa", 4, lambda q, k, v: ring_flash_attention(
                q, k, v, axis, causal=True),
             lambda q, k, v: ring_flash_attention_plain(
                q, k, v, axis, causal=True))):
        full = [torch.randn((MP_BATCH, MP_SEQ, h, 64), generator=g,
                            device="cuda").to(torch.bfloat16)
                for h in (16, kvh, kvh, 16)]
        res = []
        for f in (fn, twin):
            q, k, v = (x[:, sl].clone().requires_grad_() for x in full[:3])
            o = f(q, k, v)
            o.backward(full[3][:, sl])
            res.append([o.detach(), q.grad, k.grad, v.grad])
        for part, a, b in zip(("o", "dq", "dk", "dv"), *res):
            rel[f"{name} {part}"] = _mp_rel(a, b)
            checks[f"{name} {part} within 1e-2 of the twin"] = \
                rel[f"{name} {part}"] <= 1e-2
        if name == "ulysses":
            _mp_site("ulysses inner", *seen["qkv"], seen["do"], True,
                     worst, checks)
            continue
        q, k, v, do = (x[:, sl].contiguous() for x in full)
        o_g, lse_g = _flash_fwd_pass(q, k, v, axis, True, True)
        for i, src, diag, live in _hops(axis, True):
            if live:
                blk = slice(src * tl, (src + 1) * tl)
                _mp_site(f"ring hop {i}", q, full[1][:, blk].contiguous(),
                         full[2][:, blk].contiguous(), do, diag, worst,
                         checks, o=o_g, lse=lse_g)

    # the expert wires: [n, slots, d] dispatch buffers, integer-valued
    stages = topo_mod.hierarchy_stages(world=n, mode="on", intra=2)
    gi = torch.Generator(device="cuda")
    gi.manual_seed(SEED + rank)
    x = torch.randint(-8, 9, (n, 256, 1024), generator=gi,
                      device="cuda").float()
    flat = traced._all_to_all(x, dist.group.WORLD)
    hier = traced.hierarchical_alltoall(x, stages=stages)
    idx = torch.randint(-1, 4, (n, 256, 1), generator=gi, device="cuda",
                        dtype=torch.int32)
    checks["hier_fp32_bitwise_flat"] = torch.equal(hier, flat)
    checks["hier_int32_map_bitwise_flat"] = torch.equal(
        traced.hierarchical_alltoall(idx, stages=stages, inter_wire="int8"),
        traced._all_to_all(idx, dist.group.WORLD))
    xn = torch.randn((n, 256, 1024), generator=gi, device="cuda")
    xn[:, 200:] = 0.0  # pad slots
    fn_ = traced._all_to_all(xn, dist.group.WORLD)
    q8 = traced.quantized_alltoall(xn, seed=5, block_size=512)
    # one quantum: the sender's block absmax / 127, block by block
    absmax = traced._all_to_all(
        xn.reshape(n, 256, 2, 512).abs().amax(-1, keepdim=True),
        dist.group.WORLD)
    err = (q8 - fn_).reshape(n, 256, 2, 512).abs()
    checks["int8_pads_exact_zero"] = bool((q8[:, 200:] == 0).all())
    checks["int8_within_one_quantum"] = bool(
        (err <= absmax / 127.0 * (1 + 1e-6)).all())
    h8 = traced.hierarchical_alltoall(xn, stages=stages, inter_wire="int8",
                                      seed=5, block_size=512)
    node = rank // 2
    same = slice(node * 2, node * 2 + 2)
    checks["hier_int8_intra_blocks_exact"] = torch.equal(h8[same],
                                                         fn_[same])
    out = {"worst_roundings_at_call_sites": worst,
           "composite_rel_to_twin": rel,
           "int8_err_quanta": float((err / (absmax / 127.0).clamp_min(
               1e-30)).max())}
    return out, checks


def _mp_rank(rank, n, port, results):
    """One rank of phase 17: its own process on the one card in a gloo
    world of 4 that ``hvd.init`` adopts. Puts ``(rank, readings)``."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                      PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    sys.path.insert(0, HERE)
    import gc

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import MeshSpec

    hvd.init(device="cuda")
    tokens, labels = _lm_batch(MP_VOCAB, MP_BATCH, MP_SEQ)
    out = {"rank": rank}
    t0 = time.monotonic()
    out["a"] = _mp_train("a", _mp_cfg(flash_ring=True),
                            MeshSpec(sp=2, tp=2), MP_STEPS, tokens, labels,
                            SEED)
    out["a"]["arm_s"] = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out["b"] = _mp_train("b", _mp_cfg(pipeline_schedule="1f1b",
                                         n_microbatches=4, moe_wire="int8"),
                            MeshSpec(pp=2, ep=2), MP_STEPS, tokens, labels,
                            SEED)
    out["b"]["arm_s"] = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    _zero_flash()
    out["c"] = _mp_cross(tokens, labels)
    out["c_flash"] = _read_flash()
    out["c_s"] = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out["d"], out["d_checks"] = _mp_kernels(rank, n)
    out["d_s"] = time.monotonic() - t0
    hvd.shutdown()
    dist.destroy_process_group()
    results.put((rank, out))


def _mp_world():
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    n = MP_WORLD
    procs = [ctx.Process(target=_mp_rank, args=(r, n, port, results),
                         daemon=True) for r in range(n)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    while len(got) < n:
        dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if dead or time.monotonic() - t0 > MP_TIMEOUT_S:
            for p in procs:
                p.kill()
            fail(f"model parallel world: ranks {dead} ended with "
                 f"{[procs[r].exitcode for r in dead]}" if dead else
                 f"model parallel world: not done in {MP_TIMEOUT_S} s")
        try:
            rank, out = results.get(timeout=5)
        except queue.Empty:
            continue
        got[rank] = out
    for p in procs:
        p.join(timeout=60)
        if p.exitcode != 0:
            p.kill()
            fail(f"model parallel world: a rank exited with {p.exitcode}")
    return [got[r] for r in range(n)], time.monotonic() - t0


def _mp_replicas_equal(arm_outs):
    """Every leaf's block bitwise equal on the ranks that hold it (the
    ranks that agree on the leaf's sharded axes)."""
    bad = []
    for i, (path, axes, _) in enumerate(arm_outs[0]["digests"]):
        blocks = {}
        for o in arm_outs:
            key = tuple(o["coords"][a] for a in axes)
            blocks.setdefault(key, set()).add(o["digests"][i][2])
        if any(len(d) != 1 for d in blocks.values()):
            bad.append(path)
    return bad


def phase_model_parallel(card):
    """Phase 17: the composed transformer (``parallel/transformer.py``)
    in a gloo world of 4 processes on the one card, at GPT-2 medium's
    widths with the vocabulary padded to 50304, weights from the seed,
    tokens on the learnable sequence, 8 sequences of 1024 tokens: (a)
    sp 2 × tp 2 on the flash ring, bf16 on fp32 masters, 3 steps; (b) pp
    2 × ep 2 on 1F1B with 4 microbatches and the int8 expert wire, 3
    steps; (c) one fp32 step at 4 layers (capacity 8.0) on dp 4, sp 2 ×
    tp 2 (flash ring), pp 2 × ep 2 (1F1B) and dp 2 × sp 2 (dense ring),
    each against dp 4's parameters (rtol 5e-4, atol 1e-5) and loss (rtol
    1e-5); (d) Ulysses and the GQA flash ring over sp 4 through B5/B6
    against their plain twins, and the expert alltoalls. Returns the
    launches of (a)–(c)."""
    t_phase = time.monotonic()
    outs, wall_s = _mp_world()
    failed = []
    summary = {}
    for arm in ("a", "b"):
        rs = [o[arm] for o in outs]
        losses = [sum(r["losses"][s] for r in rs) / len(rs)
                  for s in range(MP_STEPS)]
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            failed.append(f"({arm}) the mean loss did not fall: {losses}")
        for r in rs:
            for k, want in r["predicted"].items():
                if r["flash"][k] != want:
                    failed.append(f"({arm}) rank at {r['coords']}: {k} "
                                  f"{r['flash'][k]} != predicted {want}")
            for k, v in r["flash_tc"].items():
                if v != r["flash"][k]:
                    failed.append(f"({arm}) {k}: {v} of {r['flash'][k]} "
                                  "launches on the tensor cores")
            if "b3_predicted" in r and r["b3"] != r["b3_predicted"]:
                failed.append(f"({arm}) B3 {r['b3']} != predicted "
                              f"{r['b3_predicted']} at {r['coords']}")
        bad = _mp_replicas_equal(rs)
        if bad:
            failed.append(f"({arm}) replicated leaves differ: {bad[:4]}")
        if arm == "b":
            for r in rs:
                st = r["stats"]
                if not 1 <= st["stash_peak"] <= st["max_in_flight"] + 1:
                    failed.append(f"(b) stash {st}")
            if sum(r["b3"] for r in rs) < 1:
                failed.append("(b) B3 never launched")
        summary[arm] = {
            "mean_losses": losses,
            "step_ms_by_rank": [r["step_ms"] for r in rs],
            "peak_gb_by_rank": [r["peak_gb"] for r in rs],
            "flash_by_rank": [r["flash"] for r in rs],
            "b3_by_rank": [r["b3"] for r in rs],
            "stats_rank0": rs[0]["stats"], "n_micro": rs[0]["n_micro"],
            "arm_s_by_rank": [r["arm_s"] for r in rs]}
    for r, o in enumerate(outs):
        for label, row in o["c"].items():
            if "worst_ratio" in row and (row["worst_ratio"] > 1.0
                                         or row["loss_rel"] > 1e-5):
                failed.append(f"(c) rank {r} {label}: {row}")
        bad = [k for k, ok in o["d_checks"].items() if not ok]
        if bad:
            failed.append(f"(d) rank {r}: {bad} {o['d']}")
    launches = {k: sum(o[arm]["flash"][k] for o in outs for arm in "ab")
                + sum(o["c_flash"][0][k] for o in outs)
                for k in outs[0]["a"]["flash"]}
    tc = {k: sum(o[arm]["flash_tc"][k] for o in outs for arm in "ab")
          + sum(o["c_flash"][1][k] for o in outs)
          for k in outs[0]["a"]["flash_tc"]}
    b3 = sum(o["b"]["b3"] for o in outs) + sum(o["a"]["b3"] for o in outs)
    log("model parallel: " + json.dumps({
        "world": MP_WORLD, "backend": "gloo, one card",
        "widths": "gpt2_medium, vocab 50304 (50257 padded to 128s)",
        "batch": MP_BATCH, "seq": MP_SEQ, "steps": MP_STEPS,
        "wall_s": wall_s, "arms": summary,
        "cross_mesh_by_rank": [o["c"] for o in outs],
        "cross_s_by_rank": [o["c_s"] for o in outs],
        "kernels_by_rank": [o["d"] for o in outs],
        "d_s_by_rank": [o["d_s"] for o in outs],
        "launches": launches, "tensor_core_launches": tc, "b3": b3,
        "phase_s": time.monotonic() - t_phase, "card": card,
    }, sort_keys=True))
    if failed:
        fail("model parallel: " + "; ".join(failed))
    return b3, (launches, tc)


# ------------------------------------------------------------------ main


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["17"],
                    help="build the kernels and run this phase alone")
    ap.add_argument("--log", help="also write every printed line here")
    args = ap.parse_args()
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
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)),
                    exist_ok=True)
        open(args.log, "w").close()
        _keep["file"] = args.log

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

    if args.only == "17":
        t0 = time.monotonic()
        phase_model_parallel(card)
        log(f"model parallel phase: {time.monotonic() - t0:.2f} s")
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.monotonic()
    kernel_results = phase_kernels(gen)
    flash_results = phase_flash_kernels(gen)
    log(f"kernel phase: {time.monotonic() - t0:.2f} s")

    # phase 3: GPT-2 medium at full width, random weights from the seed;
    # the fp32 copy for phase 4 is taken first (serving the bf16 model
    # stores its matmul weights in bf16)
    import dataclasses

    from horovod_tpu_torch import Transformer, TransformerConfig

    cfg = TransformerConfig.gpt2_medium()
    model = Transformer(cfg, device="cuda", generator=gen)
    model32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                          device="cuda")
    model32.load_state_dict(model.state_dict())
    prompts, prompt = serve_prompts(cfg.vocab_size)
    t0 = time.monotonic()
    paged_launches = phase_serve(model, prompts, 32, card)
    log(f"serve phase: {time.monotonic() - t0:.2f} s")

    # phase 4: correctness at full width in fp32
    t0 = time.monotonic()
    phase_fp32(model32, [prompt(24), prompt(300)], 32)
    log(f"fp32 phase: {time.monotonic() - t0:.2f} s")
    del model, model32
    torch.cuda.empty_cache()

    # phase 5: training, the second slice's main path
    t0 = time.monotonic()
    (train_launches, train_tc_launches, fused_bytes_per_step,
     train_peak_gb, train_readings) = phase_train(gen, card)
    log(f"train phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 6: the kernels inside the whole backward, fp32 at full width
    t0 = time.monotonic()
    phase_train_fp32(gen)
    log(f"fp32 train phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 7: the wire kernels against their plain versions
    t0 = time.monotonic()
    wire_rows = phase_wire_kernels(gen)
    log(f"wire kernel phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 8: training on the int8 wire with error feedback
    t0 = time.monotonic()
    wire_launches = {"int8_block_quantize": phase_train_int8(
        gen, card, fused_bytes_per_step)}
    log(f"int8 train phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 9: Adasum's tree and the per-tensor codec at full width
    t0 = time.monotonic()
    wire_launches.update(phase_adasum(gen, card))
    log(f"adasum phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 10: ViT-B/16 through the flash kernels, bidirectional and
    # padded; its launches join phase 5's in the kernels line
    t0 = time.monotonic()
    flash_runs = [(train_launches, train_tc_launches), phase_vit(card)]
    log(f"vit phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 11: ResNet-50 with SyncBatchNorm, then MNIST, VGG-16 and
    # Inception V3 one step each
    t0 = time.monotonic()
    phase_cnn(card)
    log(f"cnn phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 12: GPT-2 medium with the fused LM loss, flush() and the guard
    t0 = time.monotonic()
    flash_runs.append(phase_fused_xent(card, train_peak_gb))
    log(f"fused xent phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 13: the two-level route in a gloo world of 4 on the card
    t0 = time.monotonic()
    hier_launches, hier_flash = phase_hier(card, fused_bytes_per_step)
    flash_runs.append(hier_flash)
    for name in ("int8_block_quantize", "adasum_dots", "adasum_apply"):
        wire_launches[name] += hier_launches[name]
    log(f"hier phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 14: the bucketed overlap, the boundary, the compiled exchange
    # and the in-step collectives in a gloo world of 4
    t0 = time.monotonic()
    overlap_launches, overlap_flash = phase_overlap(gen, card,
                                                    train_readings)
    flash_runs.append(overlap_flash)
    for name in ("int8_quantize", "int8_block_quantize"):
        wire_launches[name] += overlap_launches[name]
    log(f"overlap phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 15: ZeRO stages 1-3 in the world of one and a gloo world of 4
    t0 = time.monotonic()
    zero_launches, zero_flash = phase_zero(gen, card, train_readings)
    flash_runs.append(zero_flash)
    wire_launches["int8_block_quantize"] += zero_launches[
        "int8_block_quantize"]
    log(f"zero phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 16: local SGD in a gloo world of 4, 2 slices of 2
    t0 = time.monotonic()
    local_launches, local_flash = phase_local(card)
    flash_runs.append(local_flash)
    for name in ("int8_block_quantize", "adasum_dots", "adasum_apply"):
        wire_launches[name] += local_launches[name]
    log(f"local sgd phase: {time.monotonic() - t0:.2f} s")
    torch.cuda.empty_cache()

    # phase 17: the composed model-parallel transformer in a gloo world
    # of 4 on the card
    t0 = time.monotonic()
    mp_b3, mp_flash = phase_model_parallel(card)
    flash_runs.append(mp_flash)
    wire_launches["int8_block_quantize"] += mp_b3
    log(f"model parallel phase: {time.monotonic() - t0:.2f} s")
    flash_launches = {k: sum(r[0][k] for r in flash_runs)
                      for k in flash_runs[1][0]}
    flash_tc_launches = {k: sum(r[1][k] for r in flash_runs)
                         for k in flash_runs[1][1]}

    # paged attention: the decode kernel (main shape: the decode step;
    # its entry keeps the name it had before the tiled kernel was
    # listed apart) and the tiled kernel (main shape: the serving path's
    # 256-row prefill chunk, on the tensor cores; its rows include the
    # CUDA-core variant, fp32 and bf16), each with its own launches
    entries = []
    for kernel, main_name, variants in (
            ("paged_attention", "decode", ("decode",)),
            ("paged_attention tiled", "prefill256",
             ("tensor_cores", "cuda_cores"))):
        rows = [r for r in kernel_results if r["variant"] in variants]
        main_shape = next(r for r in rows if r["name"] == main_name)
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "horovod_tpu/ops/paged_attention.py:308",
            "launches": (paged_launches["decode"] if main_name == "decode"
                         else paged_launches["tiled"]),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "variant": main_shape["variant"],
            "shape": main_shape["shape"],
            "shapes": rows,
        })
        if main_name != "decode":
            entries[-1]["tensor_core_launches"] = paged_launches[
                "tiled_tensor_cores"]
    for kind, fn, line in (("fwd", "flash_fwd", 513),
                           ("delta", "flash_bwd_delta", 621),
                           ("dq", "flash_bwd_dq", 621),
                           ("dkv", "flash_bwd_dkv", 633)):
        rows = flash_results[kind]
        main_shape = rows[0]  # GPT-2 medium training, t 512
        entries.append({
            "name": fn,
            "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"horovod_tpu/ops/flash_attention.py:{line}",
            "launches": flash_launches[fn],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": main_shape["shape"],
            "shapes": rows,
        })
        if fn in train_tc_launches:  # the kernels with two variants
            entries[-1]["variant"] = main_shape["variant"]
            entries[-1]["tensor_core_launches"] = flash_tc_launches[fn]
    for fn, line in (("scale_cast", 84), ("int8_quantize", 133),
                     ("int8_block_quantize", 221), ("adasum_dots", 304),
                     ("adasum_apply", 315)):
        rows = wire_rows[fn]
        main_shape = next(r for r in rows if r["name"] == WIRE_MAIN[fn])
        entries.append({
            "name": (fn if not fn.startswith("adasum")
                     else f"adasum_pair {fn.split('_')[1]}"),
            "route": "cuda",
            "source": "horovod_tpu_torch/ops/csrc/cuda_kernels.cu",
            "replaces": f"horovod_tpu/ops/pallas_kernels.py:{line}",
            "launches": wire_launches[fn],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": main_shape["shape"],
            "shapes": rows,
        })
        if "variant" in main_shape:  # B3
            entries[-1]["variant"] = main_shape["variant"]
    log(json.dumps({"kernels": entries}))
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
