#!/usr/bin/env python3
"""The flash backward's two kernel variants against each other, in turns,
in one process on one card.

The dispatch rule sends bf16 at head_dim 64 or 128 to the tensor-core
kernels (``hvd_flash_bwd_dq_tc``, ``hvd_flash_bwd_dkv_tc``); the CUDA-core
kernels (``hvd_flash_bwd_dq``, ``hvd_flash_bwd_dkv``) take every other
case but run bf16 all the same. This script launches both on the same
bf16 inputs, given the same delta, at ``chip_smoke.py``'s training shapes,
and times each by CUDA events over graph-replayed launches in the order
CUDA cores, tensor cores, tensor cores, CUDA cores (the lower of each
pair). Beside them: the delta pass, the whole backward as
``FlashAttentionFunction`` runs it (delta, dQ, dK/dV), and
``scaled_dot_product_attention``'s backward on the same inputs (timed
only; forward and backward replayed together, less the forward). Both
variants are held to the plain version within one bf16 rounding first.

With ``--train`` it runs ``chip_smoke.py``'s phase 5 instead (GPT-2
medium's training steps, their peak memory and one profiled step), and
``--root DIR`` takes ``chip_smoke.py`` and the package from another
checkout: run it on an unpacked parent commit and on this one in turns
to compare the two in one call.

Run from the repository root on a machine with a CUDA card:
``python3 scripts/compare_flash_bwd.py [--train] [--root DIR]``. It
prints one JSON line per shape (phase 5's own lines with ``--train``)
and, as its last line, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SHAPES = ("gpt2-t512", "gpt2-t1024", "gqa-t1024")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="run chip_smoke.py's phase 5 instead")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import from")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from horovod_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a "
                "CUDA device")
    card = cs.card_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    if args.train:
        cs.phase_train(gen, card)
        print(card)
        return 0
    for case in cs.FLASH_CASES:
        name, b, t, h, kvh, d, causal, lengths, window = case
        if name not in SHAPES:
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
        row = {"name": name, "card": card}
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
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
