"""The LM head's product, and the chunked fused linear cross-entropy.

The counterpart of ``horovod_tpu/ops/fused_xent.py``. At GPT-2's
vocabulary the logits are the step's largest activation: ``(batch·seq,
vocab)`` fp32 is ≈ 823 MB at 8 × 512 tokens and V = 50257, written in
the forward and read by the softmax, and the same again for their
gradient. :func:`fused_linear_cross_entropy` never makes either:

* the forward walks the vocabulary in chunks (``_chunk_starts``), keeps
  an online logsumexp (running maximum and rescaled sum) and gathers
  each token's target logit; only ``(N,)`` statistics survive it;
* the backward (:class:`FusedLinearCrossEntropy`, the reference's
  custom VJP) recomputes each chunk's logits, forms ``softmax − onehot``
  there, accumulates dx and writes the chunk's slices of dW and db.

The cost is one more ``N × d × chunk`` product a chunk in the backward.

Both this loss and the Transformer's ``LMHead`` (:func:`mixed_linear`,
the operator ``hvd_torch::mixed_linear``) multiply through
:func:`mixed_mm`: ``compute_dtype`` operands (bf16 by default) with an
fp32 result, the reference's ``preferred_element_type=f32``. On CUDA
that is one tensor-core product, ``torch.mm(a, b, out_dtype=float32)``;
on the CPU, whose PyTorch has no kernel for that overload, the fp32
product of the rounded operands (a product of two bf16 values is exact
in fp32, so only the order of the fp32 sums differs). ``compute_dtype``
None is fp32 throughout. The backward products round the fp32
cotangent to ``compute_dtype`` first, as the reference's backward
rounds ``dlogits``. These are library matrix products: the JAX package
computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def mixed_mm(a: torch.Tensor, b: torch.Tensor,
             dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``a @ b`` (2-D) with ``dtype`` operands and an fp32 result; fp32
    throughout when ``dtype`` is None or fp32."""
    if dtype is None or dtype == torch.float32:
        return a.float() @ b.float()
    a, b = a.to(dtype), b.to(dtype)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _operands(x, kernel, dtype):
    """The LM head's product operands: ``x`` as 2-D rows and both in
    ``dtype`` (None: as they are)."""
    x2 = x.reshape(-1, x.shape[-1])
    if dtype is None:
        return x2, kernel
    return x2.to(dtype), kernel.to(dtype)


@torch.library.custom_op("hvd_torch::mixed_linear", mutates_args=())
def _mixed_linear_op(x: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor,
                     dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ kernel + bias`` through :func:`mixed_mm`: fp32 out, the
    fp32 bias added."""
    xr, kr = _operands(x, kernel, dtype)
    y = mixed_mm(xr, kr, dtype) + bias.float()
    return y.reshape(*x.shape[:-1], kernel.shape[1])


@_mixed_linear_op.register_fake
def _(x, kernel, bias, dtype):
    return x.new_empty((*x.shape[:-1], kernel.shape[1]),
                       dtype=torch.float32)


def _mixed_linear_setup(ctx, inputs, output):
    x, kernel, bias, dtype = inputs
    ctx.save_for_backward(x, kernel)
    ctx.dtype = dtype
    ctx.bias_dtype = bias.dtype


def _mixed_linear_backward(ctx, g):
    """The backward's products take ``dtype`` operands too (the
    cotangent rounded once); the operands are rounded again from the
    saved inputs, the same values the forward used."""
    x, kernel = ctx.saved_tensors
    xr, kr = _operands(x, kernel, ctx.dtype)
    g2 = g.reshape(-1, g.shape[-1])
    gr = g2 if ctx.dtype is None else g2.to(ctx.dtype)
    dx = dk = db = None
    if ctx.needs_input_grad[0]:
        dx = mixed_mm(gr, kr.t(), ctx.dtype).to(x.dtype).reshape(x.shape)
    if ctx.needs_input_grad[1]:
        dk = mixed_mm(xr.t(), gr, ctx.dtype).to(kernel.dtype)
    if ctx.needs_input_grad[2]:
        db = g2.float().sum(0).to(ctx.bias_dtype)
    return dx, dk, db, None


torch.library.register_autograd("hvd_torch::mixed_linear",
                                _mixed_linear_backward,
                                setup_context=_mixed_linear_setup)


def mixed_linear(x, kernel, bias, dtype: Optional[torch.dtype]):
    """The LM head: ``x [..., d] @ kernel [d, V] + bias`` in fp32, the
    product with ``dtype`` operands (None: fp32). It is the operator
    ``hvd_torch::mixed_linear``, so a compiled step sees one node (and
    AOTAutograd's cache can key it), as it sees B1-B7."""
    return torch.ops.hvd_torch.mixed_linear(x, kernel, bias, dtype)


def _chunk_starts(vocab: int, chunk: int) -> List[Tuple[int, int]]:
    """(start, width) pairs covering [0, vocab): full chunks and one
    tail, no padding, no overlap."""
    chunk = max(1, min(int(chunk), vocab))
    starts = [(s, chunk) for s in range(0, vocab - chunk + 1, chunk)]
    done = starts[-1][0] + chunk if starts else 0
    if done < vocab:
        starts.append((done, vocab - done))
    return starts


def _partial_logits(xr, kr, bias, start: int, width: int, dtype):
    """fp32 logits of vocabulary columns [start, start + width)."""
    return (mixed_mm(xr, kr[:, start:start + width], dtype)
            + bias[start:start + width].float())


class FusedLinearCrossEntropy(torch.autograd.Function):
    """Per-token cross-entropy of ``x @ kernel + bias`` against
    ``labels``, chunked over the vocabulary in both directions."""

    @staticmethod
    def forward(ctx, x, kernel, bias, labels, chunk, dtype):
        n, vocab = x.shape[0], kernel.shape[1]
        xr = x if dtype is None else x.to(dtype)
        kr = kernel if dtype is None else kernel.to(dtype)
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros(n, device=x.device)
        target = torch.zeros(n, device=x.device)
        for start, width in _chunk_starts(vocab, chunk):
            logits = _partial_logits(xr, kr, bias, start, width, dtype)
            new_m = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - new_m) + torch.exp(
                logits - new_m[:, None]).sum(-1)
            m = new_m
            target += _gather(logits, labels, start, width)
        lse = m + torch.log(s)
        ctx.save_for_backward(xr, kr, bias, labels, lse)
        ctx.chunk, ctx.dtype = chunk, dtype
        ctx.dtypes = (x.dtype, kernel.dtype, bias.dtype)
        return lse - target

    @staticmethod
    def backward(ctx, g):
        xr, kr, bias, labels, lse = ctx.saved_tensors
        x_dt, k_dt, b_dt = ctx.dtypes
        dtype = ctx.dtype
        n, vocab = xr.shape[0], kr.shape[1]
        g = g.float()
        rows = torch.arange(n, device=xr.device)
        dx = torch.zeros(xr.shape, dtype=torch.float32, device=xr.device)
        dw = torch.empty(kr.shape, dtype=k_dt, device=xr.device)
        db = torch.empty(vocab, dtype=b_dt, device=xr.device)
        for start, width in _chunk_starts(vocab, ctx.chunk):
            logits = _partial_logits(xr, kr, bias, start, width, dtype)
            dlogits = torch.exp(logits - lse[:, None]) * g[:, None]
            local = labels - start
            hit = (local >= 0) & (local < width)
            idx = local.clamp(0, width - 1)
            dlogits[rows, idx] -= torch.where(hit, g, 0.0)
            dl = dlogits if dtype is None else dlogits.to(dtype)
            k = kr[:, start:start + width]
            dx += mixed_mm(dl, k.t(), dtype)
            dw[:, start:start + width] = mixed_mm(xr.t(), dl, dtype)
            db[start:start + width] = dlogits.sum(0)
        return dx.to(x_dt), dw, db, None, None, None


def _gather(logits, labels, start: int, width: int) -> torch.Tensor:
    """Each row's logit at its label where the label lies in this chunk,
    else 0."""
    local = labels - start
    hit = (local >= 0) & (local < width)
    got = logits.gather(1, local.clamp(0, width - 1)[:, None])[:, 0]
    return torch.where(hit, got, 0.0)


def fused_linear_cross_entropy(x, kernel, bias, labels, *, chunk: int = 8192,
                               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-token softmax cross-entropy of ``x @ kernel + bias`` against
    integer ``labels``, without the ``(N, V)`` logits.

    ``x`` is ``(N, d_model)`` in any float dtype (dx comes back in it),
    ``kernel`` ``(d_model, V)``, ``bias`` ``(V,)``, ``labels`` ``(N,)``
    integers in ``[0, V)``. ``chunk`` is the vocabulary chunk's width;
    ``compute_dtype`` the products' operand dtype (None: fp32). Returns
    the ``(N,)`` fp32 losses; mean them for the usual objective."""
    if x.dim() != 2:
        raise ValueError(f"x must be (tokens, d_model); got {tuple(x.shape)}")
    if tuple(labels.shape) != tuple(x.shape[:1]):
        raise ValueError(f"labels shape {tuple(labels.shape)} != tokens "
                         f"axis {tuple(x.shape[:1])}")
    return FusedLinearCrossEntropy.apply(x, kernel, bias, labels.long(),
                                         int(chunk), compute_dtype)
