"""The LM head's product as the custom operator ``hvd_torch::mixed_linear``
(``horovod_tpu_torch/ops/fused_xent.py``), held bit for bit to the
autograd Function it replaces (kept here as the oracle, as it was):
eager outputs and gradients in bf16 and fp32 operands, 2-D and 3-D
inputs, only some inputs needing a gradient; ``torch.library.opcheck``;
and a compiled training step of a small Transformer (``aot_eager``, a
single graph) whose loss and gradients equal eager's bitwise."""

import dataclasses

import pytest
import torch

from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import fused_xent as fx


class _FunctionHead(torch.autograd.Function):
    """The LM head as the autograd Function the operator replaced."""

    @staticmethod
    def forward(ctx, x, kernel, bias, dtype):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        xr = x2 if dtype is None else x2.to(dtype)
        kr = kernel if dtype is None else kernel.to(dtype)
        ctx.save_for_backward(xr, kr)
        ctx.dtype = dtype
        ctx.dtypes = (x.dtype, kernel.dtype, bias.dtype)
        ctx.lead = lead
        y = fx.mixed_mm(xr, kr, dtype) + bias.float()
        return y.reshape(*lead, kernel.shape[1])

    @staticmethod
    def backward(ctx, g):
        xr, kr = ctx.saved_tensors
        x_dt, k_dt, b_dt = ctx.dtypes
        g2 = g.reshape(-1, g.shape[-1])
        gr = g2 if ctx.dtype is None else g2.to(ctx.dtype)
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = fx.mixed_mm(gr, kr.t(), ctx.dtype).to(x_dt)
            dx = dx.reshape(*ctx.lead, kr.shape[0])
        if ctx.needs_input_grad[1]:
            dk = fx.mixed_mm(xr.t(), gr, ctx.dtype).to(k_dt)
        if ctx.needs_input_grad[2]:
            db = g2.float().sum(0).to(b_dt)
        return dx, dk, db, None


def _inputs(shape, seed, need=(True, True, True)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, 24, generator=g)
    k = torch.randn(24, 40, generator=g) * 0.2
    b = torch.randn(40, generator=g)
    return [t.clone().requires_grad_(n) for t, n in zip((x, k, b), need)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, None],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(6,), (2, 5)], ids=["2d", "3d"])
@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, True)],
                         ids=["all", "x", "weights"])
def test_operator_bitwise_the_function(dtype, shape, need):
    want_in = _inputs(shape, 0, need)
    got_in = _inputs(shape, 0, need)
    want = _FunctionHead.apply(*want_in, dtype)
    got = fx.mixed_linear(*got_in, dtype)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    want.backward(g)
    got.backward(g)
    for a, b in zip(want_in, got_in):
        assert (a.grad is None) == (b.grad is None)
        if a.grad is not None:
            assert a.grad.dtype == b.grad.dtype
            assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, None],
                         ids=["bf16", "fp32"])
def test_opcheck(dtype):
    torch.library.opcheck(torch.ops.hvd_torch.mixed_linear.default,
                          (*_inputs((2, 3), 2), dtype))


def test_compiled_step_bitwise_eager():
    """A training step's loss and every gradient through
    ``torch.compile(backend="aot_eager", fullgraph=True)`` equal
    eager's: the operator is one node, its autograd formula traced into
    the backward graph."""
    cfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                              dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    model = tt.Transformer(cfg, device="cpu", generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)

    def loss_fn(tokens):
        logits = model(tokens[:, :-1], train=False)
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))

    def step(fn):
        model.zero_grad(set_to_none=True)
        loss = fn(tokens)
        loss.backward()
        return loss.detach(), [p.grad.clone() for p in model.parameters()]

    want_loss, want_grads = step(loss_fn)
    torch._dynamo.reset()
    got_loss, got_grads = step(torch.compile(loss_fn, backend="aot_eager",
                                             fullgraph=True))
    torch._dynamo.reset()
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
