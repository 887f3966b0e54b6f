"""The port's chunked fused linear cross-entropy
(``horovod_tpu_torch/ops/fused_xent.py``) against the JAX package's
(``horovod_tpu/ops/fused_xent.py``), on the CPU, on the cases of
tests/test_fused_xent.py: the same numpy inputs from a seed.

* the chunks cover the vocabulary exactly, as the reference's;
* fp32 (``compute_dtype=None``): the per-token losses and dx, dW, db
  against the JAX fused function within 1e-5 of each tensor's largest
  magnitude (fp32 sums in other orders), for chunks that divide the
  vocabulary, leave a tail, or cover it at once;
* bf16 operands with fp32 results: loss and gradients within one bf16
  rounding of the port's dense bf16 head (``LMHead``'s product, then
  ``cross_entropy``), and of the JAX fused function;
* dx comes back in x's dtype; the Transformer's ``return_hidden`` feeds
  the loss and matches the logits path."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from horovod_tpu.ops import fused_xent as jfx
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import fused_xent as tfx

BF16_ROUNDING = 2.0 ** -8  # one rounding, relative


def _problem(n=24, d=16, vocab=101, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    kernel = (rng.normal(size=(d, vocab)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(vocab,)) * 0.1).astype(np.float32)
    # every boundary class: 0, vocab − 1, chunk edges
    labels = np.concatenate([[0, vocab - 1],
                             rng.integers(0, vocab, size=n - 2)])
    return x, kernel, bias, labels.astype(np.int32)


def _jax(x, kernel, bias, labels, chunk, dtype):
    """Losses and (dx, dW, db) of the mean loss, from the JAX function."""
    def f(x, k, b):
        return jfx.fused_linear_cross_entropy(
            x, k, b, jnp.asarray(labels), chunk=chunk, compute_dtype=dtype)

    loss = f(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    grads = jax.grad(lambda *a: f(*a).mean(), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    return np.asarray(loss), [np.asarray(g, np.float32) for g in grads]


def _port(fn, x, kernel, bias, labels):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, kernel, bias)]
    loss = fn(*leaves, torch.from_numpy(labels))
    loss.mean().backward()
    return loss.detach().numpy(), [t.grad.float().numpy() for t in leaves]


def _close(got, want, rel, what):
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("vocab,chunk", [(101, 32), (101, 101), (101, 1000),
                                         (64, 64), (64, 16), (7, 3), (1, 5)])
def test_chunk_starts_match_reference(vocab, chunk):
    spans = tfx._chunk_starts(vocab, chunk)
    assert spans == jfx._chunk_starts(vocab, chunk)
    assert [c for s, w in spans for c in range(s, s + w)] == list(range(vocab))


@pytest.mark.parametrize("chunk", [16, 32, 37, 101, 4096])
def test_fp32_loss_and_grads_match_jax(chunk):
    x, kernel, bias, labels = _problem()
    want, want_g = _jax(x, kernel, bias, labels, chunk, None)
    got, got_g = _port(lambda *a: tfx.fused_linear_cross_entropy(
        *a, chunk=chunk, compute_dtype=None), x, kernel, bias, labels)
    _close(got, want, 1e-5, "loss")
    for g, w, name in zip(got_g, want_g, ("dx", "dW", "db")):
        _close(g, w, 1e-5, name)


def _dense_bf16(x, kernel, bias, labels):
    logits = tfx.mixed_linear(x, kernel, bias, torch.bfloat16)
    return F.cross_entropy(logits, labels.long(), reduction="none")


def test_bf16_within_one_rounding_of_dense_bf16_head():
    """The same operand rounding and fp32 results as the dense bf16
    head: the logsumexp's chunk order and the rounding of dlogits to
    bf16 per chunk are what may differ."""
    x, kernel, bias, labels = _problem(n=32, d=32, vocab=257)
    want, want_g = _port(_dense_bf16, x, kernel, bias, labels)
    got, got_g = _port(lambda *a: tfx.fused_linear_cross_entropy(
        *a, chunk=64), x, kernel, bias, labels)
    _close(got, want, BF16_ROUNDING, "loss")
    for g, w, name in zip(got_g, want_g, ("dx", "dW", "db")):
        _close(g, w, BF16_ROUNDING, name)
    # and the JAX function's bf16 recipe
    jwant, jwant_g = _jax(x, kernel, bias, labels, 64, jnp.bfloat16)
    _close(got, jwant, BF16_ROUNDING, "loss vs JAX")
    for g, w, name in zip(got_g, jwant_g, ("dx", "dW", "db")):
        _close(g, w, BF16_ROUNDING, f"{name} vs JAX")


def test_mixed_product_rounds_operands_once():
    """``mixed_mm`` on the CPU: the fp32 product of the bf16-rounded
    operands, fp32 out (on CUDA one tensor-core product)."""
    x, kernel, _, _ = _problem()
    a, b = torch.from_numpy(x), torch.from_numpy(kernel)
    got = tfx.mixed_mm(a, b, torch.bfloat16)
    assert got.dtype == torch.float32
    want = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(tfx.mixed_mm(a, b, None), a @ b)


def test_bf16_activations_gradient_dtype():
    x, kernel, bias, labels = _problem()
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tfx.fused_linear_cross_entropy(
        xt, torch.from_numpy(kernel), torch.from_numpy(bias),
        torch.from_numpy(labels), chunk=32).mean().backward()
    assert xt.grad.dtype == torch.bfloat16


def test_shape_errors():
    x, kernel, bias, labels = (torch.from_numpy(a) for a in _problem())
    out = tfx.fused_linear_cross_entropy(x, kernel, bias, labels, chunk=32,
                                         compute_dtype=None)
    assert out.shape == labels.shape and out.dtype == torch.float32
    with pytest.raises(ValueError, match="tokens, d_model"):
        tfx.fused_linear_cross_entropy(x[None], kernel, bias, labels)
    with pytest.raises(ValueError, match="labels shape"):
        tfx.fused_linear_cross_entropy(x, kernel, bias, labels[:3])


@pytest.mark.parametrize("mixed", [False, True])
def test_transformer_hidden_path_matches_logits_path(mixed):
    """``model(..., return_hidden=True)`` and the fused loss against the
    logits and ``cross_entropy``, on the port's tiny Transformer: fp32
    within 1e-5, and with a bf16 head within one bf16 rounding."""
    cfg = tt.TransformerConfig.tiny(causal=True)  # fp32; the head mixed
    g = torch.Generator().manual_seed(0)
    model = tt.Transformer(cfg, device="cpu", generator=g)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    dtype = torch.bfloat16 if mixed else None

    def dense():
        h = model(tokens, train=False, return_hidden=True)
        logits = tfx.mixed_linear(h, model.lm_head.kernel,
                                  model.lm_head.bias, dtype)
        return F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               labels.reshape(-1))

    def fused():
        h = model(tokens, train=False, return_hidden=True)
        return tfx.fused_linear_cross_entropy(
            h.reshape(-1, cfg.d_model), model.lm_head.kernel,
            model.lm_head.bias, labels.reshape(-1), chunk=64,
            compute_dtype=dtype).mean()

    rel = BF16_ROUNDING if mixed else 1e-5
    runs = []
    for fn in (dense, fused):
        model.zero_grad(set_to_none=True)
        loss = fn()
        loss.backward()
        runs.append((loss.item(), {n: p.grad.clone() for n, p
                                   in model.named_parameters()}))
    (ld, gd), (lf, gf) = runs
    assert abs(lf - ld) <= rel * abs(ld)
    for name, want in gd.items():
        _close(gf[name].numpy(), want.numpy(), rel, name)
    if not mixed:  # the dense path is the model's own logits
        with torch.no_grad():
            torch.testing.assert_close(
                model.lm_head(model(tokens, train=False, return_hidden=True)),
                model(tokens, train=False))
