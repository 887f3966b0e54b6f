"""The port's training forward and backward against the JAX model.

One seeded Flax init of the tiny Transformer (fp32) is carried into the
port by ``params_from_flax``; the same tokens go through both models
with ``flash_attention=True`` on both sides (the JAX kernels in
interpret mode, the port's Function with its plain versions on the
CPU). Logits, the softmax cross-entropy loss and every parameter's
gradient (the JAX gradient tree mapped by name through
``params_from_flax``) agree within 1e-5, for learned positions, with
``lengths``, and for RoPE with GQA and a sliding window. Also: the dense
path with a ``mask=``, ``remat`` equal to no remat (dropout on), the
dropout contract, and explicit ``flash_attention=True`` with a mask
raising."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax

ATOL = 1e-5
VOCAB, T = 61, 16
VARIANTS = {
    "learned-pos": dict(),
    "lengths": dict(lengths=[16, 9, 3]),
    "rope-gqa-window": dict(cfg=dict(rope=True, num_kv_heads=2,
                                     sliding_window=5)),
}


@pytest.fixture
def one_thread():
    """Small ops gain little from torch's intra-op threads, and beside
    other test processes the threads only contend for the cores: run on
    one, then restore the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(flash=True, **kw):
    base = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
                d_ff=64, max_len=32, flash_attention=flash)
    base.update(kw)
    return (jt.TransformerConfig(dtype=jnp.float32, **base),
            tt.TransformerConfig(dtype=torch.float32, **base))


def _models(flash=True, **kw):
    jcfg, tcfg = _cfgs(flash, **kw)
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                         train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tt.Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params, tcfg))
    return jmodel, params, tmodel, tcfg


def _batch(b=3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (b, T)), rng.integers(0, VOCAB, (b, T)))


def _jax_step(jmodel, params, tokens, labels, **kw):
    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(tokens), train=False, **kw)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), np.asarray(logits), jax.tree_util.tree_map(
        np.asarray, grads)


def _torch_step(tmodel, tokens, labels, **kw):
    tmodel.zero_grad(set_to_none=True)
    logits = tmodel(torch.from_numpy(tokens), **kw)
    loss = F.cross_entropy(logits.reshape(-1, VOCAB),
                           torch.from_numpy(labels).reshape(-1))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    return float(loss.detach()), logits.detach().numpy(), grads


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_logits_and_gradients_match_jax(variant):
    spec = VARIANTS[variant]
    jmodel, params, tmodel, tcfg = _models(**spec.get("cfg", {}))
    tokens, labels = _batch()
    kw = {}
    if "lengths" in spec:
        kw["lengths"] = np.asarray(spec["lengths"], np.int32)
    j_loss, j_logits, j_grads = _jax_step(jmodel, params, tokens, labels,
                                          **kw)
    t_loss, t_logits, t_grads = _torch_step(
        tmodel, tokens, labels,
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    )
    np.testing.assert_allclose(t_logits, j_logits, atol=ATOL, rtol=0)
    assert abs(t_loss - j_loss) < ATOL
    want = params_from_flax(j_grads, tcfg)  # gradients map by name too
    assert sorted(want) == sorted(t_grads)
    for name, g in want.items():
        np.testing.assert_allclose(t_grads[name].numpy(), g.numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_dense_path_with_mask_matches_jax():
    """flash_attention=False with a key-padding ``mask=`` and
    ``lengths=``: the dense twin, against the JAX dense path."""
    jmodel, params, tmodel, tcfg = _models(flash=False)
    tokens, labels = _batch(b=2)
    mask = np.ones((2, T), bool)
    mask[0, 3:7] = False
    lengths = np.asarray([T, 11], np.int32)
    j = _jax_step(jmodel, params, tokens, labels, mask=jnp.asarray(mask),
                  lengths=jnp.asarray(lengths))
    t = _torch_step(tmodel, tokens, labels, mask=torch.from_numpy(mask),
                    lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(t[1], j[1], atol=ATOL, rtol=0)
    want = params_from_flax(j[2], tcfg)
    for name, g in want.items():
        np.testing.assert_allclose(t[2][name].numpy(), g.numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_flash_equals_dense_in_the_port():
    *_, flash, _ = _models(flash=True)
    *_, dense, _ = _models(flash=False)
    tokens, labels = _batch()
    lengths = torch.tensor([T, 5, 12])
    a = _torch_step(flash, tokens, labels, lengths=lengths)
    b = _torch_step(dense, tokens, labels, lengths=lengths)
    np.testing.assert_allclose(a[1], b[1], atol=ATOL, rtol=0)
    for name in a[2]:
        np.testing.assert_allclose(a[2][name], b[2][name], atol=ATOL, rtol=0)


def test_remat_equals_no_remat_with_dropout():
    """Dropout at rate 0.1 drawn from one seeded generator: the blocks'
    recompute under remat replays the same masks, so loss and gradients
    equal the run without remat."""
    *_, tmodel, tcfg = _models(dropout_rate=0.1)
    tokens, labels = _batch()
    runs = []
    for remat in (False, True):
        tmodel.cfg = dataclasses.replace(tcfg, remat=remat)
        rng = torch.Generator().manual_seed(11)
        runs.append(_torch_step(tmodel, tokens, labels, rng=rng))
    (l0, _, g0), (l1, _, g1) = runs
    assert l0 == l1
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6, rtol=0)
    # a different seed draws other masks
    rng = torch.Generator().manual_seed(12)
    assert _torch_step(tmodel, tokens, labels, rng=rng)[0] != l0


def test_dropout_contract():
    *_, tmodel, tcfg = _models(dropout_rate=0.5)
    *_, plain, _ = _models()
    tokens = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        # train=False: the identity, no generator needed
        torch.testing.assert_close(tmodel(tokens, train=False),
                                   plain(tokens, train=False))
        with pytest.raises(ValueError, match="rng="):
            tmodel(tokens, train=True)
    x = torch.ones(400_000)
    gen = torch.Generator().manual_seed(0)
    y = tt._dropout(x, 0.5, gen)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float(y.mean()) - 1.0) < 0.01  # the mean is preserved
    assert tt._dropout(x, 0.5, None) is x


def test_flash_true_with_mask_raises():
    *_, tmodel, _ = _models(flash=True)
    tokens = torch.from_numpy(_batch()[0])
    with pytest.raises(ValueError, match="mask="):
        tmodel(tokens, mask=torch.ones(3, T, dtype=torch.bool))
    *_, auto, _ = _models(flash="auto")  # auto with a mask: dense
    assert auto(tokens, mask=torch.ones(3, T, dtype=torch.bool)).shape == (
        3, T, VOCAB)


def test_flash_gate():
    cfg = tt.TransformerConfig.gpt2_medium()
    assert cfg.flash_attention == "auto"
    assert not cfg.uses_flash(device="cpu")
    assert cfg.uses_flash(device="cuda")
    assert not cfg.uses_flash(mask=torch.ones(1), device="cuda")
    assert not dataclasses.replace(cfg, d_model=1040, num_heads=16) \
        .uses_flash(device="cuda")  # head_dim 65: not a kernel geometry
    assert dataclasses.replace(cfg, flash_attention=True).uses_flash(
        device="cpu")
    assert not dataclasses.replace(cfg, flash_attention=False).uses_flash(
        device="cuda")


def test_return_hidden():
    *_, tmodel, tcfg = _models()
    tokens = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        h = tmodel(tokens, return_hidden=True)
        assert h.shape == (3, T, tcfg.d_model)
        torch.testing.assert_close(tmodel.lm_head(h), tmodel(tokens))
