"""BERT-large in the port against the JAX package.

``TransformerConfig.bert_large()`` field for field the JAX config's; the
forward at BERT-large's widths (d 1024, 16 heads, d_ff 4096, vocab
30522, bidirectional) cut to 2 layers and 64 tokens, fp32, through
``params_from_flax``'s weight carry-over, within 1e-5 of the JAX
forward; the bidirectional flash path with no ``lengths`` (the port's
plain versions on the CPU, the JAX kernels in interpret mode) within
1e-5 in loss, logits and gradients; and BERT's training pairing,
``DistributedOptimizer(SGD(lr 0.01, momentum 0.9), op=Adasum)``, in a
world of one against the JAX optimizer on the 8-device CPU mesh with
every device holding the same batch (Adasum of equal gradients is that
gradient, as a world of one reduces nothing), within 1e-5 after each
step. Inputs come from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.convert import params_from_flax

ATOL = 1e-5  # fp32 on both sides, sums in another order
LR, MOMENTUM, STEPS = 0.01, 0.9, 2


def test_bert_large_fields_equal_the_jax_config():
    want, got = jt.TransformerConfig.bert_large(), tt.TransformerConfig.bert_large()
    shared = [f.name for f in dataclasses.fields(got)
              if f.name != "dtype" and hasattr(want, f.name)]
    assert len(shared) >= 15
    for name in shared:
        assert getattr(got, name) == getattr(want, name), name
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert (got.vocab_size, got.num_layers, got.d_model, got.num_heads,
            got.d_ff, got.max_len, got.causal, got.head_dim) == (
        30522, 24, 1024, 16, 4096, 512, False, 64)


def _pair(**kw):
    """The JAX model, its seeded parameters as numpy, and the port model
    carrying them, fp32 on both sides."""
    jcfg = dataclasses.replace(jt.TransformerConfig.bert_large(),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tt.TransformerConfig.bert_large(),
                               dtype=torch.float32, **kw)
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                         train=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = tt.Transformer(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params, tcfg))
    return jmodel, params, tmodel, tcfg


def test_forward_at_bert_large_widths_matches_jax():
    jmodel, params, tmodel, _ = _pair(num_layers=2)
    tokens = np.random.default_rng(3).integers(0, 30522, size=(2, 64))
    want = np.asarray(jmodel.apply(params, jnp.asarray(tokens), train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens)).numpy()
    assert got.shape == (2, 64, 30522)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).all()


_SMALL = dict(vocab_size=97, num_layers=2, d_model=64, num_heads=4,
              d_ff=128, max_len=32)


def _loss_fn(jmodel, tokens, labels):
    def loss(p):
        logits = jmodel.apply(p, jnp.asarray(tokens), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits
    return loss


def _torch_loss(tmodel, tokens, labels):
    logits = tmodel(torch.from_numpy(tokens))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           torch.from_numpy(labels).reshape(-1)), logits


def test_bidirectional_flash_without_lengths_matches_jax():
    """The path BERT's steps take through the flash kernels: no causal
    mask and no key mask."""
    jmodel, params, tmodel, tcfg = _pair(flash_attention=True, **_SMALL)
    rng = np.random.default_rng(4)
    tokens, labels = (rng.integers(0, 97, (3, 24)) for _ in range(2))
    (j_loss, j_logits), j_grads = jax.value_and_grad(
        _loss_fn(jmodel, tokens, labels), has_aux=True)(params)
    t_loss, t_logits = _torch_loss(tmodel, tokens, labels)
    t_loss.backward()
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), atol=ATOL, rtol=0)
    assert abs(float(t_loss.detach()) - float(j_loss)) < ATOL
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, j_grads),
                            tcfg)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)


def _jax_adasum_trajectory(jmodel, params, tokens, labels):
    """The JAX ``DistributedOptimizer(sgd, op=Adasum)`` on the 8-device
    CPU mesh, every device holding the same batch."""
    from jax.sharding import PartitionSpec as P

    import horovod_tpu as hvd_j

    hvd_j.shutdown()
    hvd_j.init()
    try:
        opt = hvd_j.DistributedOptimizer(optax.sgd(LR, momentum=MOMENTUM),
                                         op=hvd_j.Adasum)

        def step(p, state, tok, lab):
            g = jax.grad(lambda q: _loss_fn(jmodel, tok[0], lab[0])(q)[0])(p)
            upd, state = opt.update(g, state, p)
            return optax.apply_updates(p, upd), state

        world = hvd_j.WORLD_AXIS
        f = jax.jit(jax.shard_map(
            step, mesh=hvd_j.mesh(), in_specs=(P(), P(), P(world), P(world)),
            out_specs=(P(), P()), check_vma=False))
        n = hvd_j.size()
        tok = jnp.asarray(np.broadcast_to(tokens, (n,) + tokens.shape))
        lab = jnp.asarray(np.broadcast_to(labels, (n,) + labels.shape))
        p = jax.tree_util.tree_map(jnp.asarray, params)
        state = opt.init(p)
        out = []
        for _ in range(STEPS):
            p, state = f(p, state, tok, lab)
            out.append(jax.tree_util.tree_map(np.asarray, p))
        return out
    finally:
        hvd_j.shutdown()


def test_adasum_training_pairing_in_a_world_of_one_matches_jax(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    jmodel, params, tmodel, tcfg = _pair(**_SMALL)
    rng = np.random.default_rng(5)
    tokens, labels = (rng.integers(0, 97, (4, 16)) for _ in range(2))
    want = _jax_adasum_trajectory(jmodel, params, tokens, labels)
    hvd.init(device="cpu")
    try:
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(tmodel.parameters(), lr=LR, momentum=MOMENTUM),
            named_parameters=tmodel.named_parameters(), op=hvd.Adasum)
        try:
            for i in range(STEPS):
                opt.zero_grad(set_to_none=True)
                _torch_loss(tmodel, tokens, labels)[0].backward()
                opt.step()
                ref = params_from_flax(want[i], tcfg)
                for name, p in tmodel.named_parameters():
                    np.testing.assert_allclose(
                        p.detach().numpy(), ref[name].numpy(), atol=ATOL,
                        rtol=0, err_msg=f"step {i} {name}")
        finally:
            opt.remove_hooks()
    finally:
        hvd.shutdown()
    start = params_from_flax(params, tcfg)
    assert any(not np.allclose(start[n].numpy(), p.detach().numpy())
               for n, p in tmodel.named_parameters())


def test_bert_large_depth_cut_keeps_its_widths():
    cfg = dataclasses.replace(tt.TransformerConfig.bert_large(),
                              num_layers=1, dtype=torch.float32)
    model = tt.Transformer(cfg, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["embed.weight"] == (30522, 1024)
    assert shapes["pos_embed.weight"] == (512, 1024)
    assert shapes["lm_head.kernel"] == (1024, 30522)
