"""``DistributedOptimizer`` with ``op=Adasum`` and with the int8 wire and
error feedback, in gloo worlds on the CPU.

- ``op=Adasum`` in a world of 4 on a small Transformer: each rank's
  reduced gradient equals the VHDD host oracle (``adasum_vhdd_host``,
  the JAX package's, fp64) of the four ranks' own gradients, within
  1e-5 of the gradient's largest magnitude.
- ``Compression.int8_block`` with ``error_feedback=True`` trains the
  small Transformer LM (a world of 2, the learnable sequence of
  examples/transformer_lm.py) as the fp32 wire does: the loss falls as
  far, within 5 % (tests/test_error_feedback.py:112 trains through EF).
- With error feedback the cumulative error of 40 steps of the same
  gradient stays within a few quanta, where without it the error
  random-walks (tests/test_error_feedback.py:97); ``state_dict`` carries
  the residuals.
- ``error_feedback`` without a quantized wire, and Adasum with one,
  raise.
- Training steps on the fp32 wire and on the int8 wire leave no fusion
  entry, handle or batch to the cyclic collector: reference counting
  frees them, and with them the batches' buffers."""

import dataclasses
import gc
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd

from test_torch_collectives import _run, file_store

VOCAB, T, BATCH = 64, 16, 4


def _model(seed=0):
    from horovod_tpu_torch import Transformer, TransformerConfig

    cfg = dataclasses.replace(TransformerConfig.tiny(), vocab_size=VOCAB,
                              num_layers=2, d_model=32, d_ff=64,
                              max_len=32)
    gen = torch.Generator().manual_seed(seed)
    return Transformer(cfg, device="cpu", generator=gen)


def _lm_batch(rank, step=0):
    rng = np.random.default_rng(1000 * rank + step)
    base = rng.integers(0, VOCAB - 1, size=(BATCH, 1))
    rows = (base + np.arange(T + 1)[None, :]) % VOCAB
    return torch.from_numpy(rows[:, :-1]), torch.from_numpy(rows[:, 1:])


def _loss(model, tokens, labels):
    logits = model(tokens)
    return F.cross_entropy(logits.reshape(-1, VOCAB), labels.reshape(-1))


def _adasum_worker(rank, n, outdir):
    hvd.init(device="cpu", store=file_store(outdir, n))
    model = _model()
    tokens, labels = _lm_batch(rank)
    _loss(model, tokens, labels).backward()
    local = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    _loss(model, tokens, labels).backward()
    opt.synchronize()
    reduced = {k: p.grad.clone() for k, p in model.named_parameters()}
    opt.remove_hooks()
    hvd.shutdown()
    torch.save({"local": local, "reduced": reduced},
               Path(outdir) / f"rank{rank}.pt")


def _train_worker(rank, n, outdir):
    hvd.init(device="cpu", store=file_store(outdir, n))
    out = {}
    for name, kw in (("fp32", {}),
                     ("int8_ef", dict(compression=hvd.Compression.int8_block,
                                      error_feedback=True))):
        model = _model()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9),
            named_parameters=model.named_parameters(), **kw)
        losses = []
        for step in range(25):
            opt.zero_grad(set_to_none=True)
            loss = _loss(model, *_lm_batch(rank, step))
            loss.backward()
            opt.step()
            losses.append(float(loss))
        out[name] = losses
        if name == "int8_ef":
            out["residual_norm"] = opt.residual_norm()
            out["sd_residuals"] = len(opt.state_dict()["ef_residuals"])
            out["n_params"] = len(list(model.parameters()))
        opt.remove_hooks()
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


STEPS = 40


def _cumulative_worker(rank, n, outdir):
    """SGD(lr=1) on w from zero with the same gradient every step: −w is
    the cumulative transmitted gradient."""
    hvd.init(device="cpu", store=file_store(outdir, n))
    g = torch.from_numpy(np.random.default_rng(1).normal(size=96).astype(
        np.float32))
    out = {}
    for ef in (True, False):
        w = torch.nn.Parameter(torch.zeros(96))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=1.0), compression=hvd.Compression.int8,
            op=hvd.Average, error_feedback=ef)
        for _ in range(STEPS):
            w.grad = g.clone()
            opt.step()
        out[ef] = -w.detach().double()
        if ef:
            sd = opt.state_dict()
            fresh = hvd.DistributedOptimizer(
                torch.optim.SGD([torch.nn.Parameter(torch.zeros(96))],
                                lr=1.0),
                compression=hvd.Compression.int8, error_feedback=True)
            fresh.load_state_dict(sd)
            out["reloaded"] = torch.equal(
                next(iter(fresh._residuals.values())),
                next(iter(opt._residuals.values())))
            fresh.remove_hooks()
        opt.remove_hooks()
    hvd.shutdown()
    out["g"] = g.double()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


def test_adasum_gradients_match_vhdd_oracle(tmp_path):
    from horovod_tpu.ops.adasum import adasum_vhdd_host

    outs = _run(tmp_path, 4, Path(__file__), "_adasum_worker", 120, None)
    for name in outs[0]["local"]:
        stack = np.stack([o["local"][name].double().numpy() for o in outs])
        want = adasum_vhdd_host(stack)
        scale = max(np.abs(want).max(), 1e-12)
        for o in outs:
            got = o["reduced"][name].double().numpy()
            assert np.abs(got - want).max() <= 1e-5 * scale, name


def test_int8_block_with_error_feedback_trains(tmp_path):
    outs = _run(tmp_path, 2, Path(__file__), "_train_worker", 150, None)
    for o in outs:
        fp32, ef = o["fp32"], o["int8_ef"]
        assert all(np.isfinite(ef))
        assert ef[-1] < 0.5 * ef[0], ef
        # falls as far as the exact wire, within 5 %
        assert abs(ef[-1] - fp32[-1]) <= 0.05 * fp32[0], (ef[-1], fp32[-1])
        assert o["residual_norm"] > 0
        assert o["sd_residuals"] == o["n_params"]
    assert outs[0]["int8_ef"] != outs[0]["fp32"]


def test_cumulative_error_bounded_with_error_feedback(tmp_path):
    outs = _run(tmp_path, 2, Path(__file__), "_cumulative_worker", 120,
                None)
    for o in outs:
        g = o["g"].numpy()
        quantum = np.abs(g).max() / 127.0
        ef_err = np.abs(o[True].numpy() - STEPS * g).max() / quantum
        plain_err = np.abs(o[False].numpy() - STEPS * g).max() / quantum
        assert ef_err < 8.0, ef_err
        assert ef_err < 0.7 * plain_err, (ef_err, plain_err)
        assert o["reloaded"]


def test_misuse_raises(monkeypatch):
    for name in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        sgd = torch.optim.SGD(_model().parameters(), lr=0.1)
        for comp in (hvd.Compression.none, hvd.Compression.bf16):
            with pytest.raises(ValueError, match="quantized-wire"):
                hvd.DistributedOptimizer(sgd, compression=comp,
                                         error_feedback=True)
        for comp in (hvd.Compression.int8, hvd.Compression.int8_block):
            with pytest.raises(ValueError, match="Adasum"):
                hvd.DistributedOptimizer(sgd, op=hvd.Adasum,
                                         compression=comp)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("wire", ["fp32", "int8_ef"])
def test_steps_leave_no_reference_cycles(monkeypatch, wire):
    from horovod_tpu_torch.ops import eager, fusion

    for name in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    kw = {} if wire == "fp32" else dict(
        compression=hvd.Compression.int8_block, error_feedback=True)
    hvd.init(device="cpu")
    model = _model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), op=hvd.Average, **kw)
    tokens, labels = _lm_batch(0)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            _loss(model, tokens, labels).backward()
            opt.step()
        gc.collect()
        kinds = (fusion._Entry, fusion.Handle, fusion._Batch,
                 eager.TorchHandle)
        left = [type(o).__name__ for o in gc.garbage
                if isinstance(o, kinds)]
        assert not left, f"{len(left)} left to the cyclic collector"
    finally:
        gc.set_debug(0)
        del gc.garbage[:]
        gc.enable()
        opt.remove_hooks()
        hvd.shutdown()
