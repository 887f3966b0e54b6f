"""The composed dp × pp × ep × sp × tp train step of the port
(``horovod_tpu_torch/parallel/transformer.py``) against the JAX step.

The JAX package's ``_init_full_params`` tree (PRNGKey 0) goes to both:
the JAX step runs once on its dp-2 mesh (the JAX package's own tests
hold every other factorization to that step at rtol 5e-4, atol 1e-5),
and the port, through ``parallel_params_from_jax``, on the meshes
``(dp2,sp2,tp2)``, ``(dp2,pp2,ep2)``, ``(pp2,sp2,tp2)``, ``(ep2,sp2,tp2)``,
the flash ring, 1F1B against GPipe, and RoPE, in one gloo world of 8 CPU
processes. After one SGD step every rank's shards must equal the JAX
step's parameters and the port's own dp-only step's within rtol 5e-4,
atol 1e-5, and the losses within 1e-5: the check that catches a
gradient-scaling fault on any axis.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import _run, file_store

WORLD = 8
CFG = dict(vocab_size=64, num_layers=2, d_model=16, num_heads=2, d_ff=32,
           max_len=32, n_experts=2, n_microbatches=2,
           moe_capacity_factor=8.0, learning_rate=0.05)
# (label, mesh axes, config overrides)
CASES = [
    ("dp2", dict(dp=2), {}),
    ("dp2_sp2_tp2", dict(dp=2, sp=2, tp=2), {}),
    ("dp2_pp2_ep2", dict(dp=2, pp=2, ep=2), {}),
    ("pp2_sp2_tp2", dict(pp=2, sp=2, tp=2), {}),
    ("ep2_sp2_tp2", dict(ep=2, sp=2, tp=2), {}),
    ("flash_ring", dict(dp=2, sp=2, tp=2), dict(flash_ring=True)),
    ("gpipe", dict(dp=2, pp=2, ep=2), dict(pipeline_schedule="gpipe")),
    ("rope_dp2", dict(dp=2), dict(rope=True)),
    ("rope", dict(dp=2, sp=2, tp=2), dict(rope=True)),
]


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(4, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1).astype(np.int32)


def _load_tree(path):
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def _plain(tree):
    """Nested dicts of tensors (``torch.load``'s safe subset)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree.detach()


def _step_worker(rank, n, outdir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import parallel_params_from_jax
    from horovod_tpu_torch.parallel import MeshSpec
    from horovod_tpu_torch.parallel import transformer as ptf

    torch.manual_seed(0)
    hvd.init(device="cpu", store=file_store(outdir, n))
    tree = {k: _load_tree(Path(outdir) / f"{k}.npz")
            for k in ("init", "init_rope")}
    tokens, labels = _batch()
    out = {}
    for label, axes, over in CASES:
        spec = MeshSpec(**axes)
        mesh = spec.build(list(range(spec.size)))
        if not mesh.member:
            continue
        cfg = ptf.ParallelTransformerConfig(**CFG, **over)
        params = parallel_params_from_jax(
            tree["init_rope" if cfg.rope else "init"], cfg, mesh,
            device="cpu")
        step = ptf.make_train_step(cfg, mesh, device="cpu")
        params, loss = step(params, tokens, labels)
        out[label] = {"coords": dict(mesh.coords), "loss": float(loss),
                      "params": _plain(params)}
    # four steps on a pipelined, expert-parallel mesh: the loss falls
    mesh = MeshSpec(dp=2, pp=2, ep=2).build()
    cfg = ptf.ParallelTransformerConfig(**CFG)
    params = parallel_params_from_jax(tree["init"], cfg, mesh, device="cpu")
    step = ptf.make_train_step(cfg, mesh, device="cpu")
    losses = []
    for _ in range(4):
        params, loss = step(params, tokens, labels)
        losses.append(float(loss))
    out["trains"] = {"losses": losses, "stats": dict(step.stats)}
    hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


def _save_tree(tree, path):
    flat = {}

    def walk(node, prefix):
        items = node._asdict().items() if hasattr(node, "_asdict") else \
            node.items()
        for k, v in items:
            if isinstance(v, dict) or hasattr(v, "_asdict"):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def _jax_step(rope):
    """The JAX step on its dp-2 mesh: (initial tree, stepped tree, loss)
    on the host."""
    import jax

    from horovod_tpu.parallel import MeshSpec
    from horovod_tpu.parallel.transformer import (
        ParallelTransformerConfig,
        _init_full_params,
        make_sharded_params,
        make_train_step,
    )

    cfg = ParallelTransformerConfig(**CFG, rope=rope)
    mesh = MeshSpec(dp=2).build(jax.devices()[:2])
    init = jax.device_get(_init_full_params(cfg, jax.random.PRNGKey(0)))
    params = make_sharded_params(cfg, mesh, jax.random.PRNGKey(0))
    tokens, labels = _batch()
    params, loss = make_train_step(cfg, mesh)(params, tokens, labels)
    return init, jax.device_get(params), float(loss)


@pytest.fixture(scope="module")
def jax_steps():
    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init()
    try:
        yield {rope: _jax_step(rope) for rope in (False, True)}
    finally:
        jhvd.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_steps):
    tmp = tmp_path_factory.mktemp("parallel_step")
    _save_tree(jax_steps[False][0], tmp / "init.npz")
    _save_tree(jax_steps[True][0], tmp / "init_rope.npz")
    return _run(tmp, WORLD, Path(__file__), "_step_worker", 300, None)


SPECS = {
    "embed": {"tok": (), "pos": ()},
    "stages": {"ln1_scale": ("pp",), "ln1_bias": ("pp",),
               "wqkv": ("pp", None, None, "tp", None),
               "wo": ("pp", "tp", None, None), "ln2_scale": ("pp",),
               "ln2_bias": ("pp",), "w1": ("pp", None, "tp"),
               "b1": ("pp", "tp"), "w2": ("pp", "tp", None), "b2": ("pp",)},
    "tail": {"lnf_scale": (), "lnf_bias": (), "lm_head": (None, "tp"),
             "moe": {"router": (), "w1": ("ep",), "b1": ("ep",),
                     "w2": ("ep",), "b2": ("ep",)}},
}


def _block(full, spec, coords, sizes):
    """A rank's block of a full leaf, cut independently of the port."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            step = full.shape[dim] // sizes[axis]
            idx = [slice(None)] * full.ndim
            idx[dim] = slice(coords[axis] * step, (coords[axis] + 1) * step)
            full = full[tuple(idx)]
    return full


def _leaves(tree, spec, path=""):
    if isinstance(spec, dict):
        for k, s in spec.items():
            node = tree._asdict()[k] if hasattr(tree, "_asdict") else \
                tree[k]
            yield from _leaves(node, s, f"{path}/{k}")
    else:
        yield path, tree, spec


def _assert_matches(got, want_tree, axes, label):
    sizes = dict(dict.fromkeys(("dp", "pp", "ep", "sp", "tp"), 1), **axes)
    mine = {p: t for p, t, _ in _leaves(got["params"], SPECS)}
    checked = 0
    for path, full, spec in _leaves(want_tree, SPECS):
        want = _block(np.asarray(full), spec, got["coords"], sizes)
        np.testing.assert_allclose(
            np.asarray(mine[path]), want, rtol=5e-4, atol=1e-5,
            err_msg=f"{label}: {path} at {got['coords']}")
        checked += 1
    assert checked == 20


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_step_matches_jax_step(world, jax_steps, label):
    """Every rank's parameters after one step against the JAX step's
    (the dp-2 JAX mesh, with RoPE for the RoPE cases), and the loss."""
    axes = dict((c[0], c[1]) for c in CASES)[label]
    _, want, want_loss = jax_steps[label.startswith("rope")]
    n = int(np.prod(list(axes.values())))
    for r in range(n):
        got = world[r][label]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        _assert_matches(got, want, axes, label)


@pytest.mark.parametrize("label", [c[0] for c in CASES
                                   if c[0] not in ("dp2", "rope_dp2")])
def test_step_matches_port_dp_only(world, label):
    """The end state of the gradient-scaling rule: every factorization's
    step lands on the port's dp-only step (1F1B on GPipe's too)."""
    axes = dict((c[0], c[1]) for c in CASES)[label]
    base_label = "rope_dp2" if label.startswith("rope") else "dp2"
    base = world[0][base_label]
    flat_base = {p: t for p, t, _ in _leaves(base["params"], SPECS)}
    sizes = dict(dict.fromkeys(("dp", "pp", "ep", "sp", "tp"), 1), **axes)
    n = int(np.prod(list(axes.values())))
    for r in range(n):
        got = world[r][label]
        np.testing.assert_allclose(got["loss"], base["loss"], rtol=1e-5)
        for path, t, spec in _leaves(got["params"], SPECS):
            want = _block(np.asarray(flat_base[path]), spec, got["coords"],
                          sizes)
            np.testing.assert_allclose(np.asarray(t), want, rtol=5e-4,
                                       atol=1e-5, err_msg=f"{label} {path}")


def test_gpipe_and_1f1b_agree(world):
    for r in range(WORLD):
        a, b = world[r]["gpipe"], world[r]["dp2_pp2_ep2"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for (path, x, _), (_, y, _) in zip(_leaves(a["params"], SPECS),
                                           _leaves(b["params"], SPECS)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=5e-4, atol=1e-5, err_msg=path)


def test_pipelined_expert_mesh_trains(world):
    for r in range(WORLD):
        got = world[r]["trains"]
        losses = got["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
        assert len(set(o["trains"]["losses"][-1] for o in world)) == 1
        # the 1F1B stash: at most max_in_flight + 1 stage inputs
        st = got["stats"]
        assert 1 <= st["stash_peak"] <= st["max_in_flight"] + 1
