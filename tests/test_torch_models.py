"""The port's model zoo (``horovod_tpu_torch/models/``) against the JAX
models it was ported from, on the CPU.

Each case fills the JAX model's variables (their shapes from
``jax.eval_shape`` of its ``init``) with numpy draws from a seed:
kernels normal with variance 1/fan-in, biases, scales and running
statistics away from their initial 0 and 1. It carries them across with
the model's ``*_params_from_flax`` carrier (HWIO kernels to
OIHW, the NHWC flatten's rows reordered for NCHW, ``batch_stats`` into
the running buffers), feeds both the same numpy images (NHWC to JAX,
NCHW to the port) and compares, in fp32:

* the logits in evaluation mode, and in training mode where the model
  has batch norm, with the updated ``batch_stats`` (momentum 0.9 on the
  old value, the biased variance);
* the gradients of the mean cross-entropy, parameter by parameter (in
  training mode where the model has batch norm; dropout is off or the
  model is in evaluation mode, since masks from different generators
  cannot agree).

Tolerance: max |port − JAX| ≤ 1e-5 · max(1, max |JAX|) for each tensor
(fp32 sums in other orders), and the argmax of the logits identical.
Training mode normalises with batch statistics, whose ``E[x²] − E[x]²``
cancels: through a whole deep network fp32 rounding grows past 1e-5
for either implementation (ResNet-50 at 64²: the port's fp32 logits
2.3e-4 from its own fp64 ones, the jitted JAX model's 7.3e-4). So the
full-depth models are compared in evaluation mode, and training mode at
the tiny sizes, the small ResNet and each Inception block alone. The
small ResNet's JAX side runs op by op: its jitted backward through the
batch norms strays up to 7e-3 from the fp64 gradients there, the
port's 1e-6.
The stride-2 case shows why the convolutions pad Flax's way: with
PyTorch's symmetric padding the same weights miss the JAX logits."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from horovod_tpu.models import inception as j_inception
from horovod_tpu.models import mnist as j_mnist
from horovod_tpu.models import resnet as j_resnet
from horovod_tpu.models import vgg as j_vgg
from horovod_tpu.models import vit as j_vit
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import inception as t_inception
from horovod_tpu_torch.models import mnist as t_mnist
from horovod_tpu_torch.models import resnet as t_resnet
from horovod_tpu_torch.models import vgg as t_vgg
from horovod_tpu_torch.models import vit as t_vit
from horovod_tpu_torch.models.layers import Conv, same_pads

TOL = 1e-5


@pytest.fixture
def one_thread():
    """Small ops gain little from torch's intra-op threads, and beside
    other test processes the threads only contend for the cores: run on
    one, then restore the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |port - JAX| {err:.3g} > {bound:.3g}"


def _images(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _labels(n, classes, seed=1):
    return np.random.default_rng(seed).integers(0, classes, size=n)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _variables(model, x, seed=0):
    """The model's variables, drawn with numpy from ``seed``."""
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        shape = leaf.shape
        if "kernel" in name:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif "scale" in name:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif "var" in name:
            v = 1.0 + 0.5 * rng.uniform(size=shape)
        else:  # biases, cls, pos_embed, running means
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_loss_grads(model, variables, x, labels, train):
    """The JAX model's logits, mean cross-entropy gradients over its
    params and (with batch norm in training) the updated batch_stats;
    jitted in evaluation mode, op by op in training mode (see the
    module's docstring)."""
    stats = variables.get("batch_stats")

    def loss(p):
        v = {"params": p}
        if stats is not None:
            v["batch_stats"] = stats
        if train and stats is not None:
            out, mut = model.apply(v, x, train=True,
                                   mutable=["batch_stats"])
        else:
            out, mut = model.apply(v, x, train=train), {}
        xent = optax.softmax_cross_entropy_with_integer_labels(
            out, jnp.asarray(labels)).mean()
        return xent, (out, mut)

    grad = jax.value_and_grad(loss, has_aux=True)
    (_, (out, mut)), g = (grad if train else jax.jit(grad))(
        variables["params"])
    return np.asarray(out), _numpy_tree(g), _numpy_tree(
        mut.get("batch_stats"))


def _port_loss_grads(model, x, labels, train, **kw):
    model.zero_grad(set_to_none=True)
    out = model(x, train=train, **kw)
    F.cross_entropy(out, torch.from_numpy(labels)).backward()
    return out.detach().numpy(), {n: p.grad for n, p in
                                  model.named_parameters()}


def _check_step(jmodel, variables, tmodel, carrier, x_nhwc, classes, train):
    labels = _labels(x_nhwc.shape[0], classes)
    want, jgrads, jstats = _jax_loss_grads(jmodel, variables,
                                           jnp.asarray(x_nhwc), labels, train)
    got, tgrads = _port_loss_grads(tmodel, _nchw(x_nhwc), labels, train)
    _close(got, want, "logits")
    assert (got.argmax(-1) == want.argmax(-1)).all()
    want_grads = carrier(jgrads)
    assert set(want_grads) == set(tgrads)
    for name, g in want_grads.items():
        _close(tgrads[name], g, f"grad {name}")
    if jstats is not None:
        state = tmodel.state_dict()
        for name, v in carrier({"batch_stats": jstats}).items():
            _close(state[name], v, f"batch_stats {name}")


def _port(cls_or_fn, variables, carrier, **kw):
    model = cls_or_fn(device="cpu", **kw)
    model.load_state_dict(carrier(_numpy_tree(variables)))
    return model


# --------------------------------------------------------------- MNIST


def test_mnist_eval_logits_and_grads():
    """The NHWC flatten: Dense_0's rows reordered by the carrier."""
    jm = j_mnist.MNISTConvNet()
    x = _images((3, 28, 28, 1))
    v = _variables(jm, jnp.asarray(x))
    tm = _port(t_mnist.MNISTConvNet, v, convert.mnist_params_from_flax)
    _check_step(jm, v, tm, convert.mnist_params_from_flax, x, 10,
                train=False)


def test_mnist_flatten_needs_the_reorder():
    """Without the carrier's reorder the NCHW flatten reads Dense_0's
    rows in the wrong order."""
    jm = j_mnist.MNISTConvNet()
    x = _images((2, 28, 28, 1))
    v = _variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = _port(t_mnist.MNISTConvNet, v, convert.cnn_params_from_flax)
    with torch.no_grad():
        got = tm(_nchw(x), train=False).numpy()
    assert np.abs(got - want).max() > 1e-2


# --------------------------------------------------------------- ResNet


def _small_resnet(stem):
    return dict(stage_sizes=(1, 1), num_classes=7, width=8, stem=stem)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stem", ["conv7", "space_to_depth"])
def test_resnet_small(stem, train):
    """Both stems; training mode normalises with the batch's statistics
    and updates batch_stats; gradients through batch norm."""
    kw = _small_resnet(stem)
    jm = j_resnet.ResNet(dtype=jnp.float32, **kw)
    x = _images((2, 32, 32, 3), seed=3)
    v = _variables(jm, jnp.asarray(x))
    tm = _port(t_resnet.ResNet, v, convert.cnn_params_from_flax,
               dtype=torch.float32, **kw)
    _check_step(jm, v, tm, convert.cnn_params_from_flax, x, 7, train)


@pytest.mark.usefixtures("one_thread")
def test_resnet50_eval_logits_and_grads():
    """ResNet-50 at full width, 64² images, in evaluation mode: every
    carried parameter and running statistic in use."""
    jm = j_resnet.ResNet50(num_classes=10, dtype=jnp.float32)
    x = _images((2, 64, 64, 3), seed=4)
    v = _variables(jm, jnp.asarray(x))
    tm = _port(t_resnet.ResNet50, v, convert.cnn_params_from_flax,
               num_classes=10, dtype=torch.float32)
    assert len(v["batch_stats"]) == 17  # the stem's and 16 blocks'

    _check_step(jm, v, tm, convert.cnn_params_from_flax, x, 10,
                train=False)


def test_resnet_stride2_padding_is_flax_same():
    """Each stage's first 3 × 3 stride-2 convolution pads (0, 1) on an
    even input, as XLA's 'SAME' does. With PyTorch's symmetric (1, 1)
    the output has the same size and other values, and the logits miss
    the JAX model's."""
    assert same_pads(16, 3, 2) == (0, 1)
    assert same_pads(15, 3, 2) == (1, 1)
    kw = _small_resnet("conv7")
    jm = j_resnet.ResNet(dtype=jnp.float32, **kw)
    x = _images((2, 32, 32, 3), seed=5)
    v = _variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = _port(t_resnet.ResNet, v, convert.cnn_params_from_flax,
               dtype=torch.float32, **kw)
    with torch.no_grad():
        _close(tm(_nchw(x), train=False).numpy(), want, "flax padding")
        strided = [m for m in tm.modules() if isinstance(m, Conv)
                   and m.kernel == (3, 3) and m.strides == (2, 2)]
        assert strided
        for m in strided:
            m.padding = [(1, 1), (1, 1)]
        sym = tm(_nchw(x), train=False).numpy()
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 1e-3


# --------------------------------------------------------------- VGG


def test_vgg16_eval_logits_and_grads():
    kw = dict(num_classes=13, classifier_width=64)
    jm = j_vgg.VGG16(dtype=jnp.float32, **kw)
    x = _images((2, 32, 32, 3), seed=6)
    v = _variables(jm, jnp.asarray(x))
    tm = _port(t_vgg.VGG16, v, convert.vgg_params_from_flax,
               dtype=torch.float32, image_size=32, **kw)
    assert len(list(tm.parameters())) == 32  # 13 convs + 3 dense
    _check_step(jm, v, tm, convert.vgg_params_from_flax, x, 13,
                train=False)


def test_dropout_needs_a_generator():
    tm = t_mnist.MNISTConvNet(device="cpu")
    x = torch.zeros(2, 1, 28, 28)
    with pytest.raises(ValueError, match="rng="):
        tm(x, train=True)
    g = torch.Generator().manual_seed(0)
    assert tm(x, train=True, rng=g).shape == (2, 10)


# --------------------------------------------------------------- Inception


@pytest.mark.usefixtures("one_thread")
def test_inception_v3_eval():
    """Full width at 75², the smallest input the stem takes, in
    evaluation mode: every block's ConvBN order, the counted avg-pool
    padding and the concatenation order."""
    jm = j_inception.InceptionV3(num_classes=11, dtype=jnp.float32)
    x = _images((2, 75, 75, 3), seed=7)
    v = _variables(jm, jnp.asarray(x))
    tm = _port(t_inception.InceptionV3, v,
               convert.cnn_params_from_flax, num_classes=11,
               dtype=torch.float32)
    n_params = sum(p.numel() for p in tm.parameters())
    assert 21.5e6 < n_params < 24.5e6, n_params
    _check_step(jm, v, tm, convert.cnn_params_from_flax, x, 11,
                train=False)


BLOCKS = {
    # name: (JAX block, port block, input channels, input side)
    "A": (lambda: j_inception.InceptionA(8, dtype=jnp.float32),
          lambda **kw: t_inception.InceptionA(12, 8, **kw), 12, 9),
    "B": (lambda: j_inception.InceptionB(dtype=jnp.float32),
          lambda **kw: t_inception.InceptionB(12, **kw), 12, 9),
    "C": (lambda: j_inception.InceptionC(16, dtype=jnp.float32),
          lambda **kw: t_inception.InceptionC(12, 16, **kw), 12, 7),
    "D": (lambda: j_inception.InceptionD(dtype=jnp.float32),
          lambda **kw: t_inception.InceptionD(12, **kw), 12, 9),
    "E": (lambda: j_inception.InceptionE(dtype=jnp.float32),
          lambda **kw: t_inception.InceptionE(12, **kw), 12, 4),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_inception_block_train(name):
    """Each Inception block alone in training mode: its output, the
    gradients of a fixed linear functional of it over every parameter,
    and the updated batch_stats."""
    make_j, make_t, c, side = BLOCKS[name]
    jm = make_j()
    x = _images((2, side, side, c), seed=9)
    v = _variables(jm, jnp.asarray(x))
    out_shape = jax.eval_shape(
        lambda: jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])[0]).shape
    w = _images(out_shape, seed=10)

    def loss(p):
        y, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return (y * w).sum(), (y, mut)

    (_, (want, mut)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    tm = make_t(dtype=torch.float32, sync=False, process_set=None,
                device="cpu", generator=None)
    tm.load_state_dict(convert.cnn_params_from_flax(_numpy_tree(v)))
    got = tm(_nchw(x), train=True)
    (got * _nchw(w)).sum().backward()
    _close(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
           "output")
    for key, g in convert.cnn_params_from_flax(
            _numpy_tree(jg)).items():
        _close(dict(tm.named_parameters())[key].grad, g, f"grad {key}")
    state = tm.state_dict()
    for key, val in convert.cnn_params_from_flax(
            {"batch_stats": _numpy_tree(mut["batch_stats"])}).items():
        _close(state[key], val, key)


# --------------------------------------------------------------- ViT


@pytest.mark.parametrize("flash_pad,flash_attention", [
    (False, False), (True, False), (True, True)])
def test_vit_tiny(flash_pad, flash_attention):
    """ViT tiny (17 tokens): unpadded; padded to 24 with lengths 17 on
    the dense path; padded through the flash path (the port's plain
    version on the CPU, the Pallas kernels in interpret mode)."""
    jcfg = dataclasses.replace(j_vit.ViTConfig.tiny(), flash_pad=flash_pad,
                               flash_attention=flash_attention)
    tcfg = dataclasses.replace(t_vit.ViTConfig.tiny(), flash_pad=flash_pad,
                               flash_attention=flash_attention)
    jm = j_vit.ViT(jcfg)
    x = _images((2, 32, 32, 3), seed=8)
    v = _variables(jm, jnp.asarray(x))
    carrier = lambda tree: convert.vit_params_from_flax(  # noqa: E731
        tree, tcfg.num_layers)
    tm = t_vit.ViT(tcfg, device="cpu")
    tm.load_state_dict(carrier(_numpy_tree(v)))
    assert tcfg.pads("cpu") == flash_pad
    _check_step(jm, v, tm, carrier, x, 10, train=False)


def test_vit_b16_shapes_and_auto_pad():
    cfg = t_vit.ViTConfig.b16()
    assert cfg.tokens == 197
    assert cfg.encoder_config().head_dim == 64
    assert cfg.pads("cuda") and not cfg.pads("cpu")  # "auto": flash only
    assert not dataclasses.replace(cfg, flash_pad=False).pads("cuda")
