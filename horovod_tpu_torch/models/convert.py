"""Carry the JAX models' parameters into the port.

Each function takes a Flax variable tree (``model.init(...)``'s output,
as nested dicts of numpy arrays, with or without its ``{"params":
...}`` wrapper) and returns the ``state_dict`` of the port's model, as
fp32 CPU tensors:

* :func:`params_from_flax`: ``horovod_tpu.models.transformer.
  Transformer``. The port keeps the Flax shape of every kernel, so the
  mapping is by name;
* :func:`cnn_params_from_flax` (ResNet, Inception V3, whose trees map
  as they are) and :func:`mnist_params_from_flax`,
  :func:`vgg_params_from_flax` (which name the dense layer after the
  flatten): the convolutional zoo, whose port modules keep Flax's names
  (``models/layers.py``). Convolution kernels go from HWIO to OIHW,
  LayerNorm and batch norm scales become ``weight``, and the
  ``batch_stats`` collection becomes the ``running_mean``/
  ``running_var`` buffers. The JAX models flatten NHWC before their
  first dense layer and the port flattens NCHW, so that layer's rows
  are reordered from (h, w, c) to (c, h, w);
* :func:`vit_params_from_flax`: ``horovod_tpu.models.vit.ViT``, whose
  encoder blocks map as the Transformer's;
* :func:`parallel_params_from_jax`: the composed model of
  ``horovod_tpu/parallel/transformer.py``, from its full (unsharded)
  parameter tree to this rank's shards on a mesh;
* :func:`shard_state_dict`: a whole Transformer ``state_dict`` (from
  :func:`params_from_flax`, or a model's own) to this rank's shard of a
  serving mesh, what ``Transformer(cfg, mesh=)`` loads.

A tree of the same layout maps the same way: a JAX gradient tree
(``jax.grad`` of a loss over the parameters) becomes the port's
gradients by parameter name, which is how the tests compare a training
step name by name.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .transformer import TransformerConfig


def _params(tree):
    return tree.get("params", tree) if isinstance(tree, dict) else tree


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, dtype=np.float32, copy=True))


def _block(out, pre: str, blk, gqa: bool) -> None:
    """One Transformer ``Block`` (``block_i``) into ``out`` under
    ``pre``."""
    for name, node in (("ln1", blk["LayerNorm_0"]),
                       ("ln2", blk["LayerNorm_1"])):
        out[f"{pre}.{name}.weight"] = _tensor(node["scale"])
        out[f"{pre}.{name}.bias"] = _tensor(node["bias"])
    attn = blk["MultiHeadAttention_0"]
    dense = [(f"attn.{n}", attn[n])
             for n in (("q", "kv", "out") if gqa else ("qkv", "out"))]
    if "moe" in blk:  # the MoE bank in place of the dense FFN
        moe = blk["moe"]
        dense.append(("moe.router", moe["router"]))
        for name in ("w1", "b1", "w2", "b2"):
            out[f"{pre}.moe.{name}"] = _tensor(moe[name])
    else:
        dense += [("fc1", blk["Dense_0"]), ("fc2", blk["Dense_1"])]
    for name, node in dense:
        out[f"{pre}.{name}.kernel"] = _tensor(node["kernel"])
        out[f"{pre}.{name}.bias"] = _tensor(node["bias"])


def params_from_flax(params, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """``state_dict`` (fp32 CPU tensors) for a port model of ``cfg``."""
    p = _params(params)
    out: Dict[str, torch.Tensor] = {}
    out["embed.weight"] = _tensor(p["Embed_0"]["embedding"])
    if not cfg.rope:
        out["pos_embed.weight"] = _tensor(p["Embed_1"]["embedding"])
    for i in range(cfg.num_layers):
        _block(out, f"blocks.{i}", p[f"block_{i}"], bool(cfg.num_kv_heads))
    out["ln_f.weight"] = _tensor(p["LayerNorm_0"]["scale"])
    out["ln_f.bias"] = _tensor(p["LayerNorm_0"]["bias"])
    out["lm_head.kernel"] = _tensor(p["lm_head"]["kernel"])
    out["lm_head.bias"] = _tensor(p["lm_head"]["bias"])
    return out


# a Transformer leaf sharded over tp: (name in its block, axis cut)
_TP_CUTS = {
    "attn.qkv.kernel": 2,  # [d, 3, h, hd]
    "attn.qkv.bias": 1,  # [3, h, hd]
    "attn.q.kernel": 1,  # [d, h, hd]
    "attn.q.bias": 0,  # [h, hd]
    "attn.kv.kernel": 2,  # [d, 2, kvh, hd]
    "attn.kv.bias": 1,  # [2, kvh, hd]
    "attn.out.kernel": 0,  # [h, hd, d]: row-parallel, the bias whole
    "fc1.kernel": 1,  # [d, f]: column-parallel
    "fc1.bias": 0,
    "fc2.kernel": 0,  # [f, d]: row-parallel, the bias whole
}


def shard_state_dict(state: Dict[str, torch.Tensor], cfg: TransformerConfig,
                     mesh, tp_axis: str = "tp", ep_axis: str = "ep"
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a whole Transformer ``state_dict`` on
    ``mesh``: over ``tp_axis`` the attention heads (the ``[d, 3, h, hd]``,
    ``[d, h, hd]`` and ``[d, 2, kvh, hd]`` kernels and their biases),
    ``out.kernel``'s ``[h, hd, d]`` rows, ``fc1`` by columns and ``fc2``
    by rows (rank ``i`` the ``i``-th contiguous run); over ``ep_axis``
    the expert banks (:func:`~.transformer.shard_moe_params`). Every
    other leaf is the whole one. Raises ``ValueError`` when an axis does
    not divide what it cuts."""
    from .transformer import axis_share, mesh_axis, shard_moe_params

    tp = mesh_axis(mesh, tp_axis)
    out = dict(state)
    if tp is not None:
        axis_share(cfg.num_heads, tp, "head count")
        axis_share(cfg.kv_heads, tp, "kv head count")
        if not cfg.moe_experts:  # the expert banks are not cut over tp
            axis_share(cfg.d_ff, tp, "d_ff")
        for key, leaf in state.items():
            parts = key.split(".")
            axis = _TP_CUTS.get(".".join(parts[2:]))
            if parts[0] != "blocks" or axis is None:
                continue
            n = leaf.shape[axis] // tp.size
            out[key] = leaf.narrow(axis, tp.index * n, n).contiguous()
    return shard_moe_params(out, mesh, ep_axis)


_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _walk(out, prefix: str, node) -> None:
    for name, child in node.items():
        if isinstance(child, dict):
            _walk(out, f"{prefix}{name}.", child)
            continue
        leaf = np.asarray(child, dtype=np.float32)
        if name == "kernel" and leaf.ndim == 4:  # HWIO -> OIHW
            out[f"{prefix}weight"] = _tensor(leaf.transpose(3, 2, 0, 1))
        else:
            out[f"{prefix}{_LEAF.get(name, name)}"] = _tensor(leaf)


def cnn_params_from_flax(variables, flatten_dense: Optional[str] = None,
                         channels: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
    """``state_dict`` of a convolutional zoo model from its Flax
    variables (``params`` and, where the model has batch norm,
    ``batch_stats``; a bare parameter or gradient tree works too).
    ``flatten_dense`` names the dense layer after the flatten, whose
    rows go from (h, w, ``channels``) order to (``channels``, h, w),
    over a square grid."""
    out: Dict[str, torch.Tensor] = {}
    if "params" in variables or "batch_stats" in variables:
        for collection in ("params", "batch_stats"):
            _walk(out, "", variables.get(collection, {}))
    else:
        _walk(out, "", variables)
    if flatten_dense is not None:
        key = f"{flatten_dense}.kernel"
        k = out[key]
        side = int(round((k.shape[0] // channels) ** 0.5))
        out[key] = (k.reshape(side, side, channels, -1).permute(2, 0, 1, 3)
                    .reshape(k.shape).contiguous())
    return out


def mnist_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """:class:`~.mnist.MNISTConvNet`: the flatten meets ``Dense_0`` over
    20 channels."""
    return cnn_params_from_flax(variables, "Dense_0", 20)


def vgg_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """:class:`~.vgg.VGG`: the flatten meets ``Dense_0`` over the last
    stage's channels."""
    p = _params(variables)
    convs = sorted((k for k in p if k.startswith("Conv_")),
                   key=lambda k: int(k.split("_")[1]))
    channels = np.asarray(p[convs[-1]]["kernel"]).shape[-1]
    return cnn_params_from_flax(variables, "Dense_0", channels)


def vit_params_from_flax(params, num_layers: int) -> Dict[str, torch.Tensor]:
    """:class:`~.vit.ViT` from ``horovod_tpu.models.vit.ViT``."""
    p = _params(params)
    out: Dict[str, torch.Tensor] = {}
    _walk(out, "patchify.", p["patchify"])
    out["cls"] = _tensor(p["cls"])
    out["pos_embed"] = _tensor(p["pos_embed"])
    for i in range(num_layers):
        _block(out, f"blocks.{i}", p[f"block_{i}"], gqa=False)
    out["ln.weight"] = _tensor(p["LayerNorm_0"]["scale"])
    out["ln.bias"] = _tensor(p["LayerNorm_0"]["bias"])
    _walk(out, "head.", p["head"])
    return out


def parallel_params_from_jax(full, cfg, mesh, device=None):
    """This rank's shards of the composed model's parameters
    (:mod:`..parallel.transformer`) from the JAX package's full tree
    (``_init_full_params``, or a trained tree gathered to the host, as
    nested dicts of numpy arrays; the MoE leaf a ``MoEParams`` or a
    dict), cut by ``param_specs`` for ``mesh``, as fp32 masters on
    ``device`` (the card unless ``"cpu"`` is passed)."""
    from ..common.config import resolve_device
    from ..parallel.moe import MoEParams
    from ..parallel.transformer import shard_params

    dev = resolve_device(device)

    def leaf(x):
        return torch.from_numpy(np.array(x, dtype=np.float32,
                                         copy=True)).to(dev)

    tree = {group: {k: leaf(v) for k, v in full[group].items()
                    if k != "moe"}
            for group in ("embed", "stages", "tail")}
    moe = full["tail"]["moe"]
    fields = moe._asdict() if hasattr(moe, "_asdict") else moe
    tree["tail"]["moe"] = MoEParams(**{k: leaf(fields[k])
                                       for k in MoEParams._fields})
    return shard_params(tree, cfg, mesh)
