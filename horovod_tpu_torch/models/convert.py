"""Carry the JAX model's parameters into the port.

:func:`params_from_flax` takes the parameter tree of
``horovod_tpu.models.transformer.Transformer`` (``model.init(...)``'s
output, with or without its ``{"params": ...}`` wrapper) as nested dicts
of numpy arrays and returns the ``state_dict`` of
:class:`~.transformer.Transformer`. The port keeps the Flax shapes of
every kernel, so the mapping is by name only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .transformer import TransformerConfig


def params_from_flax(params, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """``state_dict`` (fp32 CPU tensors) for a port model of ``cfg``."""
    p = params.get("params", params) if isinstance(params, dict) else params
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, leaf) -> None:
        out[name] = torch.from_numpy(
            np.array(leaf, dtype=np.float32, copy=True)
        )

    def ln(name: str, node) -> None:
        put(f"{name}.weight", node["scale"])
        put(f"{name}.bias", node["bias"])

    def dense(name: str, node) -> None:
        put(f"{name}.kernel", node["kernel"])
        put(f"{name}.bias", node["bias"])

    put("embed.weight", p["Embed_0"]["embedding"])
    if not cfg.rope:
        put("pos_embed.weight", p["Embed_1"]["embedding"])
    for i in range(cfg.num_layers):
        blk = p[f"block_{i}"]
        pre = f"blocks.{i}"
        ln(f"{pre}.ln1", blk["LayerNorm_0"])
        ln(f"{pre}.ln2", blk["LayerNorm_1"])
        attn = blk["MultiHeadAttention_0"]
        names = ("q", "kv", "out") if cfg.num_kv_heads else ("qkv", "out")
        for name in names:
            dense(f"{pre}.attn.{name}", attn[name])
        dense(f"{pre}.fc1", blk["Dense_0"])
        dense(f"{pre}.fc2", blk["Dense_1"])
    ln("ln_f", p["LayerNorm_0"])
    dense("lm_head", p["lm_head"])
    return out
