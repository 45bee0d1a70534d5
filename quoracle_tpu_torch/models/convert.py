"""Weights bridge: the JAX package's params pytree -> the port's module.

The only way the parity tests hand both packages the same weights. The
input is the tree ``quoracle_tpu.models.transformer.init_params`` builds,
already pulled to host numpy (``jax.device_get``) — the port never sees a
JAX type. Layer leaves are stacked on a leading [L] axis there.

Layout convention, stated once: a JAX projection weight is [in, out]
(``x @ w``); an ``nn.Linear`` weight is [out, in] (``x @ w.T``), so every
projection is transposed here, and nowhere else. Embedding ([V, D]),
norm weights ([D]) and biases ([out]) keep their layout; an untied JAX
``lm_head`` [D, V] becomes the ``nn.Linear(D, V)`` weight [V, D].

A quantized tree (``quoracle_tpu.models.quant.quantize_params``) holds
``{"q8", "scale"}`` projection leaves (q8 [in, out], one scale per output
channel: transposed to a ``QuantLinear``'s [out, in] q8 with the same
scales) and a ``{"q8", "scale_r"}`` embedding (a ``QuantEmbedding``, no
transpose). A VLM's ``vision`` subtree becomes the model's tower through
``models/vision.vision_params_from_jax``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.quant import QuantEmbedding, QuantLinear
from quoracle_tpu_torch.models.transformer import Transformer
from quoracle_tpu_torch.models.vision import vision_params_from_jax

# JAX leaf name -> the Layer attribute it fills
LINEAR_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
BIAS_LEAVES = {"bq": "wq", "bk": "wk", "bv": "wv"}
NORM_LEAVES = ("attn_norm", "mlp_norm")


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: ModelConfig, device="cpu",
                    dtype: torch.dtype = torch.float32) -> Transformer:
    """Build the port's Transformer from a numpy params tree with the JAX
    package's structure (stacked [L, ...] layer leaves), on ``device`` in
    ``dtype`` (int8 payloads and fp32 scales for quantized leaves). A
    ``vision`` subtree (a VLM config) fills the model's tower."""
    if ("vision" in tree) != (cfg.vision is not None):
        raise ValueError(f"params_from_jax: the tree's vision subtree and "
                         f"{cfg.name!r}'s vision config must come together")
    device = torch.device(device)
    model = Transformer.empty(cfg, device, dtype)

    def put(dst: torch.Tensor, src) -> None:
        arr = np.array(src, dtype=np.float32)     # a writable copy
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_jax: leaf of shape {arr.shape} "
                             f"for a weight of shape {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    def quant(leaf: Mapping, transpose: bool) -> tuple:
        q8 = np.asarray(leaf["q8"], dtype=np.int8)
        scale = leaf["scale"] if transpose else leaf["scale_r"]
        q8 = np.array(q8.T if transpose else q8, order="C")   # a copy
        return (torch.from_numpy(q8).to(device),
                torch.from_numpy(np.array(scale, dtype=np.float32))
                .to(device))

    def linear(owner: torch.nn.Module, name: str, leaf) -> None:
        if isinstance(leaf, Mapping):     # the bias (filled below) stays
            setattr(owner, name, QuantLinear(*quant(leaf, transpose=True),
                                             getattr(owner, name).bias))
        else:
            put(getattr(owner, name).weight, np.asarray(leaf).T)

    layers = tree["layers"]
    if isinstance(tree["embed"], Mapping):
        model.embed = QuantEmbedding(*quant(tree["embed"], transpose=False))
    else:
        put(model.embed.weight, tree["embed"])
    for li, layer in enumerate(model.layers):
        for name in NORM_LEAVES:
            put(getattr(layer, name), layers[name][li])
        for name in LINEAR_LEAVES:
            leaf = layers[name]
            linear(layer, name, {k: v[li] for k, v in leaf.items()}
                   if isinstance(leaf, Mapping) else leaf[li])
        for name, lin in BIAS_LEAVES.items():
            if name in layers:
                put(getattr(layer, lin).bias, layers[name][li])
    put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        linear(model, "lm_head", tree["lm_head"])
    if cfg.vision is not None:
        model.vision = vision_params_from_jax(tree["vision"], cfg.vision,
                                              device, dtype)
    return model
