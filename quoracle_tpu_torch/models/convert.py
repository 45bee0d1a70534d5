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
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.transformer import Transformer

# JAX leaf name -> the Layer attribute it fills
LINEAR_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
BIAS_LEAVES = {"bq": "wq", "bk": "wk", "bv": "wv"}
NORM_LEAVES = ("attn_norm", "mlp_norm")


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: ModelConfig, device="cpu",
                    dtype: torch.dtype = torch.float32) -> Transformer:
    """Build the port's Transformer from a numpy params tree with the JAX
    package's structure (stacked [L, ...] layer leaves), on ``device`` in
    ``dtype``. Quantized ({"q8", "scale"}) and vision leaves are later
    slices and raise."""
    if "vision" in tree:
        raise NotImplementedError("vision towers are not ported yet")
    model = Transformer.empty(cfg, torch.device(device), dtype)

    def put(dst: torch.Tensor, src) -> None:
        if isinstance(src, Mapping):
            raise NotImplementedError(
                "quantized weight leaves are not ported yet")
        arr = np.array(src, dtype=np.float32)     # a writable copy
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_jax: leaf of shape {arr.shape} "
                             f"for a weight of shape {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    layers = tree["layers"]
    put(model.embed.weight, tree["embed"])
    for li, layer in enumerate(model.layers):
        for name in NORM_LEAVES:
            put(getattr(layer, name), layers[name][li])
        for name in LINEAR_LEAVES:
            put(getattr(layer, name).weight, np.asarray(layers[name][li]).T)
        for name, lin in BIAS_LEAVES.items():
            if name in layers:
                put(getattr(layer, lin).bias, layers[name][li])
    put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head.weight, np.asarray(tree["lm_head"]).T)
    return model
