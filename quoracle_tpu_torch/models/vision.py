"""Vision tower of a VLM member: a ViT encoder whose projected patches
enter the decoder as soft tokens (BASELINE config 5: image inputs -> VLM
member in the consensus pool). Port of ``quoracle_tpu/models/vision.py``.

``native/image.py`` preprocesses (PNG decode, resize, normalize to
[-1, 1]); ``vision_encode`` embeds the patches and runs a pre-LN ViT over
them; a linear projector maps the patch embeddings into the decoder's
embedding space. The decoder sees the image as ``n_patches`` placeholder
tokens whose embeddings ``splice_image_embeds`` replaces with the
projected patches (models/generate.py, the engine's VLM prefill).

The dtype path is the JAX package's: the patch embedding and the
position table in fp32, then the weights' dtype; each LayerNorm in fp32,
cast back; the attention scores, softmax and P·V in fp32; the
projections in the weights' dtype. The attention is non-causal over the
patches and runs as plain PyTorch: the JAX tower computes it with
einsums, outside any Pallas kernel.

Weight layout: every projection is an ``nn.Linear`` ([out, in]); the JAX
tree holds [in, out] leaves stacked on a leading [L] axis for its
``lax.scan``. ``vision_params_from_jax`` is the one place that transposes
and unstacks them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    ffn_dim: int = 1024
    out_dim: int = 2048           # decoder embedding dim
    norm_eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


class VisionLayer(nn.Module):
    """One pre-LN ViT block's weights."""

    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        D = cfg.dim
        self.ln1 = nn.Parameter(torch.empty(D, **kw))
        self.wqkv = nn.Linear(D, 3 * D, bias=False, **kw)
        self.wo = nn.Linear(D, D, bias=False, **kw)
        self.ln2 = nn.Parameter(torch.empty(D, **kw))
        self.w_up = nn.Linear(D, cfg.ffn_dim, bias=False, **kw)
        self.w_down = nn.Linear(cfg.ffn_dim, D, bias=False, **kw)


class VisionTower(nn.Module):
    """The tower's leaves: patch embedding, position table, the layer
    stack, the final LayerNorm and the projector into the decoder."""

    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.patch_embed = nn.Linear(cfg.patch_dim, cfg.dim, bias=False, **kw)
        self.pos_embed = nn.Parameter(torch.empty(cfg.n_patches, cfg.dim,
                                                  **kw))
        self.layers = nn.ModuleList(
            VisionLayer(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_ln = nn.Parameter(torch.empty(cfg.dim, **kw))
        self.projector = nn.Linear(cfg.dim, cfg.out_dim, bias=False, **kw)

    @classmethod
    def empty(cls, cfg: VisionConfig, device, dtype) -> "VisionTower":
        """Allocated, uninitialized weights (no default init pass)."""
        return cls(cfg, device="meta", dtype=dtype).to_empty(device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.final_ln.dtype


@torch.no_grad()
def init_vision_params(tower: VisionTower,
                       generator: torch.Generator) -> VisionTower:
    """Random weights into ``tower`` (normal / sqrt(fan_in), LayerNorms
    at 1), drawn in fp32 on the generator's device, then cast to the
    tower's dtype."""
    cfg = tower.cfg

    def normal_(p: torch.Tensor, fan_in: int) -> None:
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
                * fan_in ** -0.5)

    normal_(tower.patch_embed.weight, cfg.patch_dim)
    normal_(tower.pos_embed, cfg.dim)
    for layer in tower.layers:
        layer.ln1.fill_(1.0)
        layer.ln2.fill_(1.0)
        for lin in (layer.wqkv, layer.wo, layer.w_up, layer.w_down):
            normal_(lin.weight, lin.in_features)
    tower.final_ln.fill_(1.0)
    normal_(tower.projector.weight, cfg.dim)
    return tower


@torch.no_grad()
def vision_params_from_jax(tree: Mapping, cfg: VisionConfig, device="cpu",
                           dtype: torch.dtype = torch.float32
                           ) -> VisionTower:
    """The port's tower from the numpy leaves of the JAX package's
    ``init_vision_params`` tree (stacked [L, ...] layer leaves, [in, out]
    projections)."""
    tower = VisionTower.empty(cfg, torch.device(device), dtype)

    def put(dst: torch.Tensor, src, transpose: bool = False) -> None:
        arr = np.array(src, dtype=np.float32)     # a writable copy
        if transpose:
            arr = np.ascontiguousarray(arr.T)
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"vision_params_from_jax: leaf of shape "
                             f"{arr.shape} for a weight of shape "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    put(tower.patch_embed.weight, tree["patch_embed"], transpose=True)
    put(tower.pos_embed, tree["pos_embed"])
    layers = tree["layers"]
    for li, layer in enumerate(tower.layers):
        put(layer.ln1, layers["ln1"][li])
        put(layer.ln2, layers["ln2"][li])
        for name in ("wqkv", "wo", "w_up", "w_down"):
            put(getattr(layer, name).weight, layers[name][li],
                transpose=True)
    put(tower.final_ln, tree["final_ln"])
    put(tower.projector.weight, tree["projector"], transpose=True)
    return tower


def _ln(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without bias, computed in fp32 (population variance),
    cast back to the input's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] float -> [B, n_patches, patch*patch*3], patches in
    row-major order, each flattened (row, column, channel)."""
    B, H, W, C = pixels.shape
    ph, pw = H // patch, W // patch
    x = pixels.reshape(B, ph, patch, pw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, ph * pw, patch * patch * C)


@torch.no_grad()
def vision_encode(tower: VisionTower, cfg: VisionConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] (preprocessed, ~N(0, 1) channels) -> soft tokens
    [B, n_patches, out_dim] in the decoder's embedding space, in the
    tower's dtype."""
    dt = tower.dtype
    x = patchify(pixels.float(), cfg.patch_size)
    x = F.linear(x, tower.patch_embed.weight.float())
    x = (x + tower.pos_embed.float()[None]).to(dt)
    B, P, D = x.shape
    H, HD = cfg.n_heads, cfg.dim // cfg.n_heads
    for p in tower.layers:
        h = _ln(x, p.ln1, cfg.norm_eps)
        q, k, v = p.wqkv(h).split(D, dim=-1)
        q = q.reshape(B, P, H, HD).float()
        k = k.reshape(B, P, H, HD).float()
        v = v.reshape(B, P, H, HD).float()
        scores = torch.einsum("bphd,bqhd->bhpq", q, k) * (HD ** -0.5)
        probs = torch.softmax(scores, dim=-1)
        att = torch.einsum("bhpq,bqhd->bphd", probs, v).reshape(B, P, D)
        x = x + p.wo(att.to(dt))
        h = _ln(x, p.ln2, cfg.norm_eps)
        x = x + p.w_down(F.gelu(p.w_up(h), approximate="tanh"))
    x = _ln(x, tower.final_ln, cfg.norm_eps)
    return tower.projector(x)


def splice_image_embeds(embeds: torch.Tensor, tokens: torch.Tensor,
                        image_embeds: torch.Tensor,
                        image_token_id: int) -> torch.Tensor:
    """Replace the embeddings of image-placeholder tokens with projected
    patches. ``embeds`` [B, T, D]; ``image_embeds`` [B, P, D]; row b's
    i-th placeholder (in sequence order) takes patch i. Rows without
    placeholders pass through; placeholders beyond P clamp to the last
    patch."""
    mask = tokens == image_token_id                              # [B, T]
    idx = torch.clamp(torch.cumsum(mask.to(torch.int32), dim=1) - 1, 0,
                      image_embeds.shape[1] - 1).long()
    gathered = torch.gather(
        image_embeds, 1,
        idx[:, :, None].expand(-1, -1, image_embeds.shape[-1]))
    return torch.where(mask[:, :, None], gathered.to(embeds.dtype), embeds)
