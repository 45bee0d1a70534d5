"""Int8 quantization for the serving plane (port of
``quoracle_tpu/models/quant.py``).

Two independent byte economies, both opt-in per engine
(``GenerateEngine(quantize_weights=, quantize_kv=)``):

**Weights** — per-channel symmetric int8 applied at engine build
(:func:`quantize_params`): every projection keeps an ``int8`` payload and
one fp32 scale per OUTPUT channel. In the ``nn.Linear`` layout ([out, in])
that is one scale per ROW, the same numbers as the JAX package's scale
over axis -2 of its [in, out] leaves. :class:`QuantLinear` dequantizes on
every call (fp32 multiply, then a cast to the activation dtype, then
``F.linear``); the embedding keeps one scale per vocabulary row and
dequantizes only the rows it looks up (:class:`QuantEmbedding`). Norm
vectors and QKV biases stay dense.

**KV pages** — the session page pool stores int8 K/V with one fp32 scale
per (token, kv-head), in scale pools laid out ``[L, n_pages, KV, page]``
beside the ``[L, n_pages, page, KV, hd]`` pages, so a page's scales are
one contiguous block (for one KV head, 64 contiguous floats per 64-key
tile: what the ragged int8 kernel reads).

The quantization rule is shared by every write site, so requantizing an
unchanged page gives the same bytes: ``scale = amax(|x|) / 127`` (1.0 for
an all-zero vector), ``q = clip(round(x / scale), -127, 127)`` (round half
to even, as ``jnp.round``), all in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# fp32 scale per (token, kv-head), one for K and one for V
KV_SCALE_BYTES_PER_TOKEN_PER_HEAD = 8

# Layer projections quantized per output channel; norms and biases stay
# dense
LAYER_WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis of ``w`` [rows, n]: (int8 q8
    [rows, n], fp32 scale [rows]). The rule of the module docstring."""
    x = w.detach().float()
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


class QuantLinear(nn.Module):
    """An ``nn.Linear`` with an int8 weight: ``q8`` [out, in] and one fp32
    ``scale`` per output row (buffers), the bias (if any) dense."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[nn.Parameter] = None):
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("scale", scale)
        self.bias = bias

    @classmethod
    def quantize(cls, lin: nn.Linear) -> "QuantLinear":
        """Quantize a float ``nn.Linear``; its bias is shared, not
        copied."""
        return cls(*quantize_rows(lin.weight), lin.bias)

    def dequant(self, dtype: torch.dtype) -> torch.Tensor:
        """[out, in] weight: q8 · scale in fp32, then cast to ``dtype`` (a
        bf16 multiply would change bits)."""
        return (self.q8 * self.scale[:, None]).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.dequant(x.dtype), self.bias)


class QuantEmbedding(nn.Module):
    """An embedding table with int8 rows: ``q8`` [V, D] and one fp32
    ``scale_r`` per vocabulary row. The row scale is also the tied head's
    output-channel scale."""

    def __init__(self, q8: torch.Tensor, scale_r: torch.Tensor):
        super().__init__()
        self.register_buffer("q8", q8)
        self.register_buffer("scale_r", scale_r)

    @classmethod
    def quantize(cls, emb: nn.Embedding) -> "QuantEmbedding":
        return cls(*quantize_rows(emb.weight))

    def lookup(self, tokens: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
        """Dequantize only the looked-up rows -> [..., D] in ``dtype``."""
        t = tokens.long()
        return (self.q8[t] * self.scale_r[t][..., None]).to(dtype)

    def dequant(self, dtype: torch.dtype) -> torch.Tensor:
        return (self.q8 * self.scale_r[:, None]).to(dtype)


def is_quantized(m) -> bool:
    """True for a quantized weight module."""
    return isinstance(m, (QuantLinear, QuantEmbedding))


def dequant_weight(m, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One weight back to a dense [out, in] (or [V, D]) tensor: quantized
    modules dequantize, float ``nn.Linear``/``nn.Embedding`` pass their
    weight through."""
    if is_quantized(m):
        return m.dequant(dtype)
    return m.weight


@torch.no_grad()
def quantize_params(params, cfg):
    """A NEW ``Transformer`` whose embedding, layer projections and head
    are int8 (per-channel); norm weights and biases are shared with
    ``params``, which is left as it was. A model that is already
    quantized comes back as it is (engines may share one int8 copy)."""
    from quoracle_tpu_torch.models.transformer import Transformer
    if is_quantized(params.embed):
        return params
    out = Transformer(cfg, device="meta", dtype=params.dtype)
    out.embed = QuantEmbedding.quantize(params.embed)
    out.final_norm = params.final_norm
    for src, dst in zip(params.layers, out.layers):
        dst.attn_norm = src.attn_norm
        dst.mlp_norm = src.mlp_norm
        for key in LAYER_WEIGHT_KEYS:
            setattr(dst, key, QuantLinear.quantize(getattr(src, key)))
    if params.lm_head is not None:
        out.lm_head = QuantLinear.quantize(params.lm_head)
    return out


def params_nbytes(params: nn.Module) -> int:
    """Device bytes of a (possibly quantized) model: parameters and
    buffers, each shared tensor once."""
    seen, total = set(), 0
    for t in (*params.parameters(), *params.buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# KV page quantization
# ---------------------------------------------------------------------------

def kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV entries per (…, kv-head): ``x [..., KV, hd]`` -> (int8
    of the same shape, fp32 scale ``[..., KV]``)."""
    return quantize_rows(x)


def kv_dequant(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q [..., KV, hd]`` int8 and ``scale [..., KV]`` -> dense KV."""
    return (q.float() * scale[..., None].float()).to(dtype)


def gather_scales(scales: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """A layer's scale pool ``[n_pages, KV, page]`` gathered by a page
    table ``[B, maxp]`` -> token-major ``[B, maxp·page, KV]``, aligned
    with the gathered KV ``[B, maxp·page, KV, hd]``."""
    B, maxp = tables.shape
    _, KV, page = scales.shape
    s = scales[tables.long()]                      # [B, maxp, KV, page]
    return s.transpose(2, 3).reshape(B, maxp * page, KV)


def kv_token_bytes(n_layers: int, n_kv: int, head_dim: int,
                   pool_itemsize: int, quantized: bool) -> int:
    """Pool bytes of one token's K and V (scales included when
    quantized): the session budget's byte rate."""
    payload = 2 * n_layers * n_kv * head_dim * pool_itemsize
    if quantized:
        payload += n_layers * n_kv * KV_SCALE_BYTES_PER_TOKEN_PER_HEAD
    return payload
