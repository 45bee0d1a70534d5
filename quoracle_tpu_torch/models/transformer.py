"""Decoder-only transformer forward pass in PyTorch (port of
``quoracle_tpu/models/transformer.py``).

One module serves every family in the catalog; the Llama/Mistral/Gemma/
Qwen quirks are ModelConfig data. Params live in the working dtype (bf16
serving, fp32 parity tests); norm, RoPE and softmax math run in fp32. The
layer stack is a ``ModuleList`` looped in Python. Where the JAX package
returns updated caches and page pools, the port writes them IN PLACE (the
memory the JAX jits buy back by donation) and returns the same tensors.

Weight layout: every projection is an ``nn.Linear``, whose weight is
[out, in]; the JAX params hold [in, out]. models/convert.py is the one
place that transposes between the two. A quantized model
(models/quant.quantize_params) holds ``QuantLinear`` projections in the
same places, so the call sites are shared, and a ``QuantEmbedding``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.quant import (
    dequant_weight, is_quantized, kv_quant,
)
from quoracle_tpu_torch.models.vision import VisionTower, init_vision_params
from quoracle_tpu_torch.ops.flash_attention import attend_auto
from quoracle_tpu_torch.ops.paged_attention import (
    DecodeStep, paged_prefill_merge, ragged_attend_auto,
)


class Layer(nn.Module):
    """One decoder block's weights."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        D, F_, H, KV, HD = (cfg.dim, cfg.ffn_dim, cfg.n_heads,
                            cfg.n_kv_heads, cfg.head_dim)
        self.attn_norm = nn.Parameter(torch.empty(D, **kw))
        self.wq = nn.Linear(D, H * HD, bias=cfg.attn_bias, **kw)
        self.wk = nn.Linear(D, KV * HD, bias=cfg.attn_bias, **kw)
        self.wv = nn.Linear(D, KV * HD, bias=cfg.attn_bias, **kw)
        self.wo = nn.Linear(H * HD, D, bias=False, **kw)
        self.mlp_norm = nn.Parameter(torch.empty(D, **kw))
        self.w_gate = nn.Linear(D, F_, bias=False, **kw)
        self.w_up = nn.Linear(D, F_, bias=False, **kw)
        self.w_down = nn.Linear(F_, D, bias=False, **kw)


class Transformer(nn.Module):
    """The whole decoder: embedding, layer stack, final norm, and the
    untied head (tied models project through the embedding); a VLM's
    vision tower (models/vision.py) rides along as ``vision``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.layers = nn.ModuleList(
            Layer(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.dim, **kw))
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw))
        if cfg.vision is not None:
            if cfg.vision.out_dim != cfg.dim:
                raise ValueError("the vision projector must target the "
                                 "decoder dim")
            self.vision = VisionTower(cfg.vision, **kw)
        else:
            self.vision = None
        self._head_f32: Optional[torch.Tensor] = None
        self._head_key: Optional[tuple] = None

    @classmethod
    def empty(cls, cfg: ModelConfig, device, dtype) -> "Transformer":
        """Allocated, uninitialized weights (no default init pass)."""
        return cls(cfg, device="meta", dtype=dtype).to_empty(device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.final_norm.dtype

    def head_f32(self) -> torch.Tensor:
        """[V, D] fp32 head weight for project_logits. The JAX package
        upcasts (or, quantized, dequantizes) the head to fp32 on every
        call; at llama-3-8b scale that re-reads and re-writes a 2.1 GB
        tensor per decode step, so the port does it ONCE and keeps the
        fp32 copy (2.1 GB of device memory) — the same fp32 product,
        without the per-step cast. The copy is made anew when the weight
        moves, is replaced, or is written in place (``copy_``,
        ``load_state_dict``: the tensor's version counter). fp32 models use
        their own weight."""
        head = self.embed if self.lm_head is None else self.lm_head
        w = head.q8 if is_quantized(head) else head.weight
        if w.dtype == torch.float32:
            return w
        key = (w.device, w.data_ptr(), w._version)
        if self._head_key != key:
            self._head_f32 = None            # free the old copy first
            self._head_f32 = dequant_weight(head, torch.float32).detach() \
                .float()
            self._head_key = key
        return self._head_f32


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, dtype=torch.bfloat16) -> Transformer:
    """Random-init weights (normal / sqrt(fan_in)), tests and smoke runs
    only. Draws in fp32 on the generator's device, then casts. Norm
    weights start at 1 (0 for plus-one norms), biases at 0; a vision
    tower is drawn after the decoder."""
    device = generator.device if device is None else torch.device(device)
    model = Transformer.empty(cfg, device, dtype)
    gen_dev = generator.device

    def normal_(p: torch.Tensor, fan_in: int) -> None:
        w = torch.randn(p.shape, generator=generator, device=gen_dev,
                        dtype=torch.float32) * fan_in ** -0.5
        p.copy_(w)

    norm_init = 0.0 if cfg.rmsnorm_plus_one else 1.0
    normal_(model.embed.weight, cfg.dim)
    for layer in model.layers:
        layer.attn_norm.fill_(norm_init)
        layer.mlp_norm.fill_(norm_init)
        for lin in (layer.wq, layer.wk, layer.wv, layer.wo, layer.w_gate,
                    layer.w_up, layer.w_down):
            normal_(lin.weight, lin.in_features)
            if lin.bias is not None:
                lin.bias.zero_()
    model.final_norm.fill_(norm_init)
    if model.lm_head is not None:
        normal_(model.lm_head.weight, cfg.dim)
    if cfg.vision is not None:
        init_vision_params(model.vision, generator)
    return model


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            plus_one: bool) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    wf = w.float()
    if plus_one:
        wf = 1.0 + wf
    return (normed * wf).to(x.dtype)


def _scale_rope_freqs(freqs: torch.Tensor,
                      scaling: Optional[tuple]) -> torch.Tensor:
    """HF-style rope_scaling of the inverse frequencies: ("linear", f) or
    ("llama3", factor, low_ff, high_ff, orig_max)."""
    if scaling is None:
        return freqs
    kind = scaling[0]
    if kind == "linear":
        return freqs / scaling[1]
    if kind == "llama3":
        _, factor, low_ff, high_ff, orig_max = scaling
        wavelen = 2.0 * math.pi / freqs
        low_wl = orig_max / low_ff
        high_wl = orig_max / high_ff
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        interp = (1.0 - smooth) * freqs / factor + smooth * freqs
        return torch.where(wavelen > low_wl, freqs / factor,
                           torch.where(wavelen < high_wl, freqs, interp))
    raise ValueError(f"unsupported rope scaling {kind!r}")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: Optional[tuple] = None) -> torch.Tensor:
    """Rotary embedding, half-split rotation. x: [B, T, heads, hd];
    positions: [B, T]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    freqs = _scale_rope_freqs(freqs, scaling)
    angles = positions.float()[:, :, None, None] * freqs     # [B,T,1,half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def _embed_lookup(params: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather; a quantized table dequantizes only the rows it
    looks up, into the dense leaves' dtype (``params.dtype``)."""
    if is_quantized(params.embed):
        x = params.embed.lookup(tokens, params.dtype)
    else:
        x = params.embed.weight[tokens.long()]
    if cfg.scale_embeddings:
        x = (x.float() * (cfg.dim ** 0.5)).to(x.dtype)
    return x


def _mlp(x: torch.Tensor, p: Layer, cfg: ModelConfig) -> torch.Tensor:
    """rmsnorm -> gate·up -> down, with the residual."""
    h = rmsnorm(x, p.mlp_norm, cfg.norm_eps, cfg.rmsnorm_plus_one)
    gate = _activation(p.w_gate(h), cfg.activation)
    return x + p.w_down(gate * p.w_up(h))


def _qkv(x: torch.Tensor, p: Layer, cfg: ModelConfig, B: int, T: int):
    """rmsnorm -> q/k/v projections (+ Qwen-style biases) in head layout."""
    h = rmsnorm(x, p.attn_norm, cfg.norm_eps, cfg.rmsnorm_plus_one)
    q = p.wq(h).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = p.wk(h).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = p.wv(h).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _wo(attn: torch.Tensor, p: Layer, cfg: ModelConfig) -> torch.Tensor:
    B, T = attn.shape[:2]
    return p.wo(attn.reshape(B, T, cfg.n_heads * cfg.head_dim))


@dataclasses.dataclass
class KVCache:
    """Dense per-model KV buffer. k/v: [L, B, S, n_kv, head_dim];
    lens: [B] int32 valid length per row."""
    k: torch.Tensor
    v: torch.Tensor
    lens: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> KVCache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lens=torch.zeros((batch,), dtype=torch.int32,
                                    device=device))


@torch.no_grad()
def forward_hidden(
    params: Transformer,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] int32
    positions: torch.Tensor,     # [B, T] int32 absolute positions
    cache: KVCache,
    write_offset: torch.Tensor,  # [B] int32: where this chunk's kv lands
    kv_lens: torch.Tensor,       # [B] int32 valid kv count AFTER the chunk
    kv_pos_offset: Optional[torch.Tensor] = None,   # [B] abs pos of idx 0
    input_embeds: Optional[torch.Tensor] = None,    # [B, T, D]
) -> tuple[torch.Tensor, KVCache]:
    """Run the stack over a token chunk, writing its KV into the dense
    cache in place; returns final hidden states [B, T, D] (pre-head) and
    the cache. The buffer is position-ordered, so right-padded rows leave
    garbage beyond ``kv_lens[b]`` that the attention mask ignores. The
    caller advances ``cache.lens``. ``input_embeds`` replaces the
    embedding lookup (a VLM row's spliced soft tokens): the caller hands
    them in fully prepared, and ``scale_embeddings`` is not applied
    again."""
    B, T = tokens.shape
    S = cache.k.shape[2]
    x = (_embed_lookup(params, cfg, tokens) if input_embeds is None
         else input_embeds)
    # start indices clamp into the buffer like lax.dynamic_update_slice
    start = torch.clamp(write_offset.long(), min=0, max=S - T)
    rows = torch.arange(B, device=tokens.device)[:, None]
    cols = start[:, None] + torch.arange(T, device=tokens.device)[None, :]
    for li, p in enumerate(params.layers):
        q, k, v = _qkv(x, p, cfg, B, T)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        k_buf, v_buf = cache.k[li], cache.v[li]       # [B, S, KV, hd] views
        k_buf[rows, cols] = k.to(k_buf.dtype)
        v_buf[rows, cols] = v.to(v_buf.dtype)
        # flash kernel for long prefill chunks on the GPU, dense
        # attend otherwise (decode steps, CPU)
        attn = attend_auto(q, k_buf, v_buf, positions, kv_len=kv_lens,
                           sliding_window=cfg.sliding_window,
                           kv_pos_offset=kv_pos_offset)
        x = x + _wo(attn, p, cfg)
        x = _mlp(x, p, cfg)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, cfg.rmsnorm_plus_one)
    return x, cache


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """Differentiable full-sequence forward for training (the JAX
    ``forward`` as ``models/train.loss_fn`` calls it: write offset 0,
    ``kv_lens`` = T): the stack of ``forward_hidden`` (the same
    ``_qkv``/``rope``/``attend_auto``/``_wo``/``_mlp``), attending over the
    chunk's own K/V with no cache, then fp32 logits [B, T, V] through a head
    upcast to fp32 WITH its gradient (``Transformer.head_f32`` keeps a
    detached copy for serving). On the card a chunk of 256 tokens or more
    runs the flash kernel forward and its backward kernel."""
    B, T = tokens.shape
    if is_quantized(params.embed) or (params.lm_head is not None
                                      and is_quantized(params.lm_head)):
        raise ValueError("forward: a quantized model does not train")
    kv_lens = torch.full((B,), T, dtype=torch.int32, device=tokens.device)
    x = _embed_lookup(params, cfg, tokens)
    for p in params.layers:
        q, k, v = _qkv(x, p, cfg, B, T)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        attn = attend_auto(q, k, v, positions, kv_len=kv_lens,
                           sliding_window=cfg.sliding_window)
        x = x + _wo(attn, p, cfg)
        x = _mlp(x, p, cfg)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, cfg.rmsnorm_plus_one)
    head = params.embed if params.lm_head is None else params.lm_head
    logits = F.linear(x.float(), head.weight.float())
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _kept_slots(flat_dst: torch.Tensor, n_tok: int):
    """The JAX scatters ``.at[flat_dst].set(mode="drop")`` silently drop
    out-of-range slots (the n_tok sentinel of padding and overflow
    tokens); a torch ``index_copy_`` would fault on them instead. Returns
    (source token indices, destination slots) of the kept tokens, chosen
    once per forward (one host sync) so that every layer copies only
    those."""
    flat = flat_dst.reshape(-1)
    src = torch.nonzero((flat >= 0) & (flat < n_tok))[:, 0]
    return src, flat[src].long()


@torch.no_grad()
def forward_hidden_paged(
    params: Transformer,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, 1] int32 (decode step)
    positions: torch.Tensor,     # [B, 1] int32 absolute positions
    k_pool: torch.Tensor,        # [L, n_pages, page, n_kv, hd], read-only
    v_pool: torch.Tensor,
    tables: torch.Tensor,        # [B, maxp] int32 page table
    pool_lens: torch.Tensor,     # [B] int32 valid pool tokens (fixed)
    kv_off: torch.Tensor,        # [B] int32 abs position of pool index 0
    tail_k: torch.Tensor,        # [L, B, Tmax, n_kv, hd], written in place
    tail_v: torch.Tensor,
    step: int,                   # tail slot this token writes
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode-step forward of the direct tier: attention reads the row's
    pages in place (ops/paged_attention.paged_decode_attend: the paged
    decode kernel on the card) merged with the dense tail of tokens
    generated this call. Every row writes tail slot ``step`` (done rows
    deposit junk there; the causal mask hides it behind their frozen
    q_pos). The step's index tensors (kernel meta, tail mask) are built
    once and shared by the layers. Returns (hidden [B, 1, D], tail_k,
    tail_v)."""
    B, T = tokens.shape
    shared = DecodeStep.build(tables, pool_lens, kv_off, step + 1,
                              positions[:, 0], tail_k.shape[2],
                              cfg.sliding_window)
    x = _embed_lookup(params, cfg, tokens)
    for li, p in enumerate(params.layers):
        q, k, v = _qkv(x, p, cfg, B, T)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        tk, tv = tail_k[li], tail_v[li]               # [B, Tmax, KV, hd]
        tk[:, step] = k[:, 0].to(tk.dtype)
        tv[:, step] = v[:, 0].to(tv.dtype)
        attn = shared.attend(q, k_pool[li], v_pool[li], tk, tv)
        x = x + _wo(attn.to(x.dtype), p, cfg)
        x = _mlp(x, p, cfg)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, cfg.rmsnorm_plus_one)
    return x, tail_k, tail_v


@torch.no_grad()
def forward_hidden_paged_prefill(
    params: Transformer,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, T] int32 right-padded suffix chunk
    positions: torch.Tensor,     # [B, T] int32 absolute positions
    k_pool: torch.Tensor,        # [L, n_pages, page, n_kv, hd], in place
    v_pool: torch.Tensor,
    src_tables: torch.Tensor,    # [B, maxp] pages of the resident prefix
    prefix_lens: torch.Tensor,   # [B] int32 resident pool tokens per row
    chunk_lens: torch.Tensor,    # [B] int32 valid chunk tokens per row
    flat_dst: torch.Tensor,      # [B, T] int32 flat pool slot per chunk
                                 # position; n_pages * page = drop
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill of the direct tier: the suffix chunk attends to the
    resident prefix straight off its pages
    (ops/paged_attention.paged_prefill_merge: the paged prefill kernel on
    the card) merged with dense causal intra-chunk attention; then the
    chunk's KV is copied into the rows' dst pages. Attention reads the
    pool BEFORE this layer's copy, as in the JAX package (the chunk sees
    itself through the dense piece). Returns (hidden [B, T, D], k_pool,
    v_pool) with the chunk KV written in place."""
    B, T = tokens.shape
    n_tok = k_pool.shape[1] * k_pool.shape[2]
    src, dst = _kept_slots(flat_dst, n_tok)
    x = _embed_lookup(params, cfg, tokens)
    for li, p in enumerate(params.layers):
        q, k, v = _qkv(x, p, cfg, B, T)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        k = k.to(k_pool.dtype)
        v = v.to(v_pool.dtype)
        attn = paged_prefill_merge(
            q, k, v, k_pool[li], v_pool[li], src_tables, prefix_lens,
            chunk_lens, sliding_window=cfg.sliding_window)
        kf = k_pool[li].view(n_tok, cfg.n_kv_heads, cfg.head_dim)
        vf = v_pool[li].view(n_tok, cfg.n_kv_heads, cfg.head_dim)
        kf.index_copy_(0, dst, k.reshape(B * T, *k.shape[2:])
                       .index_select(0, src))
        vf.index_copy_(0, dst, v.reshape(B * T, *v.shape[2:])
                       .index_select(0, src))
        x = x + _wo(attn.to(x.dtype), p, cfg)
        x = _mlp(x, p, cfg)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, cfg.rmsnorm_plus_one)
    return x, k_pool, v_pool


@torch.no_grad()
def forward_hidden_ragged(
    params: Transformer,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [1, Tp] int32 token-major flat batch
    positions: torch.Tensor,     # [1, Tp] int32 absolute positions
    k_pool: torch.Tensor,        # [L, n_pages, page, n_kv, hd], in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [NB, maxp] int32 owning row's pages
    block_meta: torch.Tensor,    # [NB, 3] int32: kv_len, qpos0, nq
    flat_dst: torch.Tensor,      # [Tp] int32 flat pool token slot per
                                 # token; n_pages * page = drop
    tq: int,
    k_scale: Optional[torch.Tensor] = None,   # [L, n_pages, KV, page] fp32
    v_scale: Optional[torch.Tensor] = None,   # (int8 pools), in place
) -> tuple:
    """Unified ragged forward: each layer writes the chunk's KV into the
    rows' pages FIRST, then attention streams each block's real pages
    (intra-chunk visibility is pure causal masking). Returns (hidden
    [1, Tp, D], k_pool, v_pool) with the chunk KV written in place; slots
    out of range drop (``_kept_slots``).

    With ``k_scale``/``v_scale`` the pools are int8: each layer quantizes
    the chunk's fresh post-RoPE K and V per (token, kv-head) in the
    activation dtype (models/quant.kv_quant), writes the payloads into the
    pages and the scales at ((pid·KV)+j)·page + off of the layer's scale
    pool, and the attention dequantizes as it reads (the int8 ragged
    kernel on the card). Returns (hidden, k_pool, v_pool, k_scale,
    v_scale)."""
    B, Tp = tokens.shape
    n_pages, page = k_pool.shape[1], k_pool.shape[2]
    n_tok = n_pages * page
    KV = cfg.n_kv_heads
    quant = k_scale is not None
    src, dst = _kept_slots(flat_dst, n_tok)
    if quant:
        # scale slot of kept token t, head j: ((pid·KV)+j)·page + off
        heads = torch.arange(KV, device=dst.device)
        sidx = (((dst // page)[:, None] * KV + heads[None, :]) * page
                + (dst % page)[:, None]).reshape(-1)
    x = _embed_lookup(params, cfg, tokens)
    for li, p in enumerate(params.layers):
        q, k, v = _qkv(x, p, cfg, B, Tp)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        kf = k_pool[li].view(n_tok, KV, cfg.head_dim)
        vf = v_pool[li].view(n_tok, KV, cfg.head_dim)
        k_new = k[0].index_select(0, src)
        v_new = v[0].index_select(0, src)
        if quant:
            for pool, spool, x_new in ((kf, k_scale[li], k_new),
                                       (vf, v_scale[li], v_new)):
                q8, s = kv_quant(x_new)            # [n, KV, hd], [n, KV]
                pool.index_copy_(0, dst, q8)
                spool.view(-1).index_copy_(0, sidx, s.reshape(-1))
            ks, vs = k_scale[li], v_scale[li]
        else:
            kf.index_copy_(0, dst, k_new.to(kf.dtype))
            vf.index_copy_(0, dst, v_new.to(vf.dtype))
            ks = vs = None
        attn = ragged_attend_auto(q[0], k_pool[li], v_pool[li],
                                  block_tables, block_meta, tq=tq,
                                  sliding_window=cfg.sliding_window,
                                  k_scale=ks, v_scale=vs)
        x = x + _wo(attn[None].to(x.dtype), p, cfg)
        x = _mlp(x, p, cfg)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps, cfg.rmsnorm_plus_one)
    if quant:
        return x, k_pool, v_pool, k_scale, v_scale
    return x, k_pool, v_pool


@torch.no_grad()
def project_logits(params: Transformer, cfg: ModelConfig,
                   hidden: torch.Tensor) -> torch.Tensor:
    """Final hidden states [..., D] -> fp32 logits [..., vocab]: the fp32
    product of the fp32 hidden state and the fp32 head (cast, or
    dequantized, once: Transformer.head_f32), then the optional soft cap. Callers gather the
    positions they need first: a full-sequence [B, T, 128256] fp32 tensor
    is never wanted."""
    logits = F.linear(hidden.float(), params.head_f32())
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
