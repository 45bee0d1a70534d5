"""Model catalog: architecture configs + serving metadata.

The PyTorch port's own copy of ``quoracle_tpu/models/config.py`` (the
port imports nothing from the JAX package); entries are identical so both
packages serve the same geometries under the same names.

Replaces the reference's LLMDB catalog (reference
lib/quoracle/models/llm_db_model_loader.ex) — context windows, output limits and
pricing lived in an external hex package there; here the catalog is the single
in-tree registry of models the TPU runtime can serve, keyed by the same
``provider:model`` spec format the reference uses (reference
lib/quoracle/models/local_model_helper.ex:13-19 is the precedent for an in-tree
provider bypass; ours is the ``xla:`` provider).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# the ViT geometry of a VLM member, defined beside its tower and
# re-exported here with the catalog that names it
from quoracle_tpu_torch.models.vision import VisionConfig

# Minimum room a consensus round must leave for the response (reference
# per_model_query.ex:17-18 — 4096 output floor). Effective per-model floor is
# min(OUTPUT_FLOOR, output_limit); shared by TPUBackend.query and
# TokenManager.dynamic_max_tokens so both layers agree on when a history
# "fits".
OUTPUT_FLOOR = 4096


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture + serving config for one decoder-only transformer.

    Covers the Llama/Mistral/Gemma/Qwen families (RMSNorm, RoPE, GQA/MQA,
    gated MLP). Per-family quirks are expressed as data, not subclasses, so a
    single traced forward function serves every family.
    """

    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_dim: int
    head_dim: Optional[int] = None  # defaults to dim // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    activation: str = "silu"  # "silu" (llama/mistral) or "gelu" (gemma)
    tie_embeddings: bool = False
    # Gemma multiplies token embeddings by sqrt(dim) (data, not code, per-family).
    scale_embeddings: bool = False
    # Gemma's RMSNorm computes (1 + w) * normed(x).
    rmsnorm_plus_one: bool = False
    # Sliding-window attention size (Mistral); None = full causal.
    sliding_window: Optional[int] = None
    # Optional logit soft-capping (Gemma-2 style); None = off.
    final_logit_softcap: Optional[float] = None
    # QKV projection biases (Qwen2-style).
    attn_bias: bool = False
    # RoPE frequency scaling, hashable: ("linear", factor) or
    # ("llama3", factor, low_freq_factor, high_freq_factor, original_max_pos).
    # None = unscaled. (Kept a tuple so ModelConfig stays hashable for jit.)
    rope_scaling: Optional[tuple] = None

    # --- serving metadata (what the reference pulled from LLMDB) ---
    context_window: int = 8192
    output_limit: int = 4096
    # Cost per 1M tokens (USD) for budget accounting parity with the
    # reference's cost pipeline; on-TPU serving is "free" but agents still
    # budget, so these are nominal accounting rates.
    input_cost_per_mtok: float = 0.05
    output_cost_per_mtok: float = 0.15
    eos_token_id: int = 2
    bos_token_id: int = 1
    # Additional stop ids beyond eos_token_id — llama-3-instruct style
    # checkpoints end chat turns with <|eot_id|> while config.eos lists
    # several ids; decode stops on ANY of {eos_token_id} | stop_token_ids.
    stop_token_ids: tuple = ()
    # HF checkpoint directory for real weights (models/loader.py); None =
    # random-init (tests/bench). The directory's tokenizer files are used too.
    checkpoint_path: Optional[str] = None
    # Recommended tensor-parallel width on a v5e-8 sub-mesh (must divide
    # n_kv_heads so KV shards carry whole GQA groups — parallel/mesh.py).
    # The pool-sizing math (parallel/mesh.py pool_sizing) turns this + the
    # param count into the explicit HBM budget VERDICT r4 item 4 asks for.
    recommended_tp: int = 1
    # VLM member (BASELINE config 5): an in-tree ViT tower whose projected
    # patches splice into the prompt at ``image_token_id`` placeholders
    # (models/vision.py). None = text-only model. VisionConfig is a frozen
    # dataclass, so ModelConfig stays hashable.
    vision: Optional[VisionConfig] = None
    image_token_id: Optional[int] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.dim // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, "GQA requires n_heads % n_kv_heads == 0"

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def n_params(self) -> int:
        """Exact decoder parameter count (embeddings + per-layer attn/mlp/
        norms + final norm + untied head) — the input to the HBM budget."""
        hd = self.head_dim
        embed = self.vocab_size * self.dim
        q = self.dim * self.n_heads * hd + (self.n_heads * hd
                                            if self.attn_bias else 0)
        kv = 2 * (self.dim * self.n_kv_heads * hd
                  + (self.n_kv_heads * hd if self.attn_bias else 0))
        o = self.n_heads * hd * self.dim
        mlp = 3 * self.dim * self.ffn_dim          # gate + up + down
        norms = 2 * self.dim
        per_layer = q + kv + o + mlp + norms
        head = 0 if self.tie_embeddings else self.vocab_size * self.dim
        total = embed + self.n_layers * per_layer + self.dim + head
        if self.vision is not None:
            # ViT tower + projector come out of the same HBM budget
            # (models/vision.py init_vision_params structure)
            v = self.vision
            v_layer = (2 * v.dim                    # ln1 + ln2
                       + v.dim * 3 * v.dim          # wqkv
                       + v.dim * v.dim              # wo
                       + 2 * v.dim * v.ffn_dim)     # w_up + w_down
            total += (v.patch_dim * v.dim           # patch_embed
                      + v.n_patches * v.dim         # pos_embed
                      + v.n_layers * v_layer
                      + v.dim                       # final_ln
                      + v.dim * v.out_dim)          # projector
        return total

    def kv_bytes_per_token(self, tp: int = 1, dtype_bytes: int = 2) -> int:
        """KV cache bytes per resident token PER TP SHARD (whole GQA
        groups per shard: kv heads divide across tp)."""
        return 2 * (self.n_kv_heads // tp) * self.head_dim * \
            self.n_layers * dtype_bytes


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register_model(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_model_config(spec: str) -> ModelConfig:
    """Look up by model spec. Accepts ``xla:name`` or bare ``name``.

    Mirrors the reference's ``provider:model`` spec parsing
    (reference lib/quoracle/models/model_query.ex model_spec format).
    """
    name = spec.split(":", 1)[1] if ":" in spec else spec
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {spec!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models() -> list[str]:
    return sorted(_REGISTRY)


# --- production-scale pool (the BASELINE.json north-star trio) ---

LLAMA3_8B = register_model(ModelConfig(
    name="llama-3-8b",
    vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, rope_theta=500000.0, norm_eps=1e-5,
    context_window=8192, output_limit=4096,
    eos_token_id=128001, bos_token_id=128000,
    # 8.0B params -> 16.1 GB bf16; tp=4 on a v5e-8 leaves ~4 GB/chip
    # weights + page pool + tail headroom (pool_sizing prints the table)
    recommended_tp=4,
))

MISTRAL_7B = register_model(ModelConfig(
    name="mistral-7b",
    vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, rope_theta=1000000.0, norm_eps=1e-5,
    context_window=32768, output_limit=8192, sliding_window=4096,
    # 7.2B params -> 14.5 GB bf16; tp=2 fits 7.3 GB/chip weights with the
    # 4096-token sliding window bounding resident KV per session
    recommended_tp=2,
))

GEMMA_7B = register_model(ModelConfig(
    name="gemma-7b",
    vocab_size=256000, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
    ffn_dim=24576, head_dim=256, rope_theta=10000.0, norm_eps=1e-6,
    activation="gelu", tie_embeddings=True, scale_embeddings=True,
    rmsnorm_plus_one=True,
    context_window=8192, output_limit=4096,
    # 8.5B params (tied embeddings) -> 17.1 GB bf16; tp=2 -> 8.5 GB/chip:
    # tight but fits with a reduced page pool (MHA KV is the pressure —
    # 16 kv heads x 256 head_dim; pool_sizing flags the headroom)
    recommended_tp=2,
))

# --- bench-scale models (fit a single v5e chip with headroom; same families) ---

LLAMA_1B = register_model(ModelConfig(
    name="llama-1b",
    vocab_size=32768, dim=2048, n_layers=16, n_heads=16, n_kv_heads=4,
    ffn_dim=5632, rope_theta=500000.0,
    context_window=8192, output_limit=4096,
))

MISTRAL_1B = register_model(ModelConfig(
    name="mistral-1b",
    vocab_size=32768, dim=2048, n_layers=16, n_heads=16, n_kv_heads=4,
    ffn_dim=5632, rope_theta=1000000.0, sliding_window=4096,
    context_window=16384, output_limit=4096,
))

GEMMA_1B = register_model(ModelConfig(
    name="gemma-1b",
    vocab_size=32768, dim=1792, n_layers=14, n_heads=14, n_kv_heads=14,
    ffn_dim=7168, head_dim=128, activation="gelu", tie_embeddings=True,
    scale_embeddings=True, rmsnorm_plus_one=True, norm_eps=1e-6,
    context_window=8192, output_limit=4096,
))

# --- tiny test models (CPU-mesh friendly; divisible by 2 and 4 for tp tests) ---

TINY = register_model(ModelConfig(
    name="tiny",
    vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=128, context_window=512, output_limit=128,
))

TINY_GEMMA = register_model(ModelConfig(
    name="tiny-gemma",
    vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
    ffn_dim=128, activation="gelu", tie_embeddings=True,
    scale_embeddings=True, rmsnorm_plus_one=True,
    context_window=512, output_limit=128,
))


def _tiny_vision():
    return VisionConfig(image_size=28, patch_size=14, dim=32, n_layers=1,
                        n_heads=2, ffn_dim=64, out_dim=64)


TINY_VLM = register_model(ModelConfig(
    name="tiny-vlm",
    vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=128, context_window=512, output_limit=128,
    vision=_tiny_vision(), image_token_id=3,
))

TINY_POOL = ["xla:tiny", "xla:tiny-gemma"]
BENCH_POOL = ["xla:llama-1b", "xla:mistral-1b", "xla:gemma-1b"]
NORTH_STAR_POOL = ["xla:llama-3-8b", "xla:mistral-7b", "xla:gemma-7b"]
