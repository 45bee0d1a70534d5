"""HF checkpoint loading: safetensors -> the port's ``Transformer``.

Port of ``quoracle_tpu/models/loader.py``. A checkpoint directory in the
standard HF layout (``config.json``, ``*.safetensors`` with an optional
``model.safetensors.index.json``, the tokenizer files) maps onto
models/transformer.py. HF stores every ``nn.Linear`` weight [out, in], the
layout the port's ``nn.Linear`` uses, so where the JAX loader transposes
each projection to [in, out] nothing is transposed here. Files are read by
models/safetensors_io.py (no ``safetensors`` or ``ml_dtypes``): each tensor
is viewed in the mapped file and copied straight into its weight on the
target device, so the host holds about one tensor at a time.

Supported architectures: LlamaForCausalLM, MistralForCausalLM,
GemmaForCausalLM, Qwen2ForCausalLM (the catalog's families). A
``vision_config`` (the in-tree VLM layout ``make_checkpoint``'s vlm family
writes, as the JAX loader reads it) adds the ViT tower: its weights sit
under ``vision_tower.*`` and ``multi_modal_projector.*`` and load into
the model's ``vision`` module (models/vision.py).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from quoracle_tpu_torch.models.config import ModelConfig, register_model
from quoracle_tpu_torch.models.generate import resolve_device
from quoracle_tpu_torch.models.safetensors_io import ShardedReader, save_file
from quoracle_tpu_torch.models.transformer import Transformer
from quoracle_tpu_torch.models.vision import VisionConfig

__all__ = [
    "config_from_hf", "export_hf_checkpoint", "load_checkpoint",
    "load_params", "register_hf_checkpoint",
]

# ---------------------------------------------------------------------------
# config.json -> ModelConfig
# ---------------------------------------------------------------------------

_FAMILY_DEFAULTS = {
    # architecture -> ModelConfig field overrides beyond the shared mapping
    "LlamaForCausalLM": {},
    "MistralForCausalLM": {},
    "Qwen2ForCausalLM": {"attn_bias": True},
    "GemmaForCausalLM": {
        "activation": "gelu",
        "tie_embeddings": True,
        "scale_embeddings": True,
        "rmsnorm_plus_one": True,
    },
}


def _ids(v) -> list[int]:
    """eos_token_id may be an int or a list (llama-3 style); normalize."""
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)]


def _rope_scaling(hf: dict) -> Optional[tuple]:
    """HF rope_scaling -> the hashable ModelConfig form; an unmapped
    scheme raises rather than computing wrong frequencies."""
    rs = hf.get("rope_scaling")
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind in ("default", None):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]),
                float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)),
                int(rs.get("original_max_position_embeddings", 8192)))
    raise ValueError(
        f"unsupported rope_scaling type {kind!r} — supported: default, "
        "linear, llama3")


def config_from_hf(hf: dict, name: str,
                   checkpoint_path: Optional[str] = None) -> ModelConfig:
    """Map a HF config.json dict onto the catalog's ModelConfig."""
    archs = hf.get("architectures") or []
    arch = archs[0] if archs else "LlamaForCausalLM"
    if arch not in _FAMILY_DEFAULTS:
        raise ValueError(
            f"unsupported architecture {arch!r}; supported: "
            f"{sorted(_FAMILY_DEFAULTS)}")
    over = dict(_FAMILY_DEFAULTS[arch])

    n_heads = hf["num_attention_heads"]
    kv = hf.get("num_key_value_heads") or n_heads
    act = hf.get("hidden_act", "silu")
    if act in ("gelu", "gelu_pytorch_tanh", "gelu_new"):
        over["activation"] = "gelu"
    elif act == "silu":
        over.setdefault("activation", "silu")
    else:
        raise ValueError(f"unsupported hidden_act {act!r}")
    if hf.get("tie_word_embeddings"):
        over["tie_embeddings"] = True
    if hf.get("attention_bias"):
        over["attn_bias"] = True

    window = int(hf.get("max_position_embeddings", 8192))
    eos_ids = _ids(hf.get("eos_token_id"))
    bos_ids = _ids(hf.get("bos_token_id"))
    # Qwen2-style configs keep sliding_window set while disabling it
    sliding = hf.get("sliding_window")
    if hf.get("use_sliding_window") is False:
        sliding = None
    # a ``vision_config`` marks the in-tree ViT tower (models/vision.py),
    # whose weights live under vision_tower.* / multi_modal_projector.*
    vision = None
    image_token_id = None
    vc = hf.get("vision_config")
    if vc:
        vision = VisionConfig(
            image_size=vc["image_size"],
            patch_size=vc["patch_size"],
            dim=vc["hidden_size"],
            n_layers=vc["num_hidden_layers"],
            n_heads=vc["num_attention_heads"],
            ffn_dim=vc["intermediate_size"],
            out_dim=hf["hidden_size"],
        )
        if hf.get("image_token_id") is None:
            raise ValueError(
                "vision_config present but no image_token_id — the prompt "
                "builder cannot place soft tokens without it")
        image_token_id = int(hf["image_token_id"])
    return ModelConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=kv,
        ffn_dim=hf["intermediate_size"],
        head_dim=hf.get("head_dim"),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=_rope_scaling(hf),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        sliding_window=sliding,
        context_window=window,
        output_limit=min(4096, window),
        # 0 is a legitimate token id: explicit emptiness checks
        eos_token_id=eos_ids[0] if eos_ids else 2,
        stop_token_ids=tuple(eos_ids[1:]),
        bos_token_id=bos_ids[0] if bos_ids else 1,
        checkpoint_path=checkpoint_path,
        vision=vision,
        image_token_id=image_token_id,
        **over,
    )


# ---------------------------------------------------------------------------
# safetensors <-> Transformer
# ---------------------------------------------------------------------------

_LAYER_LEAVES = {
    # HF name under "layers.{i}." -> (Layer attribute, its tensor)
    "input_layernorm.weight": ("attn_norm", None),
    "self_attn.q_proj.weight": ("wq", "weight"),
    "self_attn.k_proj.weight": ("wk", "weight"),
    "self_attn.v_proj.weight": ("wv", "weight"),
    "self_attn.o_proj.weight": ("wo", "weight"),
    "post_attention_layernorm.weight": ("mlp_norm", None),
    "mlp.gate_proj.weight": ("w_gate", "weight"),
    "mlp.up_proj.weight": ("w_up", "weight"),
    "mlp.down_proj.weight": ("w_down", "weight"),
}
_BIAS_LEAVES = {
    "self_attn.q_proj.bias": ("wq", "bias"),
    "self_attn.k_proj.bias": ("wk", "bias"),
    "self_attn.v_proj.bias": ("wv", "bias"),
}
# the ViT tower's tensors under "vision_tower.layers.{i}." -> (VisionLayer
# attribute, its tensor)
_VISION_LAYER_LEAVES = {
    "ln1.weight": ("ln1", None),
    "attn.qkv_proj.weight": ("wqkv", "weight"),
    "attn.o_proj.weight": ("wo", "weight"),
    "ln2.weight": ("ln2", None),
    "mlp.up_proj.weight": ("w_up", "weight"),
    "mlp.down_proj.weight": ("w_down", "weight"),
}
# tensors a checkpoint may carry that the model derives itself: rotary
# tables some older exports saved
_DERIVED = ("rotary_emb.inv_freq",)


def hf_tensors(model: Transformer, cfg: ModelConfig,
               prefix: str = "model.") -> dict[str, torch.Tensor]:
    """{HF tensor name: the model's tensor} (views, no copies): the one
    place the port's module names meet the HF names. ``prefix`` is the
    decoder's ("model." in every export; some files omit it); an untied
    ``lm_head`` sits at the top level either way."""
    out = {prefix + "embed_tokens.weight": model.embed.weight,
           prefix + "norm.weight": model.final_norm}
    leaves = dict(_LAYER_LEAVES, **(_BIAS_LEAVES if cfg.attn_bias else {}))
    for i, layer in enumerate(model.layers):
        for hf, (attr, part) in leaves.items():
            obj = getattr(layer, attr)
            out[f"{prefix}layers.{i}.{hf}"] = (
                obj if part is None else getattr(obj, part))
    if model.lm_head is not None:
        out["lm_head.weight"] = model.lm_head.weight
    return out


def vision_hf_tensors(model: Transformer) -> dict[str, torch.Tensor]:
    """{tensor name: the tower's tensor} of a VLM (views): the in-tree
    layout the JAX loader reads; {} for a text-only model."""
    tower = model.vision
    if tower is None:
        return {}
    out = {"vision_tower.patch_embed.weight": tower.patch_embed.weight,
           "vision_tower.pos_embed": tower.pos_embed,
           "vision_tower.final_ln.weight": tower.final_ln,
           "multi_modal_projector.weight": tower.projector.weight}
    for i, layer in enumerate(tower.layers):
        for name, (attr, part) in _VISION_LAYER_LEAVES.items():
            obj = getattr(layer, attr)
            out[f"vision_tower.layers.{i}.{name}"] = (
                obj if part is None else getattr(obj, part))
    return out


@torch.no_grad()
def load_params(path: str, cfg: ModelConfig, device=None,
                dtype: torch.dtype = torch.bfloat16) -> Transformer:
    """Read a HF checkpoint directory into a ``Transformer`` on ``device``
    (None: the card) in ``dtype``. Every weight is filled from the file,
    a VLM's tower too; a missing tensor, a shape that differs from the
    config, or a tensor the model would not use raises."""
    device = resolve_device(device)
    reader = ShardedReader(path)
    try:
        names = reader.names()
        # some exports drop the decoder's "model." prefix
        prefix = "model." if "model.embed_tokens.weight" in names else ""
        model = Transformer.empty(cfg, device, dtype)
        wanted = {**hf_tensors(model, cfg, prefix),
                  **vision_hf_tensors(model)}
        extra = sorted(n for n in names - set(wanted)
                       if not n.endswith(_DERIVED)
                       and not (cfg.tie_embeddings and n == "lm_head.weight"))
        if extra:
            raise ValueError(f"checkpoint {path!r} holds tensors the model "
                             f"{cfg.name!r} does not use: {extra[:8]}")
        for name, dst in wanted.items():
            src = reader.get(name)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"checkpoint {path!r}: {name} has shape "
                    f"{tuple(src.shape)}, the config {cfg.name!r} wants "
                    f"{tuple(dst.shape)}")
            dst.copy_(src)           # casts; host -> device straight in
            del src
    finally:
        reader.close()
    return model


def export_hf_checkpoint(model: Transformer, cfg: ModelConfig, out_dir: str,
                         base_dir: str) -> str:
    """Inverse of ``load_params``: the model's weights -> ``out_dir`` as an
    HF checkpoint (``model.safetensors`` under the HF names, bf16,
    metadata {"format": "pt"}), with ``config.json`` and the tokenizer
    files copied from ``base_dir`` and ``.complete`` written last. Text
    decoder only, as the JAX export. Each tensor reaches the host only
    while it is written."""
    os.makedirs(out_dir, exist_ok=True)
    for fn in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        src = os.path.join(base_dir, fn)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(out_dir, fn))
    tensors = {name: t.detach().to(torch.bfloat16)
               for name, t in hf_tensors(model, cfg).items()}
    save_file(tensors, os.path.join(out_dir, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(out_dir, ".complete"), "w") as f:
        f.write("ok\n")
    return out_dir


def _read_config(path: str, name: Optional[str]) -> ModelConfig:
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    return config_from_hf(hf, name or os.path.basename(os.path.normpath(path)),
                          checkpoint_path=path)


def load_checkpoint(path: str, name: Optional[str] = None, device=None,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[ModelConfig, Transformer]:
    """config.json + safetensors -> (ModelConfig, Transformer)."""
    cfg = _read_config(path, name)
    return cfg, load_params(path, cfg, device=device, dtype=dtype)


def register_hf_checkpoint(path: str, name: Optional[str] = None
                           ) -> ModelConfig:
    """Register a checkpoint directory in the port's catalog as
    ``xla:<name>``. Weights load when an engine is built (TorchBackend
    reads ``cfg.checkpoint_path``), not here. ``runtime.Runtime`` calls
    this for each of ``RuntimeConfig.checkpoints``."""
    return register_model(_read_config(path, name))
