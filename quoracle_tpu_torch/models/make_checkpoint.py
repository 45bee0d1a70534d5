"""Local HF-format checkpoint factory (port of
``quoracle_tpu/models/make_checkpoint.py``).

Machines without network cannot download released checkpoints, yet the
checkpoint path (models/loader.py -> HFAutoTokenizer -> TorchBackend) must
run end to end. This module writes checkpoints in the standard HF layout
offline:

  * ``config.json``       per-family HF config (Llama/Mistral/Gemma);
  * ``model.safetensors`` bf16 weights under the HF tensor names, drawn
    with fan-in scaling from the JAX module's ``torch.Generator``
    sequence, so the tensors are bit-identical to the JAX module's;
    written by models/safetensors_io.py;
  * ``tokenizer.json``    a byte-level BPE tokenizer;
  * ``tokenizer_config.json`` special tokens and a chat template.

One deliberate difference: the JAX module trains its BPE with the
``tokenizers`` library on this repository's files, and the port has no
such library. ``make_tokenizer_files`` instead serialises the port's
committed byte-level BPE (``bpe_merges.txt``) as an HF ``tokenizer.json``:
the specials first, then the 256 byte symbols in GPT-2's byte-to-unicode
alphabet, then the merges in rank order, cut to ``vocab_size``, with a
``ByteLevel`` pre-tokenizer and decoder. ``tokenizers`` reads that file
and encodes it exactly as models/tokenizer.py's ``HFTokenizer`` does
(tests/test_torch_hf_tokenizer.py); the ids differ from the learned BPE's
own, whose pre-split is not GPT-2's. The files depend on nothing but the
committed merges, so the same checkpoint comes out on every machine.

Usage:
    python -m quoracle_tpu_torch.models.make_checkpoint --out checkpoints/ \
        --families llama,mistral,gemma --scale 1b
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from quoracle_tpu_torch.models.safetensors_io import save_file
from quoracle_tpu_torch.models.tokenizer_pipeline import byte_chars
from quoracle_tpu_torch.native.tokenizer import _python_tables

SPECIALS = ["<|pad|>", "<|bos|>", "<|eos|>", "<|system|>", "<|user|>",
            "<|assistant|>", "<|image|>"]
CHAT_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "<|{{ message['role'] }}|>\n{{ message['content'] }}\n"
    "{% endfor %}{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
)

# HF config.json skeletons per family and scale, the JAX module's: "1b"
# matches the catalog's bench models (llama-1b / mistral-1b / gemma-1b)
FAMILY_CONFIGS = {
    "1b": {
        "llama": dict(
            architectures=["LlamaForCausalLM"], vocab_size=32768,
            hidden_size=2048, intermediate_size=5632, num_hidden_layers=16,
            num_attention_heads=16, num_key_value_heads=4,
            max_position_embeddings=8192, rope_theta=500000.0,
            rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False),
        "mistral": dict(
            architectures=["MistralForCausalLM"], vocab_size=32768,
            hidden_size=2048, intermediate_size=5632, num_hidden_layers=16,
            num_attention_heads=16, num_key_value_heads=4,
            max_position_embeddings=16384, rope_theta=1000000.0,
            rms_norm_eps=1e-5, hidden_act="silu", sliding_window=4096,
            tie_word_embeddings=False),
        "gemma": dict(
            architectures=["GemmaForCausalLM"], vocab_size=32768,
            hidden_size=1792, intermediate_size=7168, num_hidden_layers=14,
            num_attention_heads=14, num_key_value_heads=14, head_dim=128,
            max_position_embeddings=8192, rope_theta=10000.0,
            rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
            tie_word_embeddings=True),
        # the JAX package's in-tree VLM layout (a llama-1b decoder and a
        # ViT tower; models/loader.py reads both)
        "vlm": dict(
            architectures=["LlamaForCausalLM"], vocab_size=32768,
            hidden_size=2048, intermediate_size=5632, num_hidden_layers=16,
            num_attention_heads=16, num_key_value_heads=4,
            max_position_embeddings=8192, rope_theta=500000.0,
            rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False,
            vision_config=dict(
                image_size=224, patch_size=14, hidden_size=512,
                num_hidden_layers=6, num_attention_heads=8,
                intermediate_size=2048)),
    },
    "small": {
        "llama": dict(
            architectures=["LlamaForCausalLM"], vocab_size=2048,
            hidden_size=256, intermediate_size=1024, num_hidden_layers=4,
            num_attention_heads=8, num_key_value_heads=4,
            max_position_embeddings=2048, rope_theta=10000.0,
            rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False),
    },
    "tiny": {
        "llama": dict(
            architectures=["LlamaForCausalLM"], vocab_size=2048,
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=2048, rope_theta=10000.0,
            rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False),
        "gemma": dict(
            architectures=["GemmaForCausalLM"], vocab_size=2048,
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, head_dim=16,
            max_position_embeddings=2048, rope_theta=10000.0,
            rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
            tie_word_embeddings=True),
        "vlm": dict(
            architectures=["LlamaForCausalLM"], vocab_size=2048,
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=2048, rope_theta=10000.0,
            rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False,
            vision_config=dict(
                image_size=28, patch_size=14, hidden_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64)),
    },
}


def tokenizer_json(vocab_size: int) -> dict:
    """The port's learned BPE as an HF ``tokenizer.json`` of at most
    ``vocab_size`` entries (see the module docstring)."""
    ranks, expansions = _python_tables()
    merges = sorted(ranks, key=ranks.get)
    chars = byte_chars()

    def text(native_id: int) -> str:
        return "".join(chars[b] for b in expansions[native_id])

    vocab = {s: i for i, s in enumerate(SPECIALS)}
    for b in range(256):
        vocab[chars[b]] = len(SPECIALS) + b
    out_merges = []
    for a, b in merges[:max(0, vocab_size - len(vocab))]:
        vocab[text(a) + text(b)] = len(vocab)
        out_merges.append([text(a), text(b)])
    byte_level = {"add_prefix_space": False, "trim_offsets": True,
                  "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": s, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for i, s in enumerate(SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", **byte_level},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", **byte_level,
                    "add_prefix_space": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": out_merges},
    }


def make_tokenizer_files(out_dir: str, vocab_size: int) -> dict:
    """Write ``tokenizer.json`` and ``tokenizer_config.json`` (special
    tokens, chat template) into ``out_dir``; returns {token: id} for the
    specials."""
    with open(os.path.join(out_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(tokenizer_json(vocab_size), f, ensure_ascii=False)
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({
            "tokenizer_class": "PreTrainedTokenizerFast",
            "bos_token": "<|bos|>", "eos_token": "<|eos|>",
            "pad_token": "<|pad|>",
            "chat_template": CHAT_TEMPLATE,
            "model_max_length": 1 << 20,
        }, f, indent=1)
    return {s: i for i, s in enumerate(SPECIALS)}


def write_weights(out_dir: str, hf: dict, seed: int = 0) -> int:
    """Random bf16 weights under HF tensor names -> model.safetensors;
    returns the bytes written. The draws are the JAX module's, in its
    order, from ``torch.Generator().manual_seed(seed)``."""
    g = torch.Generator().manual_seed(seed)
    D = hf["hidden_size"]
    F = hf["intermediate_size"]
    H = hf["num_attention_heads"]
    KV = hf.get("num_key_value_heads") or H
    HD = hf.get("head_dim") or D // H
    V = hf["vocab_size"]
    gemma = hf["architectures"][0] == "GemmaForCausalLM"

    def w(out_f: int, in_f: int) -> torch.Tensor:
        return (torch.randn(out_f, in_f, generator=g)
                * in_f ** -0.5).to(torch.bfloat16)

    def norm(n: int) -> torch.Tensor:
        # HF Gemma's RMSNorm computes (1 + w) * x_hat: zero is identity
        return (torch.zeros(n) if gemma else torch.ones(n)).to(torch.bfloat16)

    tensors = {"model.embed_tokens.weight": w(V, D),
               "model.norm.weight": norm(D)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = norm(D)
        tensors[p + "self_attn.q_proj.weight"] = w(H * HD, D)
        tensors[p + "self_attn.k_proj.weight"] = w(KV * HD, D)
        tensors[p + "self_attn.v_proj.weight"] = w(KV * HD, D)
        tensors[p + "self_attn.o_proj.weight"] = w(D, H * HD)
        tensors[p + "post_attention_layernorm.weight"] = norm(D)
        tensors[p + "mlp.gate_proj.weight"] = w(F, D)
        tensors[p + "mlp.up_proj.weight"] = w(F, D)
        tensors[p + "mlp.down_proj.weight"] = w(D, F)
    if not hf.get("tie_word_embeddings"):
        tensors["lm_head.weight"] = w(V, D)
    vc = hf.get("vision_config")
    if vc:
        # the JAX package's in-tree VLM layout, drawn in its order
        VD = vc["hidden_size"]
        VF = vc["intermediate_size"]
        patch_dim = vc["patch_size"] ** 2 * 3
        n_patches = (vc["image_size"] // vc["patch_size"]) ** 2
        tensors["vision_tower.patch_embed.weight"] = w(VD, patch_dim)
        tensors["vision_tower.pos_embed"] = w(n_patches, VD)
        for i in range(vc["num_hidden_layers"]):
            p = f"vision_tower.layers.{i}."
            tensors[p + "ln1.weight"] = torch.ones(VD).to(torch.bfloat16)
            tensors[p + "attn.qkv_proj.weight"] = w(3 * VD, VD)
            tensors[p + "attn.o_proj.weight"] = w(VD, VD)
            tensors[p + "ln2.weight"] = torch.ones(VD).to(torch.bfloat16)
            tensors[p + "mlp.up_proj.weight"] = w(VF, VD)
            tensors[p + "mlp.down_proj.weight"] = w(VD, VF)
        tensors["vision_tower.final_ln.weight"] = \
            torch.ones(VD).to(torch.bfloat16)
        tensors["multi_modal_projector.weight"] = w(D, VD)
    return save_file(tensors, os.path.join(out_dir, "model.safetensors"),
                     metadata={"format": "pt"})


def make_checkpoint(out_dir: str, family: str = "llama", scale: str = "1b",
                    seed: int = 0, overrides: Optional[dict] = None) -> str:
    """Generate one complete HF checkpoint directory, the family's config
    at ``scale`` with ``overrides`` (config.json keys) replaced.
    Idempotent: an existing complete directory is left untouched."""
    marker = os.path.join(out_dir, ".complete")
    needed = ("config.json", "model.safetensors", "tokenizer.json",
              "tokenizer_config.json")
    if os.path.isfile(marker) and all(
            os.path.isfile(os.path.join(out_dir, f)) for f in needed):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    hf = dict(FAMILY_CONFIGS[scale][family], **(overrides or {}))
    ids = make_tokenizer_files(out_dir, hf["vocab_size"])
    hf["bos_token_id"] = ids["<|bos|>"]
    hf["eos_token_id"] = ids["<|eos|>"]
    hf["pad_token_id"] = ids["<|pad|>"]
    if "vision_config" in hf:
        hf["image_token_id"] = ids["<|image|>"]
    hf["torch_dtype"] = "bfloat16"
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    write_weights(out_dir, hf, seed=seed)
    with open(marker, "w") as f:
        f.write("ok\n")
    return out_dir


def make_bench_checkpoints(root: str, scale: str = "1b",
                           families: Optional[list[str]] = None) -> list[str]:
    """The bench pool's checkpoints under ``root``; returns the dirs."""
    families = families or sorted(FAMILY_CONFIGS[scale])
    return [make_checkpoint(os.path.join(root, f"{fam}-{scale}"),
                            family=fam, scale=scale, seed=i)
            for i, fam in enumerate(families)]


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="output root directory")
    ap.add_argument("--families", default="llama,mistral,gemma")
    ap.add_argument("--scale", default="1b", choices=sorted(FAMILY_CONFIGS))
    args = ap.parse_args(argv)
    dirs = make_bench_checkpoints(args.out, scale=args.scale,
                                  families=args.families.split(","))
    print(json.dumps({"checkpoints": dirs}))


if __name__ == "__main__":
    main()
