"""Per-row token sampling (port of ``quoracle_tpu/models/sampling.py``).

Sampling params are [B] tensors, not scalars: one batched step serves a
different temperature per pool member. Randomness comes from an explicit
``torch.Generator``; its stream differs from ``jax.random``'s, so sampled
rows match the JAX package in distribution, greedy rows token for token.
"""

from __future__ import annotations

import torch


def nucleus_keep(scaled: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """[B, V] bool keep-set of temperature-scaled logits under top-p: the
    JAX rule sort -> softmax -> cumsum -> keep -> cutoff, verbatim."""
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    # number of tokens to keep per row (always >= 1)
    keep = torch.sum(cum - sorted_probs < top_p[:, None], dim=-1)
    cutoff = torch.gather(sorted_logits, 1, (keep - 1)[:, None])
    return scaled >= cutoff


def sample_tokens(
    logits: torch.Tensor,       # [B, V] fp32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] fp32; <= 0 means greedy for that row
    top_p: torch.Tensor,        # [B] fp32 in (0, 1]; 1.0 disables
) -> torch.Tensor:
    """Returns [B] int32 sampled token ids."""
    greedy = torch.argmax(logits, dim=-1)       # first max index, as jnp
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    masked = torch.where(nucleus_keep(scaled, top_p), scaled,
                         torch.full_like(scaled, float("-inf")))
    probs = torch.softmax(masked, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)
