"""On-device embedding encoder (port of ``quoracle_tpu/models/embeddings.py``).

Mean-pooled final hidden states of a catalog model, L2-normalized: the
embedder that semantic consensus rules call while clustering and merging
proposals (consensus/rules.py), so a decide waits on it. A SHA-256 LRU
cache sits in front (utils/cache.py), and long texts are split into
``chunk_tokens`` pieces whose vectors are averaged and renormalized.

``EmbeddingEncoder`` is a plain serving class over the port's
``forward_hidden`` on the params' device: no compile step and no CPU
fallback. Its padded shapes are the JAX encoder's exactly (batch buckets
1/4/16/64, T a power of two of at least 8, padded rows of length 1), so
both packages push the same tensors through the model; a 256-token chunk
runs the flash kernel on the card (ops/flash_attention.attend_auto),
shorter ones the dense ``attend``, as in JAX. The working KV cache takes
the weights' dtype, as the generate engine's does: for bf16 weights that
is the JAX encoder's bf16 cache; fp32 weights (the parity tests, the fp32
reference cuts) get an fp32 cache, where the JAX encoder, whose cache is
always bf16, fails to write fp32 K/V into it. ``cosine_similarity`` and
``HashingEmbedder`` (the model-free test embedder) are copied as they
are.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.tokenizer import Tokenizer
from quoracle_tpu_torch.models.transformer import (
    Transformer, forward_hidden, init_cache,
)
from quoracle_tpu_torch.utils.cache import TTLCache, text_key


class EmbeddingEncoder:
    """Batched text -> unit vector encoder over a catalog model's hidden
    states."""

    BATCH_BUCKETS = (1, 4, 16, 64)

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 tokenizer: Tokenizer, max_tokens: int = 512,
                 cache: Optional[TTLCache] = None, chunk_tokens: int = 256):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.chunk_tokens = min(chunk_tokens, max_tokens)
        self.cache = cache if cache is not None else TTLCache()
        self.device = params.final_norm.device

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @torch.no_grad()
    def _encode(self, tokens: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
        """[B, T] tokens, [B] lengths -> [B, dim] fp32 unit vectors: the
        masked mean of the final hidden states in fp32, L2-normalized
        with a 1e-9 floor."""
        cfg = self.cfg
        B, T = tokens.shape
        cache = init_cache(cfg, B, T, self.device, dtype=self.params.dtype)
        positions = torch.arange(T, dtype=torch.int32,
                                 device=self.device)[None, :].expand(B, T)
        hidden, _ = forward_hidden(
            self.params, cfg, tokens, positions, cache,
            write_offset=torch.zeros((B,), dtype=torch.int32,
                                     device=self.device),
            kv_lens=lens)
        mask = (positions < lens[:, None]).float()[..., None]
        pooled = torch.sum(hidden.float() * mask, dim=1) \
            / torch.clamp(torch.sum(mask, dim=1), min=1.0)
        return pooled / torch.clamp(
            torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-9)

    def _encode_token_batch(self, token_lists: list[list[int]]) -> np.ndarray:
        n = len(token_lists)
        B = next((b for b in self.BATCH_BUCKETS if n <= b), n)
        T = max(8, max(len(t) for t in token_lists))
        T = 1 << (T - 1).bit_length()  # pow2 bucket
        tokens = np.zeros((B, T), np.int32)
        lens = np.ones((B,), np.int32)
        for i, t in enumerate(token_lists):
            tokens[i, :len(t)] = t
            lens[i] = max(1, len(t))
        out = self._encode(torch.from_numpy(tokens).to(self.device),
                           torch.from_numpy(lens).to(self.device))
        return out.cpu().numpy()[:n]

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        """Cached batched embedding. Long texts are chunked and averaged."""
        results: dict[int, np.ndarray] = {}
        pending: list[tuple[int, list[list[int]]]] = []  # (text idx, chunks)
        for i, text in enumerate(texts):
            key = text_key(text, namespace=self.cfg.name)
            hit = self.cache.get(key)
            if hit is not None:
                results[i] = hit
                continue
            ids = self.tokenizer.encode(text or " ")
            chunks = [ids[j:j + self.chunk_tokens]
                      for j in range(0, len(ids), self.chunk_tokens)] or [[0]]
            pending.append((i, chunks))

        if pending:
            flat: list[list[int]] = []
            spans: list[tuple[int, int, int]] = []  # (text idx, start, count)
            for i, chunks in pending:
                spans.append((i, len(flat), len(chunks)))
                flat.extend(chunks)
            vecs = self._encode_token_batch(flat)
            for i, start, count in spans:
                v = vecs[start:start + count].mean(axis=0)
                v = v / max(float(np.linalg.norm(v)), 1e-9)
                results[i] = v
                self.cache.put(text_key(texts[i], namespace=self.cfg.name), v)

        return [results[i] for i in range(len(texts))]


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


@functools.lru_cache(maxsize=None)
def _hash_basis(dim: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((256, dim)).astype(np.float32)


class HashingEmbedder:
    """Deterministic, model-free embedder for tests (injectable the way the
    reference injects ``embedding_fn`` — aggregator.ex:250-267): byte-ngram
    counts projected through a fixed random basis. Similar strings land close;
    no device work."""

    def __init__(self, dim: int = 64):
        self._dim = dim

    @property
    def dim(self) -> int:
        return self._dim

    def embed(self, texts: Sequence[str]) -> list[np.ndarray]:
        basis = _hash_basis(self._dim)
        out = []
        for text in texts:
            counts = np.zeros(256, np.float32)
            data = text.encode("utf-8", errors="replace")
            for b in data:
                counts[b] += 1.0
            for a, b2 in zip(data, data[1:]):
                counts[(a * 31 + b2) % 256] += 0.5
            v = counts @ basis
            n = float(np.linalg.norm(v))
            out.append(v / n if n > 0 else v)
        return out
