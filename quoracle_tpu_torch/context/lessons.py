"""Lesson accumulation with embedding dedup.

Parity with the reference's LessonManager (reference
lib/quoracle/agent/lesson_manager.ex; behavior documented in agent
AGENTS.md:121-127): new lessons are embedded and compared against the
existing set — cosine >= 0.90 means "same lesson", which merges (keeps the
existing text, increments confidence) instead of appending; the store is
pruned to the 100 highest-confidence lessons per model. The embedder runs
on-device (XLA encoder), so dedup is cheap enough to run on every
condensation.

The PyTorch port's copy of ``quoracle_tpu/context/lessons.py``.
"""

from __future__ import annotations

import logging
from typing import Protocol, Sequence

import numpy as np

from quoracle_tpu_torch.context.history import Lesson

logger = logging.getLogger(__name__)

SIMILARITY_THRESHOLD = 0.90   # reference agent AGENTS.md:121-127
MAX_LESSONS_PER_MODEL = 100


class Embedder(Protocol):
    def embed(self, texts: Sequence[str]) -> list[np.ndarray]: ...


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def accumulate_lessons(
    existing: list[Lesson],
    new: Sequence[Lesson],
    embedder: Embedder,
    threshold: float = SIMILARITY_THRESHOLD,
    max_lessons: int = MAX_LESSONS_PER_MODEL,
) -> list[Lesson]:
    """Merge `new` lessons into `existing` (returns a new list; does not
    mutate inputs' ordering semantics beyond confidence bumps)."""
    if not new:
        return list(existing)
    out = list(existing)
    # Embed lazily-missing vectors in one batched call (one device step).
    to_embed = [l for l in out if l.embedding is None] + \
               [l for l in new if l.embedding is None]
    if to_embed:
        vecs = embedder.embed([l.content for l in to_embed])
        for lesson, vec in zip(to_embed, vecs):
            lesson.embedding = vec

    for lesson in new:
        best, best_sim = None, 0.0
        for old in out:
            sim = _cosine(old.embedding, lesson.embedding)
            if sim > best_sim:
                best, best_sim = old, sim
        if best is not None and best_sim >= threshold:
            best.confidence += 1     # dedup-merge: keep old text, bump
        else:
            out.append(lesson)

    if len(out) > max_lessons:
        # prune lowest-confidence first; ties keep newest knowledge (higher
        # index = more recently learned, so it must outrank an equal-
        # confidence older lesson — a plain stable sort would keep the old).
        ranked = sorted(enumerate(out),
                        key=lambda p: (-p[1].confidence, -p[0]))
        ranked = sorted(ranked[:max_lessons], key=lambda p: p[0])
        out = [l for _, l in ranked]
    return out
