"""Draft-distillation trainer: capture → weights (port of
``quoracle_tpu/training/trainer.py``).

* **One card.** The JAX trainer lays its jitted step over a ``dp``
  submesh; here ``dp`` is 1, the whole of one card, and ``dp > 1`` raises
  (data parallelism across cards is ROADMAP Queue 1 item 12).
* **Distillation loss.** Weighted next-token CE against the RECORDED
  target tokens: the correction position (where the target overruled the
  draft) gets weight 1.0 and accepted positions get ``accept_weight``.
* **Deterministic data order.** Batch slot b of step s reads row
  sha256(seed:s:b) % len(rows), the JAX package's order exactly, so a run
  is replayable from (rows, config) alone: no RNG state to checkpoint.
* **Checkpointing with resume.** ``models/train.save_train_state`` (the
  port's own format) to ``<ckpt_dir>/latest`` every ``ckpt_every`` steps
  plus a ``meta.json`` sidecar; a restart resumes at the saved step with
  the same data order. The flash backward kernel sums without atomics, so
  a resumed run on the card is bit-equal to an uninterrupted one.
* **Bounded.** ``steps`` and ``budget_s`` both stop the loop.

The step is ``models/train``'s: the serving transformer's layers through
``transformer.forward``, the flash kernel and its backward kernel on the
card at seq >= 256, and the optimizer written as optax's (warmup-cosine
and global-norm clip as optax computes them, at optax's count).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from quoracle_tpu_torch.infra.telemetry import TRAIN_LOSS, TRAIN_STEPS_TOTAL
from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.train import (
    AdamW, TrainState, grads_of, init_train_state, load_train_state,
    save_train_state, seq_positions, warmup_cosine_decay_schedule,
    weighted_nll,
)
from quoracle_tpu_torch.models.transformer import Transformer, forward

DP_ITEM = "ROADMAP Queue 1 item 12 (multi-GPU)"


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 200
    batch: int = 8
    seq: int = 256
    lr: float = 1e-3
    warmup: int = 0                 # 0 = constant lr (the legacy loop)
    clip_norm: float = 0.0          # 0 = no clipping
    weight_decay: float = 0.01
    accept_weight: float = 0.25     # CE weight on accepted positions
    seed: int = 0
    dp: int = 1                     # data-parallel width: 1 on one card
    budget_s: Optional[float] = None
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0             # 0 = final save only (when ckpt_dir)
    log_every: int = 25


def make_optimizer(tcfg: TrainerConfig,
                   steps: Optional[int] = None) -> AdamW:
    """The JAX chain: optional global-norm clip + adamw on a warmup-cosine
    schedule (constant when warmup == 0, matching the legacy loop)."""
    steps = steps or tcfg.steps
    if tcfg.warmup > 0:
        schedule = warmup_cosine_decay_schedule(
            0.0, tcfg.lr, tcfg.warmup, max(steps, tcfg.warmup + 1),
            end_value=tcfg.lr * 0.1)
    else:
        schedule = tcfg.lr
    return AdamW(schedule, weight_decay=tcfg.weight_decay,
                 clip_norm=tcfg.clip_norm)


# ---------------------------------------------------------------------------
# Loss: weighted CE against recorded targets
# ---------------------------------------------------------------------------


def distill_loss_fn(params: Transformer, cfg: ModelConfig,
                    tokens: torch.Tensor, targets: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Weighted next-token CE where the label at position i+1 comes from
    ``targets`` (the recorded target-model tokens), not from the sequence
    itself. With targets == tokens and 0/1 weights this is
    models/train.loss_fn, which is how the corpus path rides the same
    step."""
    logits = forward(params, cfg, tokens, seq_positions(tokens))
    return weighted_nll(logits, targets, weights)


def distill_step(state: TrainState, cfg: ModelConfig, optimizer: AdamW,
                 tokens: torch.Tensor, targets: torch.Tensor,
                 weights: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
    loss = distill_loss_fn(state.params, cfg, tokens, targets, weights)
    grads = grads_of(loss, state.params)
    opt_state = optimizer.update(grads, state.opt_state, state.params)
    return TrainState(state.params, opt_state, state.step + 1), \
        loss.detach()


# ---------------------------------------------------------------------------
# Rows: capture records → (tokens, targets, weights)
# ---------------------------------------------------------------------------


def rows_from_capture(records, *, seq: int, pad_id: int,
                      accept_weight: float = 0.25) -> list:
    """Project spec_round capture records onto fixed-length training
    rows. The training sequence is ctx + proposal (what the draft
    actually ran); labels at the proposal positions are the recorded
    ``verified`` target tokens. Weights: 1.0 at the correction,
    ``accept_weight`` on accepted positions, 0 elsewhere. Rows are
    LEFT-truncated (the loss positions live at the tail)."""
    rows = []
    for rec in records:
        if rec.get("kind") != "spec_round":
            continue
        ctx = rec.get("ctx") or []
        props = rec.get("proposal") or []
        ver = rec.get("verified") or []
        j = int(rec.get("accepted") or 0)
        if not props or len(ver) != len(props):
            continue
        full = list(ctx) + list(props)
        tgt = list(ctx) + list(ver)
        wts = [0.0] * len(ctx) + [
            (accept_weight if t < j else 1.0 if t == j else 0.0)
            for t in range(len(props))]
        if len(full) > seq:
            full, tgt, wts = full[-seq:], tgt[-seq:], wts[-seq:]
        if sum(wts) <= 0:
            continue
        tokens = np.full(seq, pad_id, np.int32)
        targets = np.full(seq, pad_id, np.int32)
        weights = np.zeros(seq, np.float32)
        tokens[:len(full)] = full
        targets[:len(tgt)] = tgt
        weights[:len(wts)] = wts
        rows.append((tokens, targets, weights))
    return rows


def corpus_rows(rows, *, seq: int, pad_id: int) -> list:
    """finetune.build_format_corpus's (ids, prompt_len) tuples → the
    same (tokens, targets, weights) shape: plain next-token CE on the
    completion (targets == tokens, mask past the prompt)."""
    out = []
    for ids, plen in rows:
        ids = list(ids)[:seq]
        tokens = np.full(seq, pad_id, np.int32)
        tokens[:len(ids)] = ids
        weights = np.zeros(seq, np.float32)
        weights[plen:len(ids)] = 1.0
        out.append((tokens, tokens.copy(), weights))
    return out


def heldout_split(records: Sequence, frac: float = 0.2,
                  seed: int = 0) -> tuple[list, list]:
    """Deterministic (train, heldout) split — sha256 of the record
    index, so the same capture set always splits the same way."""
    train, held = [], []
    cut = int(frac * 1_000_000)
    for i, rec in enumerate(records):
        digest = hashlib.sha256(f"{seed}:heldout:{i}".encode()).digest()
        bucket = int.from_bytes(digest[:8], "big") % 1_000_000
        (held if bucket < cut else train).append(rec)
    return train, held


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


class DraftTrainer:
    """Owns the optimizer, the step and the checkpoint cadence. ``rows``
    are (tokens, targets, weights) triples from :func:`rows_from_capture`
    / :func:`corpus_rows`. ``params`` is trained IN PLACE on its own
    device (the JAX trainer's arrays are immutable; the port saves the
    copy)."""

    def __init__(self, cfg: ModelConfig, params: Transformer,
                 tcfg: TrainerConfig):
        if tcfg.dp != 1:
            raise ValueError(f"TrainerConfig.dp={tcfg.dp}: data-parallel "
                             f"training across cards is {DP_ITEM}; one "
                             f"card trains with dp=1")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = next(params.parameters()).device
        self.optimizer = make_optimizer(tcfg)
        self.state = init_train_state(params, self.optimizer)

    # -- checkpointing ---------------------------------------------------

    def _ckpt_path(self) -> Optional[str]:
        if not self.tcfg.ckpt_dir:
            return None
        return os.path.join(self.tcfg.ckpt_dir, "latest")

    def _meta_path(self) -> str:
        return os.path.join(self.tcfg.ckpt_dir, "meta.json")

    def save(self) -> Optional[int]:
        path = self._ckpt_path()
        if path is None:
            return None
        step = int(self.state.step)
        save_train_state(path, self.state)
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "seed": self.tcfg.seed,
                       "model": self.cfg.name}, f)
        os.replace(tmp, self._meta_path())      # atomic publish
        return step

    def resume(self) -> Optional[int]:
        """Restore <ckpt_dir>/latest when present; the resumed step keeps
        the sha256 data order aligned (it is stateless in the step
        number). Returns the resumed step or None."""
        path = self._ckpt_path()
        if path is None or not os.path.exists(self._meta_path()):
            return None
        try:
            with open(self._meta_path()) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return None
        self.state = load_train_state(path, self.state)
        return int(meta.get("step", int(self.state.step)))

    # -- the loop --------------------------------------------------------

    def _batch(self, rows: list, step: int):
        """Deterministic batch assembly: slot b of step s reads row
        sha256(seed:s:b) % len(rows) — replayable, resumable."""
        B, T = self.tcfg.batch, self.tcfg.seq
        tok = np.empty((B, T), np.int32)
        tgt = np.empty((B, T), np.int32)
        wts = np.empty((B, T), np.float32)
        for b in range(B):
            digest = hashlib.sha256(
                f"{self.tcfg.seed}:{step}:{b}".encode()).digest()
            t, g, w = rows[int.from_bytes(digest[:8], "big") % len(rows)]
            tok[b], tgt[b], wts[b] = t, g, w
        return tok, tgt, wts

    def step(self, tok, tgt, wts) -> torch.Tensor:
        """One optimizer step on a host batch; returns the loss (on the
        device, not synchronized)."""
        tok, tgt, wts = (torch.from_numpy(a).to(self.device)
                         for a in (tok, tgt, wts))
        self.state, loss = distill_step(self.state, self.cfg,
                                        self.optimizer, tok, tgt, wts)
        return loss

    def run(self, rows: list, *,
            log: Optional[Callable[[str], Any]] = None) -> dict:
        if not rows:
            raise ValueError("DraftTrainer.run: no training rows")
        tcfg = self.tcfg
        resumed = self.resume()
        start = int(self.state.step)
        deadline = (time.monotonic() + tcfg.budget_s
                    if tcfg.budget_s else None)
        stopped = "steps"
        loss = None
        steps_run = 0
        t0 = time.monotonic()
        for step in range(start, tcfg.steps):
            if deadline is not None and time.monotonic() >= deadline:
                stopped = "budget"
                break
            loss = self.step(*self._batch(rows, step))
            steps_run += 1
            TRAIN_STEPS_TOTAL.inc(model=self.cfg.name)
            if step % max(1, tcfg.log_every) == 0 \
                    or step == tcfg.steps - 1:
                TRAIN_LOSS.set(float(loss), model=self.cfg.name)
                if log is not None:
                    log(f"step {step}: loss {float(loss):.4f} "
                        f"({time.monotonic() - t0:.0f}s)")
            if tcfg.ckpt_every and (step + 1) % tcfg.ckpt_every == 0:
                self.save()
        if tcfg.ckpt_dir:
            self.save()
        final = float(loss) if loss is not None else None
        if final is not None:
            TRAIN_LOSS.set(final, model=self.cfg.name)
        return {
            "model": self.cfg.name,
            "resumed_from": resumed,
            "steps_run": steps_run,
            "step": int(self.state.step),
            "final_loss": final,
            "stopped": stopped,
            "dp": tcfg.dp,
            "wall_s": round(time.monotonic() - t0, 3),
        }

    @property
    def params(self) -> Transformer:
        return self.state.params


# ---------------------------------------------------------------------------
# Compat entry points
# ---------------------------------------------------------------------------


def train_corpus(ckpt_dir: str, rows, steps: int, batch: int, seq: int,
                 lr: float, seed: int, log, *, dp: int = 1,
                 tcfg: Optional[TrainerConfig] = None, device=None):
    """The finetune.train contract (load HF checkpoint in fp32 → train →
    (cfg, state)) on the trainer's step. ``device`` None: the card."""
    from quoracle_tpu_torch.models.loader import (
        load_params, register_hf_checkpoint,
    )
    cfg = register_hf_checkpoint(ckpt_dir, name="ft-base")
    params = load_params(ckpt_dir, cfg, device=device, dtype=torch.float32)
    tcfg = tcfg or TrainerConfig(steps=steps, batch=batch, seq=seq,
                                 lr=lr, seed=seed, dp=dp)
    trainer = DraftTrainer(cfg, params, tcfg)
    trainer.run(corpus_rows(rows, seq=seq, pad_id=cfg.eos_token_id),
                log=log)
    return cfg, trainer.state


def train_from_capture(cfg: ModelConfig, params: Transformer, store,
                       tcfg: TrainerConfig, *,
                       log: Optional[Callable] = None) -> tuple:
    """One flywheel training leg: drain the capture store's spec_round
    records into rows and train. Returns (trainer, report)."""
    store.flush()
    records = list(store.read_all("spec"))
    rows = rows_from_capture(records, seq=tcfg.seq,
                             pad_id=cfg.eos_token_id,
                             accept_weight=tcfg.accept_weight)
    trainer = DraftTrainer(cfg, params, tcfg)
    report = trainer.run(rows, log=log)
    report["capture_records"] = len(records)
    report["rows"] = len(rows)
    return trainer, report
