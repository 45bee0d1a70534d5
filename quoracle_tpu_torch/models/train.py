"""Training step (fine-tuning) for catalog models (port of
``quoracle_tpu/models/train.py``).

The loss runs the serving model's own layers through
``transformer.forward`` (write offset 0, ``kv_lens`` = T: attention over
the chunk's own K/V, what the JAX loss computes), so a chunk of 256 tokens
or more on the card goes through the flash kernel forward and its
hand-written backward kernel (``csrc/flash_bwd.cu``).

The optimizer is optax's ``adamw`` written out in PyTorch, formula for
formula, so that the same gradients give the same parameters in both
packages (tests/test_torch_train.py): ``scale_by_adam`` (b1, b2, eps,
bias correction at the incremented count), ``add_decayed_weights`` over
every parameter, then the learning rate (a float, or a schedule evaluated
at optax's count, which starts at 0), with optax's
``clip_by_global_norm`` in front when asked (it divides by the norm, where
``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6). Parameters are
updated IN PLACE (the JAX step returns new arrays): at llama-1b scale in
fp32 a second copy would be 3.4 GB.

Checkpoints are the port's own format: ``torch.save`` of the parameters,
the optimizer state and the step, written to a temp file and published
with ``os.replace``. The JAX package's orbax checkpoints are not read
(orbax is a JAX library; ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Union

import torch
import torch.nn.functional as F

from quoracle_tpu_torch.models.config import ModelConfig
from quoracle_tpu_torch.models.transformer import Transformer, forward

Schedule = Callable[[int], float]
# optax.adamw's moment decays and epsilon
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamWState:
    """optax's ScaleByAdamState (count, mu, nu), one tensor per parameter
    in ``Transformer.parameters()`` order."""
    count: int
    mu: list
    nu: list


@dataclasses.dataclass
class TrainState:
    params: Transformer
    opt_state: AdamWState
    step: int


class AdamW:
    """``optax.chain([clip_by_global_norm(clip_norm),] adamw(lr,
    weight_decay=...))`` over a Transformer's parameters, in place."""

    def __init__(self, lr: Union[float, Schedule], *, weight_decay: float,
                 clip_norm: float = 0.0):
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Transformer) -> AdamWState:
        ps = list(params.parameters())
        return AdamWState(count=0,
                          mu=[torch.zeros_like(p) for p in ps],
                          nu=[torch.zeros_like(p) for p in ps])

    def lr_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: list, state: AdamWState,
               params: Transformer) -> AdamWState:
        """One optimizer step: ``params`` and ``state``'s moments change in
        place; returns ``state`` with its count advanced."""
        ps = list(params.parameters())
        if len(grads) != len(ps):
            raise ValueError(f"AdamW.update: {len(grads)} gradients for "
                             f"{len(ps)} parameters")
        if self.clip_norm > 0:
            g_norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                                    for g in grads))
            if not bool(g_norm < self.clip_norm):
                grads = [(g / g_norm.to(g.dtype)) * self.clip_norm
                         for g in grads]
        count_inc = state.count + 1
        lr = self.lr_at(state.count)
        for p, g, mu, nu in zip(ps, grads, state.mu, state.nu):
            mu.mul_(B1).add_(g * (1 - B1))
            nu.mul_(B2).add_(g * g * (1 - B2))
            mu_hat = mu / (1 - B1 ** count_inc)
            nu_hat = nu / (1 - B2 ** count_inc)
            upd = mu_hat / (torch.sqrt(nu_hat) + EPS)
            p.add_(upd + self.weight_decay * p, alpha=-lr)
        state.count = count_inc
        return state


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, weight_decay=weight_decay)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps`` counts, then
    cosine to ``end_value`` at ``decay_steps``; fp32 values."""
    alpha = end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)
    if not cos_steps > 0:
        raise ValueError(f"warmup_cosine_decay_schedule: decay_steps "
                         f"{decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            frac = 1 - c / warmup_steps
            val = (init_value - peak_value) * frac + peak_value
        else:
            c = min(float(count - warmup_steps), cos_steps)
            cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
            val = peak_value * ((1 - alpha) * cosine + alpha)
        return float(torch.tensor(val, dtype=torch.float32))

    return schedule


def seq_positions(tokens: torch.Tensor) -> torch.Tensor:
    """[B, T] positions 0..T-1 of a batch of full sequences."""
    B, T = tokens.shape
    return torch.arange(T, dtype=torch.int32,
                        device=tokens.device)[None, :].expand(B, T)


def weighted_nll(logits: torch.Tensor, targets: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """sum(nll * w) / max(sum(w), 1) of next-token predictions: logits at
    position i score ``targets`` at i + 1."""
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, targets[:, 1:, None].long())[..., 0]
    w = weights[:, 1:].float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def loss_fn(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            loss_mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over [B, T] token batches, masked by
    ``loss_mask`` (the JAX ``loss_fn``)."""
    logits = forward(params, cfg, tokens, seq_positions(tokens))
    return weighted_nll(logits, tokens, loss_mask)


def grads_of(loss: torch.Tensor, params: Transformer) -> list:
    """d loss / d every parameter, zeros where the loss does not reach
    one (a VLM's tower): optax sees a zero gradient there too."""
    ps = list(params.parameters())
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(ps, gs)]


def train_step(state: TrainState, cfg: ModelConfig, optimizer: AdamW,
               tokens: torch.Tensor, loss_mask: torch.Tensor
               ) -> tuple[TrainState, torch.Tensor]:
    loss = loss_fn(state.params, cfg, tokens, loss_mask)
    grads = grads_of(loss, state.params)
    opt_state = optimizer.update(grads, state.opt_state, state.params)
    return TrainState(state.params, opt_state, state.step + 1), \
        loss.detach()


def init_train_state(params: Transformer, optimizer: AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)


def save_train_state(path: str, state: TrainState) -> None:
    """Durable TrainState checkpoint: parameters, optimizer state and
    step in one ``torch.save`` file, written beside ``path`` and
    published with ``os.replace`` (periodic saves to one path overwrite;
    a crash leaves the previous file whole)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu()
                   for k, v in state.params.state_dict().items()},
        "opt_state": {"count": state.opt_state.count,
                      "mu": [t.detach().cpu() for t in state.opt_state.mu],
                      "nu": [t.detach().cpu() for t in state.opt_state.nu]},
        "step": int(state.step),
    }
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@torch.no_grad()
def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore a TrainState saved by save_train_state into ``template``'s
    tensors (their devices and dtypes; the template's values are
    overwritten): a same-shaped state, e.g. freshly initialized. Only
    files this program wrote are read (``weights_only`` unpickling)."""
    payload = torch.load(os.path.abspath(path), map_location="cpu",
                         weights_only=True)
    template.params.load_state_dict(payload["params"])
    opt = payload["opt_state"]
    for dst, src in zip(template.opt_state.mu + template.opt_state.nu,
                        opt["mu"] + opt["nu"]):
        dst.copy_(src)
    template.opt_state.count = int(opt["count"])
    template.step = int(payload["step"])
    return template
