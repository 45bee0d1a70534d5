"""On-device text-conditioned diffusion image generation: the port of
``quoracle_tpu/models/diffusion.py``, behind the same ``ImageBackend``
seam (models/images.py) as the procedural backend. The reference's
generate_images action fans out to hosted image models (reference
lib/quoracle/models/image_query.ex:1-12); here a small pixel-space UNet
denoiser and a DDIM sampler run on the card.

Layout: the JAX package runs the UNet channels-last (NHWC, HWIO); the
port runs ``F.conv2d`` on NCHW activations and OIHW weights, so skip
connections concatenate on axis 1 and ``diffusion_params_from_jax``
permutes every HWIO kernel to OIHW (and transposes the [in, out]
matrices to ``nn.Linear``'s [out, in]). ``"SAME"`` padding is computed as
XLA does: at stride 2 an even input pads (0, 1), not (1, 1). GroupNorm
groups contiguous channels with the population variance, eps 1e-5 and
no bias (``F.group_norm``). The UNet is plain PyTorch, as the JAX
package's is plain XLA outside any Pallas kernel.

The sampler is split in three: ``prompt_embedding``, ``ddim_schedule``
and ``ddim_loop`` (the 30 DDIM steps from a given initial noise), which
``ddim_sample`` joins after drawing the noise from an explicit
``torch.Generator`` on the model's device. The JAX sampler draws its
noise with ``jax.random.normal``, whose bits a ``torch.Generator`` cannot
give: from the same prompt and seed the two packages draw different
pictures, each deterministic (ROADMAP Queue 3). Random weights give
textured noise; trained weights load through ``diffusion_params_from_jax``
or ``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import time
import uuid
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from quoracle_tpu_torch.models.generate import resolve_device
from quoracle_tpu_torch.models.images import (
    GeneratedImage, ImageBackend, write_png,
)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    image_size: int = 64          # model output; host resizes to request
    base_ch: int = 48
    ch_mult: tuple = (1, 2, 4)
    emb_ch: int = 192             # time + text embedding width
    vocab_size: int = 512         # prompt tokens (byte-level)
    groups: int = 8
    train_steps: int = 1000      # beta schedule length
    sample_steps: int = 30       # DDIM steps per image


def _conv_weight(cout: int, cin: int, k: int, **kw) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k, **kw))


class ResBlock(nn.Module):
    """GroupNorm -> SiLU -> conv, plus the time embedding, twice, with a
    1x1 skip conv when the width changes."""

    def __init__(self, cin: int, cout: int, emb_ch: int, **kw):
        super().__init__()
        self.n1 = nn.Parameter(torch.empty(cin, **kw))
        self.c1 = _conv_weight(cout, cin, 3, **kw)
        self.temb = nn.Linear(emb_ch, cout, bias=False, **kw)
        self.n2 = nn.Parameter(torch.empty(cout, **kw))
        self.c2 = _conv_weight(cout, cout, 3, **kw)
        if cin != cout:
            self.skip = _conv_weight(cout, cin, 1, **kw)
        else:
            self.register_parameter("skip", None)


class UNet(nn.Module):
    """The denoiser's weights, in the JAX tree's structure."""

    def __init__(self, cfg: DiffusionConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        E = cfg.emb_ch
        chans = [cfg.base_ch * m for m in cfg.ch_mult]
        self.text_embed = nn.Parameter(torch.empty(cfg.vocab_size, E, **kw))
        self.temb_w1 = nn.Linear(E, E, bias=False, **kw)
        self.temb_w2 = nn.Linear(E, E, bias=False, **kw)
        self.stem = _conv_weight(chans[0], 3, 3, **kw)
        self.down = nn.ModuleList(ResBlock(chans[i], chans[i], E, **kw)
                                  for i in range(len(chans) - 1))
        self.downs = nn.ParameterList(
            _conv_weight(chans[i + 1], chans[i], 3, **kw)
            for i in range(len(chans) - 1))
        self.mid = ResBlock(chans[-1], chans[-1], E, **kw)
        ups = list(range(len(chans) - 1, 0, -1))
        self.ups = nn.ParameterList(_conv_weight(chans[i - 1], chans[i], 3,
                                                 **kw) for i in ups)
        self.up = nn.ModuleList(ResBlock(2 * chans[i - 1], chans[i - 1], E,
                                         **kw) for i in ups)
        self.out_n = nn.Parameter(torch.empty(chans[0], **kw))
        self.out_c = _conv_weight(3, chans[0], 3, **kw)

    @classmethod
    def empty(cls, cfg: DiffusionConfig, device) -> "UNet":
        return cls(cfg, device="meta").to_empty(device=device)


@torch.no_grad()
def init_diffusion_params(cfg: DiffusionConfig, generator: torch.Generator
                          ) -> UNet:
    """Random fp32 weights on the generator's device: normal /
    sqrt(fan_in), norms at 1, the output conv scaled by 0.1, as the JAX
    package draws them (from other bits)."""
    model = UNet.empty(cfg, generator.device)

    def normal_(p: torch.Tensor, fan_in: int, scale: float = 1.0) -> None:
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=generator.device) * fan_in ** -0.5
                * scale)

    def conv_(w: torch.Tensor, scale: float = 1.0) -> None:
        normal_(w, w.shape[1] * w.shape[2] * w.shape[3], scale)

    normal_(model.text_embed, cfg.emb_ch)
    normal_(model.temb_w1.weight, cfg.emb_ch)
    normal_(model.temb_w2.weight, cfg.emb_ch)
    conv_(model.stem)
    for rb in (*model.down, model.mid, *model.up):
        rb.n1.fill_(1.0)
        rb.n2.fill_(1.0)
        conv_(rb.c1)
        conv_(rb.c2)
        normal_(rb.temb.weight, cfg.emb_ch)
        if rb.skip is not None:
            conv_(rb.skip)
    for w in (*model.downs, *model.ups):
        conv_(w)
    model.out_n.fill_(1.0)
    conv_(model.out_c, 0.1)
    return model


@torch.no_grad()
def diffusion_params_from_jax(tree: Mapping, cfg: DiffusionConfig,
                              device="cpu") -> UNet:
    """The port's UNet from the numpy leaves of the JAX package's
    ``init_diffusion_params`` tree: HWIO kernels permuted to OIHW,
    [in, out] matrices transposed."""
    model = UNet.empty(cfg, torch.device(device))

    def put(dst: torch.Tensor, src, perm: Optional[tuple] = None) -> None:
        arr = np.array(src, dtype=np.float32)
        if perm is not None:
            arr = np.ascontiguousarray(arr.transpose(perm))
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"diffusion_params_from_jax: leaf of shape "
                             f"{arr.shape} for a weight of shape "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    hwio, mat = (3, 2, 0, 1), (1, 0)

    def res(rb: ResBlock, leaf: Mapping) -> None:
        put(rb.n1, leaf["n1"])
        put(rb.c1, leaf["c1"], hwio)
        put(rb.temb.weight, leaf["temb"], mat)
        put(rb.n2, leaf["n2"])
        put(rb.c2, leaf["c2"], hwio)
        if rb.skip is not None:
            put(rb.skip, leaf["skip"], hwio)

    put(model.text_embed, tree["text_embed"])
    put(model.temb_w1.weight, tree["temb_w1"], mat)
    put(model.temb_w2.weight, tree["temb_w2"], mat)
    put(model.stem, tree["stem"], hwio)
    for rb, leaf in zip(model.down, tree["down"]):
        res(rb, leaf)
    for w, leaf in zip(model.downs, tree["downs"]):
        put(w, leaf, hwio)
    res(model.mid, tree["mid"])
    for rb, leaf in zip(model.up, tree["up"]):
        res(rb, leaf)
    for w, leaf in zip(model.ups, tree["ups"]):
        put(w, leaf, hwio)
    put(model.out_n, tree["out_n"])
    put(model.out_c, tree["out_c"], hwio)
    return model


def same_padding(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: the output keeps
    ceil(n / stride) positions, and an odd total pads one more after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution of NCHW ``x`` with OIHW ``w``."""
    top, bottom = same_padding(x.shape[2], w.shape[2], stride)
    left, right = same_padding(x.shape[3], w.shape[3], stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _gn(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    return F.group_norm(x, groups, weight=w, bias=None, eps=1e-5)


def _resblock(x: torch.Tensor, p: ResBlock, temb: torch.Tensor,
              groups: int) -> torch.Tensor:
    h = conv_same(F.silu(_gn(x, p.n1, groups)), p.c1)
    h = h + p.temb(temb)[:, :, None, None]
    h = conv_same(F.silu(_gn(h, p.n2, groups)), p.c2)
    if p.skip is not None:
        x = conv_same(x, p.skip)
    return x + h


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NCHW ``x``."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


@torch.no_grad()
def denoise(model: UNet, cfg: DiffusionConfig, x: torch.Tensor,
            t: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
    """Predict the noise eps of x_t. x [B, 3, S, S] (NCHW); t [B] in
    [0, 1); text_emb [B, emb_ch]. Returns eps [B, 3, S, S]."""
    half = cfg.emb_ch // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half * 9.21)
    ang = t[:, None] * cfg.train_steps * freqs[None, :]
    temb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    temb = F.silu(model.temb_w1(temb)) + text_emb
    temb = F.silu(model.temb_w2(temb))

    h = conv_same(x, model.stem)
    skips = []
    for rb, dw in zip(model.down, model.downs):
        h = _resblock(h, rb, temb, cfg.groups)
        skips.append(h)
        h = conv_same(h, dw, stride=2)
    h = _resblock(h, model.mid, temb, cfg.groups)
    for rb, uw in zip(model.up, model.ups):
        h = conv_same(upsample2x(h), uw)
        h = torch.cat([h, skips.pop()], dim=1)
        h = _resblock(h, rb, temb, cfg.groups)
    return conv_same(F.silu(_gn(h, model.out_n, cfg.groups)), model.out_c)


@torch.no_grad()
def prompt_embedding(model: UNet, prompt_ids: torch.Tensor) -> torch.Tensor:
    """Mean of the prompt's token embeddings over its nonzero ids
    (0 pads). prompt_ids [B, T] -> [B, emb_ch]."""
    emb = model.text_embed[prompt_ids.long()]              # [B, T, E]
    nz = (prompt_ids > 0).to(torch.float32)[..., None]
    return (emb * nz).sum(1) / torch.clamp(nz.sum(1), min=1.0)


def ddim_schedule(cfg: DiffusionConfig, device="cpu") -> tuple:
    """(step indices [steps] int32, alpha-bar at each [steps], alpha-bar
    at the next, 1 after the last) from the linear beta schedule."""
    betas = torch.linspace(1e-4, 0.02, cfg.train_steps, dtype=torch.float32,
                           device=device)
    abar = torch.cumprod(1.0 - betas, dim=0)
    idx = torch.linspace(cfg.train_steps - 1, 0, cfg.sample_steps,
                         dtype=torch.float32, device=device).to(torch.int32)
    a_t = abar[idx.long()]
    a_prev = torch.cat([abar[idx[1:].long()],
                        torch.ones(1, dtype=torch.float32, device=device)])
    return idx, a_t, a_prev


@torch.no_grad()
def ddim_loop(model: UNet, cfg: DiffusionConfig, x: torch.Tensor,
              text_emb: torch.Tensor) -> torch.Tensor:
    """The DDIM steps from the initial noise ``x`` [B, 3, S, S] -> images
    [B, S, S, 3] in [0, 1] (channels last, the PNG writer's layout)."""
    B = x.shape[0]
    idx, a_t, a_prev = ddim_schedule(cfg, x.device)
    t_all = idx.to(torch.float32) / cfg.train_steps
    for i in range(idx.shape[0]):
        a, ap = a_t[i], a_prev[i]
        eps = denoise(model, cfg, x, t_all[i].expand(B), text_emb)
        x0_pred = (x - torch.sqrt(1.0 - a) * eps) * torch.rsqrt(a)
        x0_pred = torch.clamp(x0_pred, -3.0, 3.0)
        x = torch.sqrt(ap) * x0_pred + torch.sqrt(1.0 - ap) * eps
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def ddim_sample(model: UNet, cfg: DiffusionConfig, prompt_ids: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """prompt_ids [B, T] (0-padded) -> images [B, S, S, 3] in [0, 1], the
    initial noise drawn from ``generator`` on the model's device."""
    dev = model.stem.device
    x0 = torch.randn((prompt_ids.shape[0], 3, cfg.image_size,
                      cfg.image_size), generator=generator, device=dev)
    return ddim_loop(model, cfg, x0,
                     prompt_embedding(model, prompt_ids.to(dev)))


class DiffusionImageBackend(ImageBackend):
    """ImageBackend serving the diffusion model on ``device`` (None: the
    card, and raises without one). Prompts condition through byte-level
    ids (the ``ByteTokenizer`` scheme), and each prompt's noise comes from
    a generator seeded by the prompt's sha256, so a prompt always draws
    the same pictures, the procedural backend's contract."""

    def __init__(self, cfg: Optional[DiffusionConfig] = None,
                 params: Optional[UNet] = None, seed: int = 0,
                 models: Sequence[str] = ("xla:diffusion-v0",),
                 cost_per_image: float = 0.0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or DiffusionConfig()
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = init_diffusion_params(self.cfg, gen)
        self.params = params.to(self.device)
        self.models = list(models)
        self.cost_per_image = cost_per_image

    def _prompt_ids(self, prompt: str, max_len: int = 64) -> np.ndarray:
        ids = [min(b + 3, self.cfg.vocab_size - 1)
               for b in prompt.encode("utf-8")[:max_len]]
        out = np.zeros((max_len,), np.int32)
        out[:len(ids)] = ids
        return out

    def generate(self, prompt: str, *, count: int = 1,
                 size: str = "256x256",
                 out_dir: Optional[str] = None) -> list[GeneratedImage]:
        try:
            w, h = (int(x) for x in size.lower().split("x"))
        except ValueError:
            raise ValueError(f"bad size {size!r}; expected WxH")
        w, h = max(8, min(w, 1024)), max(8, min(h, 1024))
        out_dir = out_dir or tempfile.gettempdir()
        os.makedirs(out_dir, exist_ok=True)
        n = max(1, min(count, 8))
        seed = int.from_bytes(
            hashlib.sha256(prompt.encode()).digest()[:4], "big")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        ids = torch.as_tensor(np.stack([self._prompt_ids(prompt)] * n))
        imgs = ddim_sample(self.params, self.cfg, ids, gen).cpu().numpy()
        out = []
        S = self.cfg.image_size
        yi = np.arange(h) * S // h          # nearest resize, host side
        xi = np.arange(w) * S // w
        for i in range(n):
            px = (imgs[i][yi][:, xi] * 255).astype(np.uint8)
            path = os.path.join(
                out_dir,
                f"img-{uuid.uuid4().hex[:10]}-{int(time.time())}.png")
            write_png(path, px.tobytes(), w, h)
            out.append(GeneratedImage(
                path=path, model=self.models[i % len(self.models)],
                width=w, height=h, cost=self.cost_per_image))
        return out
