"""Image generation backend seam.

The reference fans image generation out to configured hosted image models
(reference lib/quoracle/models/image_query.ex:1-12 — Task.async_stream over
image models, 60s timeout, cost recording). The TPU-native seam is one
``ImageBackend.generate`` call; a real on-device diffusion model plugs in
behind it, and the default ProceduralImageBackend produces deterministic
placeholder PNGs (stdlib-only writer) so the action, cost pipeline, and
tests work end to end without a diffusion checkpoint.

The PyTorch port's copy of ``quoracle_tpu/models/images.py``. The
on-device diffusion backend behind the same seam is models/diffusion.py.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import os
import struct
import tempfile
import time
import uuid
import zlib
from typing import Optional, Sequence


@dataclasses.dataclass
class GeneratedImage:
    path: str
    model: str
    width: int
    height: int
    cost: float = 0.0


def write_png(path: str, pixels: bytes, width: int, height: int) -> None:
    """Minimal RGB PNG writer (no PIL dependency)."""
    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    raw = b"".join(b"\x00" + pixels[y * width * 3:(y + 1) * width * 3]
                   for y in range(height))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


class ImageBackend(abc.ABC):
    @abc.abstractmethod
    def generate(self, prompt: str, *, count: int = 1,
                 size: str = "256x256",
                 out_dir: Optional[str] = None) -> list[GeneratedImage]: ...


class ProceduralImageBackend(ImageBackend):
    """Deterministic prompt-seeded gradient/noise placeholder images."""

    def __init__(self, models: Sequence[str] = ("procedural:v0",),
                 cost_per_image: float = 0.0):
        self.models = list(models)
        self.cost_per_image = cost_per_image

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
        images = []
        for i in range(max(1, min(count, 8))):
            seed = hashlib.sha256(f"{prompt}:{i}".encode()).digest()
            r0, g0, b0, r1, g1, b1 = seed[:6]
            rows = bytearray()
            for y in range(h):
                fy = y / max(1, h - 1)
                for x in range(w):
                    fx = x / max(1, w - 1)
                    n = seed[(x * 31 + y * 17) % len(seed)] / 255.0 * 0.25
                    rows.append(min(255, int(r0 + (r1 - r0) * fx + n * 40)))
                    rows.append(min(255, int(g0 + (g1 - g0) * fy + n * 40)))
                    rows.append(min(255, int(b0 + (b1 - b0) * (fx + fy) / 2
                                             + n * 40)))
            path = os.path.join(
                out_dir, f"img-{uuid.uuid4().hex[:10]}-{int(time.time())}.png")
            write_png(path, bytes(rows), w, h)
            images.append(GeneratedImage(
                path=path, model=self.models[i % len(self.models)],
                width=w, height=h, cost=self.cost_per_image))
        return images
