"""Image preprocessing for the VLM tower: PNG decode, bilinear resize and
normalization. The port's copy of ``quoracle_tpu/native/image.py``.

``image.cpp`` is a byte copy of the JAX package's source, built at first
use with ``g++ ... -lz`` (``native.build_and_load``, into
``build/native/``) and bound with ``ctypes``. The Python path (stdlib
``zlib`` decode, numpy bilinear resize) serves only when that build
fails, and the failure is logged; it also decodes a PNG variant the
native decoder refuses.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import zlib
from functools import lru_cache

import numpy as np

from quoracle_tpu_torch.native import build_and_load

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_PATH = os.path.join(_DIR, "image.cpp")
LINK_FLAGS = ("-lz",)


@lru_cache(maxsize=1)
def _load_native():
    lib = build_and_load(SRC_PATH, extra_flags=LINK_FLAGS)
    if lib is None:
        return None
    lib.qt_img_decode_resize.restype = ctypes.c_int32
    lib.qt_img_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    return lib


def native_available() -> bool:
    return _load_native() is not None


# ---------------------------------------------------------------------------
# Python path (stdlib PNG decode, numpy bilinear)
# ---------------------------------------------------------------------------

def _py_decode_png(data: bytes) -> np.ndarray:
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, w = 8, None
    idat = b""
    while pos + 8 <= len(data):
        (clen,), tag = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + clen]
        if tag == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", payload[:13])
            if depth != 8 or interlace:
                raise ValueError("unsupported PNG variant")
            channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
            if channels is None:
                raise ValueError("unsupported color type")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + clen
    if w is None:
        raise ValueError("no IHDR")
    raw = zlib.decompress(idat)
    stride = w * channels
    img = np.zeros((h, stride), dtype=np.uint8)
    for y in range(h):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        filt, line = row[0], np.frombuffer(row[1:], dtype=np.uint8).copy()
        up = img[y - 1] if y else np.zeros(stride, dtype=np.uint8)
        if filt == 0:
            out = line
        elif filt == 2:
            out = line + up
        else:                       # 1/3/4 need sequential left-dependence
            out = np.zeros(stride, dtype=np.uint8)
            for x in range(stride):
                a = int(out[x - channels]) if x >= channels else 0
                b = int(up[x])
                c = int(img[y - 1][x - channels]) \
                    if y and x >= channels else 0
                v = int(line[x])
                if filt == 1:
                    v += a
                elif filt == 3:
                    v += (a + b) // 2
                elif filt == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    v += a if pa <= pb and pa <= pc else \
                        (b if pb <= pc else c)
                out[x] = v & 0xFF
        img[y] = out
    px = img.reshape(h, w, channels)
    if channels == 1:
        return np.repeat(px, 3, axis=2)
    if channels == 2:
        return np.repeat(px[:, :, :1], 3, axis=2)
    return px[:, :, :3]


def _py_resize(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.linspace(0, h - 1, out_h) if out_h > 1
          else np.zeros(1))
    xs = (np.linspace(0, w - 1, out_w) if out_w > 1
          else np.zeros(1))
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img.astype(np.float32)
    out = (f[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
           + f[np.ix_(y0, x1)] * (1 - wy) * wx
           + f[np.ix_(y1, x0)] * wy * (1 - wx)
           + f[np.ix_(y1, x1)] * wy * wx)
    return (out + 0.5).astype(np.uint8)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def decode_resize(png_bytes: bytes, out_w: int, out_h: int) -> np.ndarray:
    """PNG -> RGB8 array of (out_h, out_w, 3)."""
    lib = _load_native()
    if lib is not None:
        out = (ctypes.c_ubyte * (out_w * out_h * 3))()
        sw, sh = ctypes.c_int32(), ctypes.c_int32()
        rc = lib.qt_img_decode_resize(png_bytes, len(png_bytes),
                                      out_w, out_h, out,
                                      ctypes.byref(sw), ctypes.byref(sh))
        if rc == 0:
            return np.ctypeslib.as_array(out).reshape(out_h, out_w, 3).copy()
        # fall through: a variant the native decoder does not read
    return _py_resize(_py_decode_png(png_bytes), out_w, out_h)


def preprocess_for_vision(png_bytes: bytes, size: int = 224) -> np.ndarray:
    """Vision-tower input: float32 HWC in [-1, 1], the layout
    models/vision.py patchifies ([B, H, W, 3])."""
    rgb = decode_resize(png_bytes, size, size)
    return rgb.astype(np.float32) / 127.5 - 1.0
