"""The port's image preprocessing (quoracle_tpu_torch/native/image.py
over its copy of image.cpp) against the JAX package's, on the CPU: the
image cases of tests/test_native.py run on the port, and each of the
port's two paths gives the JAX package's same path's pixels exactly,
over PNGs this file encodes with ``zlib``: colour types 0, 2, 4 and 6,
every row filter (0-4), odd sizes, resizing down and up.

The native and Python paths are two resizers: ``image.cpp`` rounds its
bilinear weights in its own way, so the two may differ by one step of
255 on a channel (tests/test_native.py's bar); the largest difference
seen is asserted here, on both packages alike."""

import logging
import struct
import zlib

import numpy as np
import pytest

from quoracle_tpu.models.images import write_png as jwrite_png
from quoracle_tpu.native import image as jimg
from quoracle_tpu_torch.models.images import write_png
from quoracle_tpu_torch.native import image as timg

CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def encode_png(px: np.ndarray, ctype: int, filters) -> bytes:
    """An 8-bit non-interlaced PNG of ``px`` [h, w, channels] in colour
    type ``ctype``, row y filtered with ``filters[y % len(filters)]``."""
    h, w, ch = px.shape
    assert ch == CHANNELS[ctype]
    raw = bytearray()
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        line = px[y].reshape(-1).astype(np.int64)
        f = filters[y % len(filters)]
        out = []
        for x in range(w * ch):
            a = int(line[x - ch]) if x >= ch else 0
            b = int(prev[x])
            c = int(prev[x - ch]) if x >= ch else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            out.append((int(line[x]) - pred) & 0xFF)
        raw += bytes([f]) + bytes(out)
        prev = line

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(bytes(raw), 6))
            + chunk(b"IEND", b""))


def _pixels(seed: int, h: int, w: int, ch: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 255 // max(1, w - 1) + y * 97) % 256
    noise = rng.integers(0, 40, (h, w, ch))
    return ((base[..., None] + noise * np.arange(1, ch + 1)) % 256
            ).astype(np.uint8)


# (colour type, row filters, source w x h, output w x h)
CASES = [
    (2, (0,), (64, 48), (32, 32)),
    (2, (0, 1, 2, 3, 4), (37, 29), (224, 224)),        # odd, up
    (6, (4, 3, 2, 1, 0), (41, 23), (16, 9)),           # odd, down
    (0, (1, 4), (33, 31), (28, 28)),
    (4, (2, 3), (15, 17), (56, 14)),
    (6, (0, 1, 2, 3, 4), (640, 480), (224, 224)),      # the chip's size
    (0, (3,), (1, 1), (5, 3)),
]
IDS = [f"ct{c}-f{''.join(map(str, f))}-{s[0]}x{s[1]}-to-{o[0]}x{o[1]}"
       for c, f, s, o in CASES]


@pytest.fixture(scope="module", params=range(len(CASES)), ids=IDS)
def case(request):
    ctype, filters, (w, h), (ow, oh) = CASES[request.param]
    png = encode_png(_pixels(request.param, h, w, CHANNELS[ctype]), ctype,
                     filters)
    return png, ow, oh


def test_both_builds_load():
    assert timg.native_available() and jimg.native_available()


def test_native_decode_resize_equals_jax(case):
    png, ow, oh = case
    got = timg.decode_resize(png, ow, oh)
    want = jimg.decode_resize(png, ow, oh)
    assert got.shape == (oh, ow, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_python_path_equals_jax(case):
    png, ow, oh = case
    dec = timg._py_decode_png(png)
    np.testing.assert_array_equal(dec, jimg._py_decode_png(png))
    np.testing.assert_array_equal(timg._py_resize(dec, ow, oh),
                                  jimg._py_resize(dec, ow, oh))


def test_native_and_python_paths_agree_within_one_step(case):
    png, ow, oh = case
    dec = timg._py_decode_png(png)
    # the decoders agree exactly: a same-size resize is the identity
    h, w = dec.shape[:2]
    np.testing.assert_array_equal(timg.decode_resize(png, w, h), dec)
    diff = np.abs(timg.decode_resize(png, ow, oh).astype(int)
                  - timg._py_resize(dec, ow, oh).astype(int)).max()
    jdiff = np.abs(jimg.decode_resize(png, ow, oh).astype(int)
                   - jimg._py_resize(dec, ow, oh).astype(int)).max()
    assert diff == jdiff <= 1


def test_preprocess_for_vision_equals_jax(case):
    png, _, _ = case
    got = timg.preprocess_for_vision(png, size=28)
    np.testing.assert_array_equal(got, jimg.preprocess_for_vision(png,
                                                                  size=28))
    assert got.dtype == np.float32 and got.shape == (28, 28, 3)


def test_fallback_serves_when_the_build_fails(monkeypatch, case, caplog):
    """No library (a failed build): the Python path decodes, and a
    failing build logs its warning."""
    png, ow, oh = case
    monkeypatch.setattr(timg, "_load_native", lambda: None)
    np.testing.assert_array_equal(timg.decode_resize(png, ow, oh),
                                  jimg._py_resize(jimg._py_decode_png(png),
                                                  ow, oh))
    from quoracle_tpu_torch import native
    with caplog.at_level(logging.WARNING):
        assert native.build_and_load(timg.SRC_PATH,
                                     extra_flags=("-lno_such_lib",)) is None
    assert any("using the Python fallback" in r.getMessage()
               for r in caplog.records)


# ---------------------------------------------------------------------------
# tests/test_native.py's image cases on the port
# ---------------------------------------------------------------------------

def _gradient_png(tmp_path, w=64, h=48):
    pixels = bytearray()
    for y in range(h):
        for x in range(w):
            pixels += bytes([x * 255 // max(1, w - 1),
                             y * 255 // max(1, h - 1), 128])
    path = str(tmp_path / "g.png")
    write_png(path, bytes(pixels), w, h)
    with open(path, "rb") as f:
        data = f.read()
    jpath = str(tmp_path / "j.png")
    jwrite_png(jpath, bytes(pixels), w, h)
    with open(jpath, "rb") as f:
        assert f.read() == data          # the writers are one format
    return data


def test_png_decode_resize(tmp_path):
    png = _gradient_png(tmp_path)
    out = timg.decode_resize(png, 32, 32)
    assert out.shape == (32, 32, 3)
    # gradient preserved: left->right red ramp, top->bottom green ramp
    assert out[0, 0, 0] < out[0, -1, 0]
    assert out[0, 0, 1] < out[-1, 0, 1]
    assert abs(int(out[16, 16, 2]) - 128) <= 2
    ref = timg._py_resize(timg._py_decode_png(png), 32, 32)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_array_equal(out, jimg.decode_resize(png, 32, 32))


def test_preprocess_for_vision(tmp_path):
    png = _gradient_png(tmp_path)
    hwc = timg.preprocess_for_vision(png, size=64)
    assert hwc.shape == (64, 64, 3)           # HWC: what the ViT patchifies
    assert hwc.dtype == np.float32
    assert -1.0 <= hwc.min() and hwc.max() <= 1.0
    np.testing.assert_array_equal(hwc, jimg.preprocess_for_vision(png,
                                                                  size=64))


@pytest.mark.parametrize("data", [
    b"definitely not a png",
    encode_png(np.zeros((2, 2, 3), np.uint8), 2, (0,)).replace(
        b"\x08\x02\x00\x00\x00", b"\x10\x02\x00\x00\x00", 1),
], ids=["not-png", "16-bit"])
def test_bad_png_raises(data):
    errs = []
    for mod in (jimg, timg):
        with pytest.raises(ValueError) as e:
            mod.decode_resize(data, 8, 8)
        errs.append(str(e.value))
    assert errs[1] == errs[0]
