"""The safetensors format, read and written by the port itself.

The JAX package reads checkpoints through the ``safetensors`` library and
bf16 through ``ml_dtypes``; the port's machines have neither, so it keeps
this copy of the format (https://github.com/huggingface/safetensors):

    8 bytes    little-endian u64 N, the header's length
    N bytes    a JSON object: ``__metadata__`` (str -> str, optional) and,
               per tensor, {"dtype", "shape", "data_offsets": [begin, end]}
               with offsets relative to the byte buffer that follows
    the rest   the byte buffer: every tensor, C order, little-endian

Reading maps the file copy-on-write (``mmap.ACCESS_COPY``: writable views,
so ``torch.frombuffer`` neither warns nor copies) and views each tensor in
place; the pages come from the page cache as a caller copies them to their
target, so loading a model never holds a second whole host copy. bf16
arrives as ``torch.bfloat16``. Writing lays the tensors out as the library
does (by dtype, widest first, then by name; the header padded with spaces
to a multiple of 8 bytes), so a file written here with at most one
metadata key (the library's metadata is a hash map, its order unspecified)
is the library's file byte for byte; it moves each tensor to the host
only while it is written.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Mapping, Optional

import torch

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "F16": torch.float16, "BF16": torch.bfloat16,
    "I32": torch.int32, "F32": torch.float32, "F64": torch.float64,
    "I64": torch.int64,
}
NAMES = {dt: name for name, dt in DTYPES.items()}
# the library's data order: its dtype enum, widest first, then the name
_ORDER = {name: i for i, name in enumerate(DTYPES)}
MAX_HEADER = 100 << 20              # the library's bound on N
INDEX_FILE = "model.safetensors.index.json"


def _header(path: str, f) -> tuple[dict, int]:
    """(header dict, byte offset of the buffer) of an open file, checked
    as the library checks it: the offsets tile the buffer exactly."""
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{path}: not a safetensors file (no header)")
    (n,) = struct.unpack("<Q", head)
    size = os.fstat(f.fileno()).st_size
    if n > MAX_HEADER or 8 + n > size:
        raise ValueError(f"{path}: header length {n} does not fit the "
                         f"file ({size} bytes)")
    header = json.loads(f.read(n).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    meta = header.get("__metadata__")
    if meta is not None and not (isinstance(meta, dict) and all(
            isinstance(v, str) for v in meta.values())):
        raise ValueError(f"{path}: __metadata__ must map str to str")
    spans = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info.get("dtype") not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info.get('dtype')!r}; supported: "
                             f"{sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        numel = 1
        for d in info["shape"]:
            numel *= int(d)
        width = torch.empty((), dtype=DTYPES[info["dtype"]]).element_size()
        if end - begin != numel * width:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} "
                             f"bytes for shape {info['shape']}")
        spans.append((begin, end))
    at = 0
    for begin, end in sorted(spans):
        if begin != at:
            raise ValueError(f"{path}: the tensors do not tile the buffer "
                             f"(a gap or an overlap at byte {at})")
        at = end
    if 8 + n + at != size:
        raise ValueError(f"{path}: the buffer holds {size - 8 - n} bytes, "
                         f"the header describes {at}")
    return header, 8 + n


class SafetensorsFile:
    """One mapped file. ``get(name)`` returns a CPU tensor that views the
    mapping (copy it before ``close``)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header, self._base = _header(path, f)
            size = os.fstat(f.fileno()).st_size
            # an empty buffer cannot be mapped; nothing would be read
            self._map = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                         if size > self._base else None)
        self.metadata: Optional[dict] = header.pop("__metadata__", None)
        self._info: dict = header

    def keys(self) -> list[str]:
        return list(self._info)

    def info(self, name: str) -> tuple[torch.dtype, tuple]:
        i = self._info[name]
        return DTYPES[i["dtype"]], tuple(int(d) for d in i["shape"])

    def get(self, name: str) -> torch.Tensor:
        if name not in self._info:
            raise KeyError(f"{self.path}: no tensor {name!r}")
        dtype, shape = self.info(name)
        begin, end = self._info[name]["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._map, dtype=torch.uint8,
                                count=end - begin, offset=self._base + begin)
        return flat.view(dtype).reshape(shape)

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device) to ``path``; returns the bytes
    written. Each tensor is copied to the host when its turn comes."""
    order = sorted(tensors, key=lambda n: (
        -_ORDER[_dtype_name(tensors[n])], n))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    at = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _dtype_name(t), "shape": list(t.shape),
                        "data_offsets": [at, at + nbytes]}
        at += nbytes
    raw = json.dumps(header, separators=(",", ":"),
                     ensure_ascii=False).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                host = t.to("cpu").contiguous().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)
                del host
    return 8 + len(raw) + at


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in NAMES:
        raise ValueError(f"dtype {t.dtype} has no safetensors name; "
                         f"supported: {sorted(NAMES.values())}")
    return NAMES[t.dtype]


class ShardedReader:
    """Tensors by name across a checkpoint directory: the shards a
    ``model.safetensors.index.json`` maps, or else every ``*.safetensors``
    file in it. Files are mapped when first needed."""

    def __init__(self, path: str):
        self.path = path
        index = os.path.join(path, INDEX_FILE)
        self._files: dict[str, SafetensorsFile] = {}
        if os.path.isfile(index):
            with open(index) as f:
                self._where: dict[str, str] = dict(json.load(f)["weight_map"])
            for fn in sorted(set(self._where.values())):
                if not os.path.isfile(os.path.join(path, fn)):
                    raise FileNotFoundError(
                        f"{index} names shard {fn!r}, which is missing")
        else:
            names = sorted(fn for fn in os.listdir(path)
                           if fn.endswith(".safetensors"))
            if not names:
                raise FileNotFoundError(
                    f"no .safetensors files under {path!r}")
            self._where = {}
            for fn in names:
                for name in self._open(fn).keys():
                    self._where.setdefault(name, fn)

    def _open(self, fn: str) -> SafetensorsFile:
        if fn not in self._files:
            self._files[fn] = SafetensorsFile(os.path.join(self.path, fn))
        return self._files[fn]

    def names(self) -> set:
        return set(self._where)

    def get(self, name: str) -> torch.Tensor:
        if name not in self._where:
            raise KeyError(f"checkpoint {self.path!r} has no tensor "
                           f"{name!r}")
        return self._open(self._where[name]).get(name)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
