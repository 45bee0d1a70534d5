"""Build, load and launch the port's hand-written CUDA kernels.

The sources live in ``quoracle_tpu_torch/csrc``. On first use, ``nvcc``
compiles each ``.cu`` file for ``sm_90a`` (all files at once, one
process each) and links them into one shared library with a plain C
interface under ``build/torch_kernels/`` at the repository root (for an
installed package, under the user's cache directory); the library's file
name carries a hash of the sources, the flags and ``nvcc --version``, so
an edited source or a new toolkit rebuilds and an unchanged one loads the
cached build. ``ctypes``
binds each entry point with ``c_void_p`` for every pointer and for the
CUDA stream. A missing ``nvcc`` or a failed build raises: there is no
fallback for a CUDA tensor.

Each entry point is a :class:`Kernel` that counts its launches, so a run
can show that its main path went through the kernels
(``launch_counts`` / ``reset_launch_counts``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")


def _build_dir() -> str:
    """``build/torch_kernels`` in a checkout (the package's parent holds
    ``pyproject.toml``); a per-user cache directory for an installed
    package, whose site-packages is shared and often read-only."""
    root = os.path.dirname(_PKG_DIR)
    if os.path.isfile(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, "build", "torch_kernels")
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "quoracle_tpu_torch", "kernels")


BUILD_DIR = _build_dir()
SOURCES = ("flash_fwd.cu", "ragged_fwd.cu", "ragged_q8_fwd.cu",
           "paged_fwd.cu", "paged_prefill_fwd.cu")
HEADERS = ("common.cuh", "tc_attention.cuh", "split_kv.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Kernel:
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, name: str, source: str, replaces: str,
                 argtypes: list):
        self.name = name
        self.source = source          # path in the repository
        self.replaces = replaces      # the TPU kernel it ports, file:line
        self.argtypes = argtypes
        self.launches = 0

    def launch(self, *args) -> None:
        """Call the entry point; raise if the kernel did not launch."""
        fn = getattr(load_library(), self.name)
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA kernel launch failed with error {err} "
                f"({error_string(err)})")
        self.launches += 1


FLASH = Kernel(
    "flash_fwd", "quoracle_tpu_torch/csrc/flash_fwd.cu",
    "quoracle_tpu/ops/flash_attention.py:37",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P])
RAGGED = Kernel(
    "ragged_fwd", "quoracle_tpu_torch/csrc/ragged_fwd.cu",
    "quoracle_tpu/ops/paged_attention.py:642",
    [_P] * 7 + [_I] * 9 + [_F, _I, _P])
RAGGED_Q8 = Kernel(
    "ragged_q8_fwd", "quoracle_tpu_torch/csrc/ragged_q8_fwd.cu",
    "quoracle_tpu/ops/paged_attention.py:739",
    [_P] * 9 + [_I] * 9 + [_F, _I, _P])
PAGED = Kernel(
    "paged_fwd", "quoracle_tpu_torch/csrc/paged_fwd.cu",
    "quoracle_tpu/ops/paged_attention.py:173",
    [_P] * 9 + [_I] * 7 + [_F, _I, _P])
PAGED_PREFILL = Kernel(
    "paged_prefill_fwd", "quoracle_tpu_torch/csrc/paged_prefill_fwd.cu",
    "quoracle_tpu/ops/paged_attention.py:399",
    [_P] * 8 + [_I] * 9 + [_F, _I, _P])
KERNELS = (FLASH, RAGGED, RAGGED_Q8, PAGED, PAGED_PREFILL)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _sources_digest(nvcc: str) -> str:
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + "\0" + version).encode())
    for name in sorted(SOURCES + HEADERS):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(nvcc: str) -> str:
    return os.path.join(BUILD_DIR,
                        f"libqtt_kernels-{_sources_digest(nvcc)}.so")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the port's "
        "CUDA kernels build from source at first use")


_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> tuple[str, str]:
    """Compile and link the kernel library if this source hash has no
    build yet. Returns (library path, compiler log; empty when the cached
    build was used). Raises RuntimeError with the compiler output when a
    source fails to compile."""
    with _build_lock:
        nvcc = find_nvcc()
        path = library_path(nvcc)
        if os.path.isfile(path):
            return path, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        work = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
        try:
            procs, objs = [], []
            for src in SOURCES:
                obj = os.path.join(work, src.replace(".cu", ".o"))
                objs.append(obj)
                procs.append((src, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c",
                     os.path.join(CSRC_DIR, src), "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            log, failed = [], []
            for src, p in procs:
                out, _ = p.communicate()
                log.append(f"== {src}\n{out}")
                if p.returncode != 0:
                    failed.append(src)
            if failed:
                raise RuntimeError(
                    f"nvcc failed on {failed}:\n" + "\n".join(log))
            tmp_so = os.path.join(work, "lib.so")
            link = subprocess.run([nvcc, *ARCH, "-shared", *objs,
                                   "-o", tmp_so],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp_so, path)
            with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
                f.write("\n".join(log))
            return path, "\n".join(log)
        finally:
            shutil.rmtree(work, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    path, _ = build()
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(path)
            for k in KERNELS:
                fn = getattr(lib, k.name)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
            lib.qtt_error_string.argtypes = [ctypes.c_int]
            lib.qtt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load_library().qtt_error_string(err).decode()


def stream_handle(device) -> int:
    """The raw CUDA stream PyTorch is enqueueing on for ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
