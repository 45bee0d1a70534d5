"""Native (C++) components of the port and their pure-Python fallbacks.

* bpe.cpp       byte-level BPE encoder (a C API), the port's copy of the
                JAX package's; built at first use with ``g++``
* tokenizer.py  its ctypes binding (``NativeBPETokenizer``) and the
                identical pure-Python path, which serves only when the
                build fails (no ``g++``), with a warning
* image.cpp     PNG decode and bilinear resize for the VLM tower, a copy
                of the JAX package's; built with ``-lz``
* image.py      its ctypes binding and the Python path (stdlib ``zlib``,
                numpy), which serves only when the build fails

``build_and_load`` compiles one C++ file into ``build/native/`` at the
repository root (for an installed package, the user's cache directory),
never beside the source. The shared object's name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the cached build.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional, Sequence

from quoracle_tpu_torch.infra.locks import named_lock

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


def _build_dir() -> str:
    """``build/native`` in a checkout (the package's parent holds
    ``pyproject.toml``); a per-user cache directory for an installed
    package."""
    root = os.path.dirname(_PKG_DIR)
    if os.path.isfile(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, "build", "native")
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "quoracle_tpu_torch", "native")


BUILD_DIR = _build_dir()
_build_lock = named_lock("native.build")


def so_path(src_path: str, extra_flags: Sequence[str] = (),
            build_dir: Optional[str] = None) -> str:
    """Where ``src_path``'s build lives: its stem and a hash of its bytes
    and the flags."""
    h = hashlib.sha256()
    with open(src_path, "rb") as f:
        h.update(f.read())
    h.update(" ".join((*CXX_FLAGS, *extra_flags)).encode())
    stem = os.path.splitext(os.path.basename(src_path))[0]
    return os.path.join(build_dir or BUILD_DIR,
                        f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_and_load(src_path: str, extra_flags: Sequence[str] = (),
                   build_dir: Optional[str] = None
                   ) -> Optional[ctypes.CDLL]:
    """Compile a single-file C++ shared object unless its build is cached,
    and dlopen it. Returns None, with a warning, when the compiler is
    missing or fails or the object does not load: callers fall back to
    their pure-Python implementation.

    The library is loaded as a ``ctypes.PyDLL``: its calls keep the GIL,
    as the pure-Python path does. They take microseconds, and releasing
    the GIL around each would hand the serving threads (a batcher's
    loop, the pool members) a switch at every prompt encode."""
    path = so_path(src_path, extra_flags, build_dir)
    with _build_lock:
        if not os.path.isfile(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # per-pid temp name: the lock serializes this process's
            # threads only; two processes building at once must not write
            # one temp file before the atomic rename
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src_path,
                                *extra_flags],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError) as e:
                logger.warning("native build of %s failed (%s); using the "
                               "Python fallback",
                               os.path.basename(src_path), e)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
    try:
        return ctypes.PyDLL(path)
    except OSError as e:
        logger.warning("loading %s failed (%s); using the Python fallback",
                       path, e)
        return None
