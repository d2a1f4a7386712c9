"""Lazy native build: compile C++ sources to shared libraries with g++.

No pip/apt at runtime, so the toolchain contract is just "g++ exists". The
built .so is cached next to the sources and rebuilt when the source is newer
(mtime). Import never raises: callers get None on failure and are expected
to fall back to a Python implementation.

The port's copy of ``ray_tpu/_native/build.py``: it builds the port's own
copies of the sources into ``ray_tpu_torch/_native/_build/``, a cache of
its own. The C frontend (``capi.cc``) and the reference's sanitizer
build modes are not ported yet.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_lock = threading.Lock()
_cache: dict = {}


def _needs_build(src: str, out: str) -> bool:
    if not os.path.exists(out):
        return True
    # Sources #include each other (transfer.cc pulls in shm_store.cc), so
    # any newer .cc in the dir invalidates the build.
    newest = max(
        os.path.getmtime(os.path.join(_SRC_DIR, f))
        for f in os.listdir(_SRC_DIR) if f.endswith(".cc"))
    return newest > os.path.getmtime(out)


def build_native_library(name: str) -> Optional[str]:
    """Compile src/<name>.cc -> _build/lib<name>.so without dlopen'ing it;
    returns the .so path or None on failure."""
    src = os.path.join(_SRC_DIR, f"{name}.cc")
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    try:
        if _needs_build(src, out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = out + f".tmp.{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-Wall", "-o", tmp, src, "-lpthread", "-lrt"],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, out)  # atomic under concurrent builders
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def load_native_library(name: str) -> Optional[ctypes.CDLL]:
    """Builds (if stale) and dlopens src/<name>.cc -> _build/lib<name>.so."""
    with _lock:
        if name in _cache:
            return _cache[name]
        out = build_native_library(name)
        lib: Optional[ctypes.CDLL] = None
        if out is not None:
            try:
                lib = ctypes.CDLL(out)
            except OSError:
                lib = None
        _cache[name] = lib
        return lib
