"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` holds its kernels and plain ``extern "C"``
launchers, so nvcc compiles it in seconds (no PyTorch headers). The build
happens at first use, into ``ray_tpu_torch/_build/`` (git-ignored), under a
name that carries a digest of the sources and flags, so an edited source is
never served from a stale library. ``build()`` starts one nvcc per stale
source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("rms_norm", "decode_attention", "softmax_xent",
           "flash_attention", "paged_decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME`` (default /usr/local/cuda), else from PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "ray_tpu_torch: nvcc not found (set CUDA_HOME); the CUDA kernels are "
        "built from csrc/ at first use on a machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one nvcc each,
    all started together. Returns {name: {"seconds", "log", "cached"}}, the
    log being nvcc's output (ptxas's registers and spills), kept beside the
    library for a cached one; raises RuntimeError with nvcc's output if any
    build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    try:
        for name in names:
            path = lib_path(name)
            if path.exists():
                saved = path.with_suffix(".log")
                out[name] = {"seconds": 0.0, "cached": True,
                             "log": saved.read_text() if saved.exists()
                             else ""}
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path, time.perf_counter())
        for name, (proc, tmp, path, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{log}")
            path.with_suffix(".log").write_text(log)   # ptxas's report
            os.replace(tmp, path)   # atomic: concurrent builders agree
            out[name] = {"seconds": time.perf_counter() - t0, "log": log,
                         "cached": False}
    finally:
        for proc, tmp, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return out


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The kernel library, built first if needed (thread-safe).
    ``signatures`` maps each C function to (argtypes, restype), declared
    once when the library is first loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn_name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
        return lib
