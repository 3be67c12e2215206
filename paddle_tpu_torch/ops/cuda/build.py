"""Build and load the package's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface. It is compiled
at first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/paddle_tpu_torch/`` at the repository root (listed in
.gitignore) and loaded with ctypes. The library's file name carries a
hash of its source, so an edited kernel is rebuilt and a stale one is
never loaded. A missing ``nvcc`` or a failed build raises with the
compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "build", "paddle_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# what the last build of each library took and what ptxas reported
build_log: Dict[str, dict] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels of paddle_tpu_torch are built from source at first "
        "use and need the CUDA toolkit")


def library_path(source: str) -> str:
    """The library's path, named by a hash of the source and of every
    shared header under ``csrc/`` (a header edit rebuilds its users)."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` into its shared library if it is not
    built yet; returns the library's path."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_log[source] = {"seconds": time.perf_counter() - t0,
                         "ptxas": proc.stderr}
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = ctypes.CDLL(build(source))
        return lib
