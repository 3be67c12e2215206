"""The native data feed (counterpart of paddle_tpu/native; reference: the C++
data feed of framework/data_feed.cc and data_set.h): ``datafeed.cpp``, a
copy of the TPU package's source byte for byte, parses slot files on N
threads, shuffles in memory and packs batches with their LoD offsets.

It is compiled at first use with ``g++ -O2 -std=c++17 -shared -fPIC
-pthread`` into ``build/paddle_tpu_torch/`` at the repository root (listed
in .gitignore) and loaded with ctypes. The library's file name carries a
hash of its source, so an edited source is rebuilt and a stale library is
never loaded. A failed build raises with g++'s output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "paddle_tpu_torch")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_loaded = {}


def library_path(name: str) -> str:
    with open(os.path.join(_DIR, name + ".cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile ``<name>.cpp`` into its shared library unless it is built
    already; returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, os.path.join(_DIR, name + ".cpp"), "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build {name}.cpp (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def datafeed_lib() -> ctypes.CDLL:
    """The data feed's library with its C signatures set (the TPU
    package's native/__init__.py:105-129)."""
    with _lock:
        lib = _loaded.get("datafeed")
        if lib is not None:
            return lib
        lib = ctypes.CDLL(build("datafeed"))
        c = ctypes
        lib.df_create.restype = c.c_void_p
        lib.df_create.argtypes = [c.c_char_p]
        lib.df_set_filelist.argtypes = [c.c_void_p,
                                        c.POINTER(c.c_char_p), c.c_int]
        lib.df_set_batch.argtypes = [c.c_void_p, c.c_int]
        lib.df_set_threads.argtypes = [c.c_void_p, c.c_int]
        lib.df_load_into_memory.argtypes = [c.c_void_p]
        lib.df_local_shuffle.argtypes = [c.c_void_p, c.c_uint64]
        lib.df_epoch_begin.argtypes = [c.c_void_p]
        lib.df_next_batch.restype = c.c_int
        lib.df_next_batch.argtypes = [c.c_void_p]
        lib.df_slot_total.restype = c.c_int64
        lib.df_slot_total.argtypes = [c.c_void_p, c.c_int]
        lib.df_slot_copy.argtypes = [c.c_void_p, c.c_int, c.c_void_p,
                                     c.POINTER(c.c_int64)]
        lib.df_memory_size.restype = c.c_int64
        lib.df_memory_size.argtypes = [c.c_void_p]
        lib.df_release.argtypes = [c.c_void_p]
        _loaded["datafeed"] = lib
        return lib
