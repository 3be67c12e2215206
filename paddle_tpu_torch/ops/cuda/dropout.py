"""Dropout forward: the CUDA kernel's wrapper and its plain version.

``csrc/dropout.cu`` draws the counter-hash keep mask of ops/rng.py
(``bits24`` over the op's key and each element's flat index) and applies
it in one pass over x, writing the output and the uint8 mask. The plain
version, ``dropout_reference``, computes the same function in PyTorch: the
same mask bit for bit, and the same output (``upscale_in_train`` divides
by 1 - rate, which PyTorch on the card computes as a product with the
rounded reciprocal, as the kernel does).

The TPU package draws dropout with ``jax.random`` inside an XLA fusion
(paddle_tpu/ops/nn_ops.py:263): there is no Pallas kernel to replace. The
kernel exists because the plain version's ~15 int64 elementwise passes
per element cost the pretraining step about 12 ms of device time on the
card.

Dispatch is by x's device, never by a fallback: a CUDA tensor goes to the
kernel (or raises), a CPU tensor to the plain version. ``launch_count``
counts the kernel's launches: the wrapper adds one where it launches the
kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import rng

KERNEL_SOURCE = "dropout.cu"

launch_count = 0


def launch_counts():
    return {"dropout_fwd": launch_count}


def _scale(rate: float) -> float:
    """1 / (1 - rate) as the card's PyTorch rounds a scalar divisor's
    reciprocal: in f32."""
    return float(np.float32(1.0) / np.float32(max(1.0 - rate, 1e-10)))


def dropout_reference(x: torch.Tensor, key: torch.Tensor, rate: float,
                      upscale: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: → (out, mask uint8), each element kept with
    probability 1 - rate (to 2^-24); kept elements are divided by
    1 - rate when ``upscale``, the others are 0."""
    keep = rng.keep_mask(key, x.shape, rate)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if upscale:
        o = torch.where(keep, x / max(1.0 - rate, 1e-10), zero) \
            if rate < 1.0 else torch.zeros_like(x)
    else:
        o = torch.where(keep, x, zero)
    return o, keep.to(torch.uint8)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import build
        lib = build.load(KERNEL_SOURCE)
        lib.paddle_dropout_fwd.argtypes = [
            ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_uint32, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_void_p]
        lib.paddle_dropout_fwd.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def dropout_cuda(x: torch.Tensor, key: torch.Tensor, rate: float,
                 upscale: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: → (out, mask uint8)."""
    global launch_count
    if not x.is_cuda or not key.is_cuda or x.device != key.device:
        raise ValueError("dropout kernel: x and its key must be CUDA "
                         "tensors on one device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dropout kernel takes f32 or bf16, got {x.dtype}")
    if key.dtype != torch.int64 or key.numel() != 1:
        raise ValueError("dropout kernel: the key is an int64 [1] tensor")
    n = x.numel()
    if n >= 1 << 32:
        raise ValueError(f"dropout kernel: {n} elements, at most 2^32 - 1")
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if n == 0:
        return out, mask
    align = 16 if x.dtype == torch.float32 else 8
    if x.data_ptr() % align:
        x = x.clone()  # a view at an odd offset: the kernel loads vectors
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.paddle_dropout_fwd(
            x.data_ptr(), key.data_ptr(), out.data_ptr(), mask.data_ptr(), n,
            int(x.dtype == torch.bfloat16), int(rate * float(1 << 24)),
            int(bool(upscale)), _scale(rate),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("dropout kernel launch failed: "
                           + lib.paddle_cuda_error_string(rc).decode())
    launch_count += 1
    return out, mask


def dropout(x: torch.Tensor, key: torch.Tensor, rate: float,
            upscale: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.is_cuda:
        return dropout_cuda(x, key, rate, upscale)
    return dropout_reference(x, key, rate, upscale)
