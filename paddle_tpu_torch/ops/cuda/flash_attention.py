"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/flash_attention.py
(`_fwd_kernel` / `_pallas_fwd`, :219 / :298). The kernel is
``csrc/flash_attention_fwd.cu`` (CUDA C++ for sm_90a, built at first use by
``build.py``); its header says what bounds it and how it is laid out.

Dispatch is by the tensors' device, never by a fallback: a CUDA tensor goes
to the kernel (or raises), a CPU tensor goes to the plain PyTorch version
``flash_attention_reference`` below, which computes the same function —
the key-padding bias clamp, top-left causal masking, the counter-hash
dropout mask and the dead-row rule included. The CPU tests hold the plain
version against the Pallas kernel; chip_smoke.py holds the kernel against
the plain version on the card.

``launch_count`` counts the kernel's launches: the wrapper adds one where
it launches and nowhere else.

The backward kernels (`_bwd_kv_kernel`, `_bwd_q_kernel`) come with the
training slice; this module is forward only.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite mask value: avoids inf-inf → NaN in the rescale
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
KERNEL_SOURCE = "flash_attention_fwd.cu"

launch_count = 0

_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# the counter-hash dropout mask (`_keep_mask`, flash_attention.py:149)
# --------------------------------------------------------------------------
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow: c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def keep_mask(seed: int, bh, rows, cols, rate: float) -> torch.Tensor:
    """Dropout keep mask over (seed, batch·head, absolute row, absolute
    col): the Wang-style uint32 mix of the TPU kernel, bit for bit. ``bh``,
    ``rows`` and ``cols`` are int tensors that broadcast against each
    other; the result is a bool tensor of their broadcast shape."""
    bh, rows, cols = (torch.as_tensor(t).to(torch.int64) & _M32
                      for t in (bh, rows, cols))
    x = (_mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77)
         ^ ((int(seed) + _mul32(bh, 0x27D4EB2F)) & _M32))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x & 0xFFFFFF) >= _keep_threshold(rate)


def _keep_threshold(rate: float) -> int:
    return int(rate * float(1 << 24))


def _seed_value(dropout_seed) -> int:
    if isinstance(dropout_seed, torch.Tensor):
        return int(dropout_seed.reshape(-1)[0].item())
    return int(dropout_seed)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------
def flash_attention_reference(q, k, v, sm_scale, causal=False,
                              dropout_rate=0.0, dropout_seed=None,
                              bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: q [B,H,S,D], k/v [B,H,Sk,D],
    bias [B,Sk] or None → (o [B,H,S,D] in q.dtype, lse [B·H,S] f32).
    Scores, softmax statistics and the PV product accumulate in f32;
    with bf16 operands P enters the PV product rounded to bf16, as in the
    kernel."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + torch.clamp(bias.float(), min=NEG_INF)[:, None, None, :]
    if causal:
        rows = torch.arange(S, device=dev)[:, None]
        cols = torch.arange(Sk, device=dev)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = keep_mask(_seed_value(dropout_seed),
                         torch.arange(B * H, device=dev).reshape(B, H, 1, 1),
                         torch.arange(S, device=dev)[:, None],
                         torch.arange(Sk, device=dev)[None, :], dropout_rate)
        p = p * keep.to(p.dtype) / (1.0 - dropout_rate)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    dead = m <= NEG_INF * 0.5
    o = torch.where(dead, torch.zeros((), device=dev), o).to(q.dtype)
    lse = torch.where(dead, torch.full((), -NEG_INF, device=dev),
                      m + torch.log(l))
    return o, lse.reshape(B * H, S)


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------
_lib = None


def _library():
    global _lib
    if _lib is None:
        from . import build
        lib = build.load(KERNEL_SOURCE)
        fn = lib.paddle_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_uint32, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda_inputs(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k and v must all be CUDA "
                         "tensors or all CPU tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes f32 or bf16 operands "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {q.shape[3]} "
                         f"not in {SUPPORTED_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel: q, k, v must be "
                         "contiguous [B, H, S, D]")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError("flash_attention kernel: B*H above the grid limit "
                         "65535")


def flash_attention_cuda(q, k, v, sm_scale, causal=False, dropout_rate=0.0,
                         dropout_seed=None,
                         bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream: → (o, lse)."""
    global launch_count
    _check_cuda_inputs(q, k, v)
    B, H, S, D = q.shape
    Sk = k.shape[2]
    dev = q.device
    if bias is not None:
        if tuple(bias.shape) != (B, Sk):
            raise ValueError(f"flash_attention: bias must be [B, Sk] = "
                             f"{[B, Sk]}, got {list(bias.shape)}")
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    seed = None
    if dropout_rate > 0.0:
        seed = (dropout_seed.to(device=dev, dtype=torch.int32).reshape(1)
                if isinstance(dropout_seed, torch.Tensor)
                else torch.tensor([int(dropout_seed)], dtype=torch.int32,
                                  device=dev)).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=dev)
    if S == 0:
        return o, lse
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paddle_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if seed is None else seed.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, H, S, Sk, D,
            int(q.dtype == torch.bfloat16), float(sm_scale), int(causal),
            int(dropout_rate > 0.0), float(1.0 - dropout_rate),
            _keep_threshold(dropout_rate), stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.paddle_cuda_error_string(rc).decode())
    launch_count += 1
    return o, lse


# --------------------------------------------------------------------------
# entry
# --------------------------------------------------------------------------
def flash_attention_fwd(q, k, v, sm_scale, causal=False, dropout_rate=0.0,
                        dropout_seed=None, bias=None):
    """(o, lse): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, sm_scale, causal, dropout_rate,
                                    dropout_seed, bias)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return flash_attention_reference(q, k, v, sm_scale, causal,
                                     dropout_rate, dropout_seed, bias)


def flash_attention(q, k, v, sm_scale, causal=False, dropout_rate=0.0,
                    dropout_seed=None, bias: Optional[torch.Tensor] = None):
    """q,k,v: [B,H,S,D] → [B,H,S,D] (entry rules of the TPU package's
    flash_attention, :673). ``bias`` is an additive key-padding mask
    [B, Sk] broadcast over query rows; dropout_rate > 0 applies the
    counter-hash attention dropout inside the kernel and needs
    ``dropout_seed`` (an int32 [1] tensor or an int)."""
    if dropout_rate > 0.0 and dropout_seed is None:
        # a silent default seed would drop the SAME attention entries
        # every step — training bias with no symptom
        raise ValueError(
            "flash_attention: dropout_rate > 0 requires dropout_seed "
            "(int32 [1] tensor, fresh per training step)")
    if not (q.dtype == k.dtype == v.dtype):
        ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = (t.to(ct) for t in (q, k, v))
    o, _ = flash_attention_fwd(q, k, v, sm_scale, causal,
                               float(dropout_rate), dropout_seed, bias)
    return o
