"""Flash attention: the CUDA kernels' wrappers, their plain versions and
the autograd Function that joins them.

Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
the forward (`_fwd_kernel` / `_pallas_fwd`, :219 / :298) is
``csrc/flash_attention_fwd.cu``; the backward's dK/dV kernel
(`_bwd_kv_kernel`, pallas_call :514) and dQ kernel (`_bwd_q_kernel`,
pallas_call :543) are ``csrc/flash_attention_bwd.cu``. All three are CUDA
C++ for sm_90a that run their products on the tensor cores (``mma.sync``:
split TF32 for f32, bf16 as it is; ``csrc/tc_common.cuh``). Where one block
holds a (batch, head)'s whole key range in bf16 (S and Sk up to 128, every
BERT path; ``holds_whole``), two kernels on wgmma and TMA
(``csrc/hopper_common.cuh``) take their place: the whole-block forward
``csrc/flash_attention_fwd_whole.cu`` (one softmax pass over all keys),
and the fused backward ``csrc/flash_attention_bwd_fused.cu`` in place of
both backward kernels and of the delta prologue (:492). In bf16 above
128, where no block holds a (batch, head) whole, three more kernels on
wgmma and TMA stream the keys (or the query rows) through a two-stage ring
of shared memory: the streamed forward ``csrc/flash_attention_fwd_streamed.cu``
(an online softmax across 128-key tiles), and the streamed backward
``csrc/flash_attention_bwd_streamed.cu``, a dQ kernel that takes delta
itself, then a dK/dV kernel. In f32 at head dims up to 64 (every f32
path), three kernels on split-TF32 wgmma and TMA take the place of the
tiled forward and of the split route's two kernels: the forward
``csrc/flash_attention_fwd_f32.cu``, the dQ kernel
``csrc/flash_attention_bwd_dq_f32.cu``, which takes delta itself (the
delta prologue, :492) and writes it, and the dK/dV kernel
``csrc/flash_attention_bwd_dkdv_f32.cu``, which reads that delta.
``fwd_route`` picks by shape and dtype alone, "whole", "streamed", "f32"
or "tiled" (f32 at head dims 65 to 128: the tiled forward), and
``bwd_route`` maps its answer ("fused", "streamed", "f32", "split"). The
tiled forward and the split backward (``bwd_delta``, then the dK/dV and
dQ kernels of ``csrc/flash_attention_bwd.cu``) stay callable as the old
route (``flash_attention_fwd_tiled_cuda``,
``flash_attention_bwd_split_cuda``).
Every source is built at first use by ``build.py``; each source's header
says what bounds it and how it is laid out. All share the counter-hash
dropout mask (``csrc/keep_mask.cuh``), so the backward regenerates the
forward's mask.

Dispatch is by the tensors' device, never by a fallback: a CUDA tensor goes
to the kernels (or raises), a CPU tensor goes to the plain PyTorch versions
``flash_attention_reference`` and ``flash_attention_bwd_reference`` below,
which compute the same functions — the key-padding bias clamp, top-left
causal masking, the counter-hash dropout mask, the dead-row rule and the
operand-dtype rounding points included. The CPU tests hold the plain
versions against the Pallas kernels; chip_smoke.py holds the kernels
against the plain versions on the card.

Any head dim up to 128 and any B·H run on the kernels: the wrappers pad a
head dim the kernels have no instance for with zero columns to the next
one (``kernel_head_dim``; exact, the padded columns are sliced off), and
each kernel walks one linear grid of (batch·head, 64-row tile) blocks. A
head dim above 128, or a dtype other than f32 and bf16, raises on CUDA
tensors: there is no instance, and nothing falls back to a plain version
on the card.

``flash_attention`` is differentiable through ``FlashAttentionFunction``
(the counterpart of `_flash_pallas`'s custom vjp, :639-666): its residual
is (q, k, v, o, lse, seed, bias); the bias gets a zero grad and the seed
none.

``launch_count`` (the tiled forward), ``fwd_whole_launch_count``,
``bwd_kv_launch_count``, ``bwd_q_launch_count``,
``bwd_fused_launch_count``, ``fwd_streamed_launch_count``,
``bwd_dq_streamed_launch_count``, ``bwd_dkdv_streamed_launch_count``,
``fwd_f32_launch_count``, ``bwd_dkdv_f32_launch_count`` and
``bwd_dq_f32_launch_count`` count each
kernel's launches: a wrapper adds one where it launches its
kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite mask value: avoids inf-inf → NaN in the rescale
# the head dims each kernel is instantiated for; any other D up to the
# largest runs at the next one, zero-padded (``kernel_head_dim``)
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_HEAD_DIM = SUPPORTED_HEAD_DIMS[-1]
KERNEL_SOURCE = "flash_attention_fwd.cu"
BWD_KERNEL_SOURCE = "flash_attention_bwd.cu"
BWD_FUSED_SOURCE = "flash_attention_bwd_fused.cu"
FWD_WHOLE_SOURCE = "flash_attention_fwd_whole.cu"
FWD_STREAMED_SOURCE = "flash_attention_fwd_streamed.cu"
BWD_STREAMED_SOURCE = "flash_attention_bwd_streamed.cu"
FWD_F32_SOURCE = "flash_attention_fwd_f32.cu"
BWD_DKDV_F32_SOURCE = "flash_attention_bwd_dkdv_f32.cu"
BWD_DQ_F32_SOURCE = "flash_attention_bwd_dq_f32.cu"
# the whole-block kernels (the forward and the fused backward) hold a
# (batch, head)'s query rows and keys in one block
WHOLE_MAX_LEN = 128
# the f32 kernels on wgmma (the forward, dQ and dK/dV) have instances up to
# this head dim; f32 above it runs the tiled forward and the split route
F32_MAX_HEAD_DIM = 64
# the shared memory a block may ask for on an H100 (227 KB)
SMEM_LIMIT = 232448

launch_count = 0
fwd_whole_launch_count = 0
bwd_kv_launch_count = 0
bwd_q_launch_count = 0
bwd_fused_launch_count = 0
fwd_streamed_launch_count = 0
bwd_dq_streamed_launch_count = 0
bwd_dkdv_streamed_launch_count = 0
fwd_f32_launch_count = 0
bwd_dkdv_f32_launch_count = 0
bwd_dq_f32_launch_count = 0


def launch_counts():
    """Each kernel's launch count by name. A CUDA graph replays the
    launches it captured without calling a wrapper: the executor reads
    these counts around a capture to know what each replay launches."""
    return {"flash_attention_fwd": launch_count,
            "flash_attention_fwd_whole": fwd_whole_launch_count,
            "flash_attention_bwd_kv": bwd_kv_launch_count,
            "flash_attention_bwd_q": bwd_q_launch_count,
            "flash_attention_bwd_fused": bwd_fused_launch_count,
            "flash_attention_fwd_streamed": fwd_streamed_launch_count,
            "flash_attention_bwd_dq_streamed": bwd_dq_streamed_launch_count,
            "flash_attention_bwd_dkdv_streamed":
                bwd_dkdv_streamed_launch_count,
            "flash_attention_fwd_f32": fwd_f32_launch_count,
            "flash_attention_bwd_dkdv_f32": bwd_dkdv_f32_launch_count,
            "flash_attention_bwd_dq_f32": bwd_dq_f32_launch_count}


_M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# the counter-hash dropout mask (`_keep_mask`, flash_attention.py:149)
# --------------------------------------------------------------------------
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow: c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def keep_mask(seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """Dropout keep mask over (seed, batch·head, absolute row, absolute
    col): the Wang-style uint32 mix of the TPU kernel, bit for bit. ``bh``,
    ``rows`` and ``cols`` are int tensors that broadcast against each
    other; the result is a bool tensor of their broadcast shape. ``seed``
    is an int, or an int32 [1] tensor on the mask's device, which is read
    there and not on the host (a CUDA graph can capture the mask)."""
    bh, rows, cols = (torch.as_tensor(t).to(torch.int64) & _M32
                      for t in (bh, rows, cols))
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1)[:1].to(torch.int64)
    else:
        seed = int(seed)
    x = (_mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77)
         ^ ((seed + _mul32(bh, 0x27D4EB2F)) & _M32))
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


def bwd_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO ∘ O) in f32 (`_pallas_bwd`, :492), as [B·H, S]:
    taken from the O the forward wrote. A torch expression, not a kernel."""
    B, H, S, _ = o.shape
    return (o.float() * do.float()).sum(-1).reshape(B * H, S)


def _bwd_probs(q, k, v, do, lse, delta, sm_scale, causal, dropout_rate,
               dropout_seed, bias):
    """The two backward kernels' shared recomputation, step by step as in
    `_bwd_kv_kernel` / `_bwd_q_kernel` (:369-405, :445-464), in f32:
    P = exp(scale·QKᵀ + bias − lse) with the forward's masks, dP = dO·Vᵀ,
    P′ and dP′ after the regenerated dropout mask and its 1/(1−rate),
    dS = P∘(dP′ − delta)·scale. Returns (P′, dS), each [B, H, S, Sk]."""
    B, H, S, _ = q.shape
    Sk = k.shape[2]
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + torch.clamp(bias.float(), min=NEG_INF)[:, None, None, :]
    if causal:
        rows = torch.arange(S, device=dev)[:, None]
        cols = torch.arange(Sk, device=dev)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    # dead rows carry lse = +1e30, so their P underflows to 0
    p = torch.exp(s - lse.reshape(B, H, S, 1))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_eff = p
    if dropout_rate > 0.0:
        keep = keep_mask(_seed_value(dropout_seed),
                         torch.arange(B * H, device=dev).reshape(B, H, 1, 1),
                         torch.arange(S, device=dev)[:, None],
                         torch.arange(Sk, device=dev)[None, :],
                         dropout_rate).to(torch.float32)
        p_eff = p * keep / (1.0 - dropout_rate)
        dp = dp * keep / (1.0 - dropout_rate)
    ds = p * (dp - delta.reshape(B, H, S, 1)) * sm_scale
    return p_eff, ds


def flash_attention_bwd_kv_reference(q, k, v, do, lse, delta, sm_scale,
                                     causal=False, dropout_rate=0.0,
                                     dropout_seed=None, bias=None):
    """Plain version of the dK/dV kernel: dV = P′ᵀ·dO with P′ rounded to
    dO's dtype (:397), dK = dSᵀ·Q with dS rounded to q's dtype (:405);
    sums in f32, results in k's / v's dtype."""
    p_eff, ds = _bwd_probs(q, k, v, do, lse, delta, sm_scale, causal,
                           dropout_rate, dropout_seed, bias)
    dv = torch.matmul(p_eff.to(do.dtype).float().transpose(-1, -2),
                      do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_q_reference(q, k, v, do, lse, delta, sm_scale,
                                    causal=False, dropout_rate=0.0,
                                    dropout_seed=None, bias=None):
    """Plain version of the dQ kernel: dQ = dS·K with dS rounded to k's
    dtype (:465); sums in f32, the result in q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, sm_scale, causal,
                       dropout_rate, dropout_seed, bias)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, sm_scale,
                                  causal=False, dropout_rate=0.0,
                                  dropout_seed=None, bias=None):
    """Plain version of the whole backward (`_pallas_bwd`, :480): q/o/do
    [B,H,S,D], k/v [B,H,Sk,D], lse [B·H,S] from the forward → (dq, dk, dv)
    in q's, k's and v's dtypes."""
    delta = bwd_delta(o, do)
    dk, dv = flash_attention_bwd_kv_reference(
        q, k, v, do, lse, delta, sm_scale, causal, dropout_rate,
        dropout_seed, bias)
    dq = flash_attention_bwd_q_reference(
        q, k, v, do, lse, delta, sm_scale, causal, dropout_rate,
        dropout_seed, bias)
    return dq, dk, dv


def flash_attention_bwd_dq_f32_reference(q, k, v, o, lse, do, sm_scale,
                                         causal=False, dropout_rate=0.0,
                                         dropout_seed=None, bias=None):
    """Plain version of the f32 dQ kernel, which takes delta itself:
    delta = rowsum(dO∘O) (:492), then dQ = dS·K (:465) → (dq, delta
    [B·H, S] f32)."""
    delta = bwd_delta(o, do)
    dq = flash_attention_bwd_q_reference(q, k, v, do, lse, delta, sm_scale,
                                         causal, dropout_rate, dropout_seed,
                                         bias)
    return dq, delta


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------
_PTR, _INT, _F32, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint32)
_TAIL = [_INT] * 6 + [_F32, _INT, _INT, _F32, _U32, _PTR]
# each source's C entry points and their argument types
_SIGNATURES = {
    KERNEL_SOURCE: {"paddle_flash_attention_fwd": [_PTR] * 7 + _TAIL},
    FWD_WHOLE_SOURCE: {"paddle_flash_attention_fwd_whole": [_PTR] * 7 + _TAIL},
    BWD_KERNEL_SOURCE: {"paddle_flash_attention_bwd_kv": [_PTR] * 10 + _TAIL,
                        "paddle_flash_attention_bwd_q": [_PTR] * 9 + _TAIL},
    BWD_FUSED_SOURCE: {
        "paddle_flash_attention_bwd_fused": [_PTR] * 11 + _TAIL},
    FWD_STREAMED_SOURCE: {
        "paddle_flash_attention_fwd_streamed": [_PTR] * 7 + _TAIL},
    BWD_STREAMED_SOURCE: {
        "paddle_flash_attention_bwd_dq_streamed": [_PTR] * 10 + _TAIL,
        "paddle_flash_attention_bwd_dkdv_streamed": [_PTR] * 9 + _TAIL},
    FWD_F32_SOURCE: {"paddle_flash_attention_fwd_f32": [_PTR] * 7 + _TAIL},
    BWD_DKDV_F32_SOURCE: {
        "paddle_flash_attention_bwd_dkdv_f32": [_PTR] * 10 + _TAIL},
    BWD_DQ_F32_SOURCE: {
        "paddle_flash_attention_bwd_dq_f32": [_PTR] * 10 + _TAIL},
}
_libs = {}


def _library(source: str):
    lib = _libs.get(source)
    if lib is None:
        from . import build
        lib = build.load(source)
        for name, argtypes in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.paddle_cuda_error_string(rc).decode())


def kernel_head_dim(d: int) -> Optional[int]:
    """The instance a head dim ``d`` runs at: the smallest supported head
    dim ≥ d, or None above MAX_HEAD_DIM. A padded head dim is exact: the
    zero columns add exact zeros to QKᵀ and give zero columns of O, dQ,
    dK and dV, which the wrappers slice off (sm_scale is always passed,
    never derived from D)."""
    for dp in SUPPORTED_HEAD_DIMS:
        if d <= dp:
            return dp
    return None


def holds_whole(q_shape, k_shape, dtype) -> bool:
    """Whether one block of the whole-block kernels holds a (batch, head)
    of q [B, H, S, D], k [B, H, Sk, D] of ``dtype`` whole: bf16, S and Sk
    up to WHOLE_MAX_LEN, at a head dim the kernels take."""
    S, Sk, d = q_shape[2], k_shape[2], q_shape[3]
    return (dtype == torch.bfloat16 and S <= WHOLE_MAX_LEN
            and Sk <= WHOLE_MAX_LEN and kernel_head_dim(d) is not None)


def fwd_route(q_shape, k_shape, dtype) -> str:
    """Which forward runs on the card: "whole" (one block a (batch, head),
    one softmax pass over all its keys) where ``holds_whole``; "streamed"
    (128 query rows a block, an online softmax over 128-key tiles) for the
    rest of bf16 at a head dim the kernels take (S or Sk above
    WHOLE_MAX_LEN); "f32" (64 query rows a block on split-TF32 wgmma, any
    S and Sk) for f32 at head dims up to F32_MAX_HEAD_DIM; else "tiled"
    (64-row query tiles on mma.sync: f32 at head dims 65 to 128, whose
    hi, lo and transposed tiles the f32 kernels do not hold, and what no
    kernel takes, which raises in the tiled wrapper). A choice by shape
    between kernels, never a fallback. ``bwd_route`` maps this answer, so
    the forward and the backward never disagree."""
    if holds_whole(q_shape, k_shape, dtype):
        return "whole"
    dp = kernel_head_dim(q_shape[3])
    if dtype == torch.bfloat16 and dp is not None:
        return "streamed"
    if dtype == torch.float32 and dp is not None and dp <= F32_MAX_HEAD_DIM:
        return "f32"
    return "tiled"


_BWD_OF_FWD = {"whole": "fused", "streamed": "streamed", "f32": "f32",
               "tiled": "split"}


def bwd_route(q_shape, k_shape, dtype) -> str:
    """Which backward runs on the card, the one of ``fwd_route``'s answer:
    "fused" (one kernel: delta, dQ, dK and dV), "streamed" (the dQ kernel
    with delta inside, then the dK/dV kernel), "f32" (the wgmma dQ kernel
    with delta inside, then the wgmma dK/dV kernel on the delta it wrote)
    or "split" (delta in torch passes, then the dK/dV and the dQ
    kernels)."""
    return _BWD_OF_FWD[fwd_route(q_shape, k_shape, dtype)]


def fwd_f32_smem_bytes(dp: int) -> int:
    """Shared memory a block of the f32 forward asks for at instance
    ``dp`` (32 or 64), as its source lays it out: five [64][dp] f32 tiles
    (Q as it lands, K and V^T each hi and lo), two mbarriers, 1024 bytes
    to align."""
    return 5 * 64 * dp * 4 + 2 * 8 + 1024


def bwd_dkdv_f32_smem_bytes(dp: int) -> int:
    """Shared memory a block of the f32 dK/dV kernel asks for at instance
    ``dp``: K and V hi and lo and the next K and V as they land ([64][dp]
    f32 each), a ring slot for each of two warpgroups of Q, dO and their
    transposes hi and lo ([32][dp] each), three mbarriers, 1024 bytes to
    align."""
    return 6 * 64 * dp * 4 + 2 * 8 * 32 * dp * 4 + 3 * 8 + 1024


def bwd_dq_f32_smem_bytes(dp: int) -> int:
    """Shared memory a block of the f32 dQ kernel asks for at instance
    ``dp``: for each of two warpgroups Q and dO hi and lo ([64][dp] f32
    each), a ring slot of K, V and K^T hi and lo ([32][dp] each) and delta
    of 64 rows; four mbarriers, 1024 bytes to align."""
    return 2 * (4 * 64 * dp * 4 + 6 * 32 * dp * 4 + 64 * 4) + 4 * 8 + 1024


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` [..., D] zero-padded to [..., dp], contiguous."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


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
    if kernel_head_dim(q.shape[3]) is None:
        raise ValueError(f"flash_attention kernel: head dim {q.shape[3]} "
                         f"above {MAX_HEAD_DIM}: no kernel instance")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel: q, k, v must be "
                         "contiguous [B, H, S, D]")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    tiles = -(-max(q.shape[2], k.shape[2]) // 64) * q.shape[0] * q.shape[1]
    if tiles >= 2 ** 31:
        raise ValueError("flash_attention kernel: more than 2^31 - 1 blocks "
                         "of 64 rows over B*H")


def _device_bias_seed(bias, dropout_rate, dropout_seed, B, Sk, dev):
    """The bias as contiguous f32 [B, Sk] and the seed as int32 [1], both
    on ``dev`` (the seed only when dropout is on)."""
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
    return bias, seed


def _common_args(q, k, sm_scale, causal, dropout_rate):
    """The scalar tail every C entry point takes, from B to the stream."""
    B, H, S, D = q.shape
    dev = q.device
    return (B, H, S, k.shape[2], D, int(q.dtype == torch.bfloat16),
            float(sm_scale), int(causal), int(dropout_rate > 0.0),
            float(1.0 - dropout_rate), _keep_threshold(dropout_rate),
            torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_cuda(q, k, v, sm_scale, causal=False, dropout_rate=0.0,
                         dropout_seed=None,
                         bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the card → (o, lse), by ``fwd_route``: the
    whole-block kernel, the streamed one, the f32 one or the tiled one."""
    fn = {"whole": flash_attention_fwd_whole_cuda,
          "streamed": flash_attention_fwd_streamed_cuda,
          "f32": flash_attention_fwd_f32_cuda,
          "tiled": flash_attention_fwd_tiled_cuda}[
        fwd_route(q.shape, k.shape, q.dtype)]
    return fn(q, k, v, sm_scale, causal, dropout_rate, dropout_seed, bias)


def flash_attention_fwd_tiled_cuda(q, k, v, sm_scale, causal=False,
                                   dropout_rate=0.0, dropout_seed=None,
                                   bias=None):
    """Launch the tiled forward kernel on the current stream (f32 or bf16,
    any S and Sk): → (o, lse)."""
    global launch_count
    _check_cuda_inputs(q, k, v)
    B, H, S, D = q.shape
    dp = kernel_head_dim(D)
    if dp != D:
        o, lse = flash_attention_fwd_tiled_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v)), sm_scale, causal,
            dropout_rate, dropout_seed, bias)
        return o[..., :D].contiguous(), lse
    dev = q.device
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed, B,
                                   k.shape[2], dev)
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=dev)
    if S == 0:
        return o, lse
    lib = _library(KERNEL_SOURCE)
    with torch.cuda.device(dev):
        rc = lib.paddle_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(seed),
            o.data_ptr(), lse.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention forward")
    launch_count += 1
    return o, lse


def flash_attention_fwd_whole_cuda(q, k, v, sm_scale, causal=False,
                                   dropout_rate=0.0, dropout_seed=None,
                                   bias=None):
    """Launch the whole-block forward kernel on the current stream (bf16,
    S and Sk up to WHOLE_MAX_LEN): one block a (batch, head) → (o, lse). A
    head dim off the instances is padded with zero columns."""
    global fwd_whole_launch_count
    _check_cuda_inputs(q, k, v)
    if fwd_route(q.shape, k.shape, q.dtype) != "whole":
        raise ValueError(f"flash_attention whole-block forward: takes bf16 "
                         f"with S, Sk <= {WHOLE_MAX_LEN}, got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")
    B, H, S, D = q.shape
    dp = kernel_head_dim(D)
    if dp != D:
        o, lse = flash_attention_fwd_whole_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v)), sm_scale, causal,
            dropout_rate, dropout_seed, bias)
        return o[..., :D].contiguous(), lse
    dev = q.device
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed, B,
                                   k.shape[2], dev)
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=dev)
    if S == 0:
        return o, lse
    lib = _library(FWD_WHOLE_SOURCE)
    with torch.cuda.device(dev):
        rc = lib.paddle_flash_attention_fwd_whole(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(seed),
            o.data_ptr(), lse.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention whole-block forward")
    fwd_whole_launch_count += 1
    return o, lse


def flash_attention_fwd_streamed_cuda(q, k, v, sm_scale, causal=False,
                                      dropout_rate=0.0, dropout_seed=None,
                                      bias=None):
    """Launch the streamed forward kernel on the current stream (bf16, S
    or Sk above WHOLE_MAX_LEN): one block a (batch, head, 128 query rows),
    the keys streamed in 128-key tiles → (o, lse). A head dim off the
    instances is padded with zero columns."""
    global fwd_streamed_launch_count
    _check_cuda_inputs(q, k, v)
    if fwd_route(q.shape, k.shape, q.dtype) != "streamed":
        raise ValueError(f"flash_attention streamed forward: takes bf16 "
                         f"with S or Sk above {WHOLE_MAX_LEN}, got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")
    B, H, S, D = q.shape
    dp = kernel_head_dim(D)
    if dp != D:
        o, lse = flash_attention_fwd_streamed_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v)), sm_scale, causal,
            dropout_rate, dropout_seed, bias)
        return o[..., :D].contiguous(), lse
    dev = q.device
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed, B,
                                   k.shape[2], dev)
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=dev)
    if S == 0:
        return o, lse
    lib = _library(FWD_STREAMED_SOURCE)
    with torch.cuda.device(dev):
        rc = lib.paddle_flash_attention_fwd_streamed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(seed),
            o.data_ptr(), lse.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention streamed forward")
    fwd_streamed_launch_count += 1
    return o, lse


def flash_attention_fwd_f32_cuda(q, k, v, sm_scale, causal=False,
                                 dropout_rate=0.0, dropout_seed=None,
                                 bias=None):
    """Launch the f32 forward kernel on the current stream (f32, head dims
    up to F32_MAX_HEAD_DIM, any S and Sk): 64 query rows of a (batch,
    head) a work item, persistent blocks, split-TF32 wgmma products, the
    keys streamed in 64-key tiles → (o, lse). A head dim off the instances
    is padded with zero columns."""
    global fwd_f32_launch_count
    _check_cuda_inputs(q, k, v)
    if fwd_route(q.shape, k.shape, q.dtype) != "f32":
        raise ValueError(f"flash_attention f32 forward: takes f32 at head "
                         f"dims up to {F32_MAX_HEAD_DIM}, got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")
    B, H, S, D = q.shape
    dp = kernel_head_dim(D)
    if dp != D:
        o, lse = flash_attention_fwd_f32_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v)), sm_scale, causal,
            dropout_rate, dropout_seed, bias)
        return o[..., :D].contiguous(), lse
    dev = q.device
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed, B,
                                   k.shape[2], dev)
    o = torch.empty_like(q)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=dev)
    if S == 0:
        return o, lse
    lib = _library(FWD_F32_SOURCE)
    with torch.cuda.device(dev):
        rc = lib.paddle_flash_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(seed),
            o.data_ptr(), lse.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention f32 forward")
    fwd_f32_launch_count += 1
    return o, lse


def _check_bwd_inputs(q, k, v, like_q, row_stats):
    """``like_q``: name → a tensor that must be contiguous like q (dO, O);
    ``row_stats``: name → a contiguous f32 [B·H, S] tensor (lse, delta)."""
    _check_cuda_inputs(q, k, v)
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"contiguous like q {tuple(q.shape)} {q.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    rows = (q.shape[0] * q.shape[1], q.shape[2])
    for name, t in row_stats.items():
        if tuple(t.shape) != rows or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"contiguous f32 {list(rows)} on {q.device}, "
                             f"got {list(t.shape)} {t.dtype} on {t.device}")


def flash_attention_bwd_kv_cuda(q, k, v, do, lse, delta, sm_scale,
                                causal=False, dropout_rate=0.0,
                                dropout_seed=None, bias=None):
    """Launch the dK/dV kernel on the current stream: → (dk, dv)."""
    global bwd_kv_launch_count
    _check_bwd_inputs(q, k, v, {"dO": do}, {"lse": lse, "delta": delta})
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    if dp != d:
        dk, dv = flash_attention_bwd_kv_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, do)), lse, delta,
            sm_scale, causal, dropout_rate, dropout_seed, bias)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed,
                                   q.shape[0], k.shape[2], q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    lib = _library(BWD_KERNEL_SOURCE)
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(bias), _ptr(seed),
            dk.data_ptr(), dv.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention dK/dV")
    bwd_kv_launch_count += 1
    return dk, dv


def flash_attention_bwd_q_cuda(q, k, v, do, lse, delta, sm_scale,
                               causal=False, dropout_rate=0.0,
                               dropout_seed=None, bias=None):
    """Launch the dQ kernel on the current stream: → dq."""
    global bwd_q_launch_count
    _check_bwd_inputs(q, k, v, {"dO": do}, {"lse": lse, "delta": delta})
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    if dp != d:
        return flash_attention_bwd_q_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, do)), lse, delta,
            sm_scale, causal, dropout_rate, dropout_seed,
            bias)[..., :d].contiguous()
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed,
                                   q.shape[0], k.shape[2], q.device)
    dq = torch.empty_like(q)
    if q.shape[2] == 0:
        return dq
    lib = _library(BWD_KERNEL_SOURCE)
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_q(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(bias), _ptr(seed),
            dq.data_ptr(), *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention dQ")
    bwd_q_launch_count += 1
    return dq


def flash_attention_bwd_fused_cuda(q, k, v, o, lse, do, sm_scale,
                                   causal=False, dropout_rate=0.0,
                                   dropout_seed=None, bias=None):
    """Launch the fused backward kernel on the current stream (bf16, S and
    Sk up to WHOLE_MAX_LEN): delta, dQ, dK and dV in one launch → (dq, dk,
    dv). A head dim off the instances is padded with zero columns, O and
    dO too (they add zeros to delta)."""
    global bwd_fused_launch_count
    _check_bwd_inputs(q, k, v, {"O": o, "dO": do}, {"lse": lse})
    if bwd_route(q.shape, k.shape, q.dtype) != "fused":
        raise ValueError(f"flash_attention fused backward: takes bf16 with "
                         f"S, Sk <= {WHOLE_MAX_LEN}, got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} {q.dtype}")
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    if dp != d:
        grads = flash_attention_bwd_fused_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, o)), lse,
            pad_head_dim(do, dp), sm_scale, causal, dropout_rate,
            dropout_seed, bias)
        return tuple(g[..., :d].contiguous() for g in grads)
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed,
                                   q.shape[0], k.shape[2], q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.shape[2] == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = _library(BWD_FUSED_SOURCE)
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), _ptr(bias), _ptr(seed),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention fused backward")
    bwd_fused_launch_count += 1
    return dq, dk, dv


def flash_attention_bwd_split_cuda(q, k, v, o, lse, do, sm_scale,
                                   causal=False, dropout_rate=0.0,
                                   dropout_seed=None, bias=None):
    """The split route on the card: delta in torch passes, then the dK/dV
    and the dQ kernels → (dq, dk, dv). A head dim off the instances is
    padded once for both kernels; delta is taken from the unpadded O and
    dO (the padded columns would add zeros)."""
    delta = bwd_delta(o, do)
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    padded = dp is not None and dp != d
    if padded:
        q, k, v, do = (pad_head_dim(t, dp) for t in (q, k, v, do))
    tail = (sm_scale, causal, dropout_rate, dropout_seed, bias)
    dk, dv = flash_attention_bwd_kv_cuda(q, k, v, do, lse, delta, *tail)
    dq = flash_attention_bwd_q_cuda(q, k, v, do, lse, delta, *tail)
    if padded:
        return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


def flash_attention_bwd_dkdv_f32_cuda(q, k, v, do, lse, delta, sm_scale,
                                      causal=False, dropout_rate=0.0,
                                      dropout_seed=None, bias=None):
    """Launch the f32 dK/dV kernel on the current stream (f32, head dims
    up to F32_MAX_HEAD_DIM): 64 keys of a (batch, head) a work item,
    persistent blocks of two warpgroups, split-TF32 wgmma products, the
    query rows streamed in 32-row stages → (dk, dv)."""
    global bwd_dkdv_f32_launch_count
    _check_bwd_inputs(q, k, v, {"dO": do}, {"lse": lse, "delta": delta})
    if bwd_route(q.shape, k.shape, q.dtype) != "f32":
        raise ValueError(f"flash_attention f32 dK/dV: takes f32 at head "
                         f"dims up to {F32_MAX_HEAD_DIM}, got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    if dp != d:
        dk, dv = flash_attention_bwd_dkdv_f32_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, do)), lse, delta,
            sm_scale, causal, dropout_rate, dropout_seed, bias)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed,
                                   q.shape[0], k.shape[2], q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    lib = _library(BWD_DKDV_F32_SOURCE)
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_dkdv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(bias), _ptr(seed),
            dk.data_ptr(), dv.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention f32 dK/dV")
    bwd_dkdv_f32_launch_count += 1
    return dk, dv


def flash_attention_bwd_dq_f32_cuda(q, k, v, o, lse, do, sm_scale,
                                    causal=False, dropout_rate=0.0,
                                    dropout_seed=None, bias=None):
    """Launch the f32 dQ kernel on the current stream (f32, head dims up to
    F32_MAX_HEAD_DIM): 128 query rows of a (batch, head) a work item, 64
    for each of a persistent block's two warpgroups, split-TF32 wgmma products, the
    keys streamed in 32-key stages; it takes delta = rowsum(dO∘O) itself
    → (dq, delta [B·H, S] f32, what the f32 dK/dV kernel reads). A head
    dim off the instances is padded with zero columns, O and dO too (they
    add zeros to delta)."""
    global bwd_dq_f32_launch_count
    _check_bwd_inputs(q, k, v, {"O": o, "dO": do}, {"lse": lse})
    if bwd_route(q.shape, k.shape, q.dtype) != "f32":
        raise ValueError(f"flash_attention f32 dQ: takes f32 at head dims "
                         f"up to {F32_MAX_HEAD_DIM}, got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} {q.dtype}")
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    if dp != d:
        dq, delta = flash_attention_bwd_dq_f32_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, o)), lse,
            pad_head_dim(do, dp), sm_scale, causal, dropout_rate,
            dropout_seed, bias)
        return dq[..., :d].contiguous(), delta
    B, H, S = q.shape[:3]
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed, B,
                                   k.shape[2], q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if S == 0:
        return dq, delta
    lib = _library(BWD_DQ_F32_SOURCE)
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), _ptr(bias), _ptr(seed),
            dq.data_ptr(), delta.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention f32 dQ")
    bwd_dq_f32_launch_count += 1
    return dq, delta


def flash_attention_bwd_f32_cuda(q, k, v, o, lse, do, sm_scale,
                                 causal=False, dropout_rate=0.0,
                                 dropout_seed=None, bias=None):
    """The f32 backward on the card: the f32 dQ kernel (delta inside),
    then the f32 dK/dV kernel on the delta it wrote → (dq, dk, dv). A head
    dim off the instances is padded once for both kernels, O and dO too
    (they add zeros to delta)."""
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    padded = dp is not None and dp != d
    if padded:
        q, k, v, o, do = (pad_head_dim(t, dp) for t in (q, k, v, o, do))
    tail = (sm_scale, causal, dropout_rate, dropout_seed, bias)
    dq, delta = flash_attention_bwd_dq_f32_cuda(q, k, v, o, lse, do, *tail)
    dk, dv = flash_attention_bwd_dkdv_f32_cuda(q, k, v, do, lse, delta,
                                               *tail)
    if padded:
        return tuple(g[..., :d].contiguous() for g in (dq, dk, dv))
    return dq, dk, dv


ROW_TILE = 128  # query rows of a tile of the streamed dQ kernel


def _check_streamed(q, k, what):
    if bwd_route(q.shape, k.shape, q.dtype) != "streamed":
        raise ValueError(f"flash_attention streamed {what}: takes bf16 with "
                         f"S or Sk above {WHOLE_MAX_LEN}, got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} {q.dtype}")
    if kernel_head_dim(q.shape[3]) != q.shape[3]:
        raise ValueError(f"flash_attention streamed {what}: head dim "
                         f"{q.shape[3]} is no instance (pad it first)")


def flash_attention_bwd_dq_streamed_cuda(q, k, v, o, lse, do, sm_scale,
                                         causal=False, dropout_rate=0.0,
                                         dropout_seed=None, bias=None):
    """Launch the streamed dQ kernel on the current stream (bf16, S or Sk
    above WHOLE_MAX_LEN, a head dim with an instance): it takes delta =
    rowsum(dO∘O) itself and writes it with lse, a 128-row tile at a time,
    to a scratch buffer [B·H, ceil(S / 128), 2, 128] f32 that the dK/dV
    kernel streams → (dq, that buffer)."""
    global bwd_dq_streamed_launch_count
    _check_bwd_inputs(q, k, v, {"O": o, "dO": do}, {"lse": lse})
    _check_streamed(q, k, "dQ")
    B, H, S = q.shape[:3]
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed, B,
                                   k.shape[2], q.device)
    dq = torch.empty_like(q)
    stats = torch.empty((B * H, -(-S // ROW_TILE), 2, ROW_TILE),
                        dtype=torch.float32, device=q.device)
    if S == 0:
        return dq, stats
    lib = _library(BWD_STREAMED_SOURCE)
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_dq_streamed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), _ptr(bias), _ptr(seed),
            dq.data_ptr(), stats.data_ptr(),
            *_common_args(q, k, sm_scale, causal, dropout_rate))
    _raise_on(lib, rc, "flash_attention streamed dQ")
    bwd_dq_streamed_launch_count += 1
    return dq, stats


def flash_attention_bwd_dkdv_streamed_cuda(q, k, v, do, stats, sm_scale,
                                           causal=False, dropout_rate=0.0,
                                           dropout_seed=None, bias=None):
    """Launch the streamed dK/dV kernel on the current stream, after the
    dQ kernel that wrote ``stats`` (lse and delta by 128-row tile) →
    (dk, dv)."""
    global bwd_dkdv_streamed_launch_count
    _check_bwd_inputs(q, k, v, {"dO": do}, {})
    _check_streamed(q, k, "dK/dV")
    B, H, S = q.shape[:3]
    rows = (B * H, -(-S // ROW_TILE), 2, ROW_TILE)
    if tuple(stats.shape) != rows or stats.dtype != torch.float32 \
            or stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"flash_attention streamed dK/dV: stats must be "
                         f"contiguous f32 {list(rows)} on {q.device}")
    bias, seed = _device_bias_seed(bias, dropout_rate, dropout_seed, B,
                                   k.shape[2], q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if S == 0:
        return dk.zero_(), dv.zero_()
    lib = _library(BWD_STREAMED_SOURCE)
    with torch.cuda.device(q.device):
        rc = lib.paddle_flash_attention_bwd_dkdv_streamed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _ptr(bias), _ptr(seed), stats.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *_common_args(q, k, sm_scale, causal,
                                         dropout_rate))
    _raise_on(lib, rc, "flash_attention streamed dK/dV")
    bwd_dkdv_streamed_launch_count += 1
    return dk, dv


def flash_attention_bwd_streamed_cuda(q, k, v, o, lse, do, sm_scale,
                                      causal=False, dropout_rate=0.0,
                                      dropout_seed=None, bias=None):
    """The streamed backward on the card (bf16, S or Sk above
    WHOLE_MAX_LEN): the dQ kernel (delta inside), then the dK/dV kernel →
    (dq, dk, dv). A head dim off the instances is padded with zero
    columns, O and dO too (they add zeros to delta)."""
    _check_bwd_inputs(q, k, v, {"O": o, "dO": do}, {"lse": lse})
    d, dp = q.shape[3], kernel_head_dim(q.shape[3])
    if dp is not None and dp != d:
        grads = flash_attention_bwd_streamed_cuda(
            *(pad_head_dim(t, dp) for t in (q, k, v, o)), lse,
            pad_head_dim(do, dp), sm_scale, causal, dropout_rate,
            dropout_seed, bias)
        return tuple(g[..., :d].contiguous() for g in grads)
    tail = (sm_scale, causal, dropout_rate, dropout_seed, bias)
    dq, stats = flash_attention_bwd_dq_streamed_cuda(q, k, v, o, lse, do,
                                                     *tail)
    dk, dv = flash_attention_bwd_dkdv_streamed_cuda(q, k, v, do, stats,
                                                    *tail)
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, o, lse, do, sm_scale, causal=False,
                             dropout_rate=0.0, dropout_seed=None, bias=None):
    """The backward on the card → (dq, dk, dv), by ``bwd_route``: the fused
    kernel, the streamed pair, the f32 route or the split route."""
    fn = {"fused": flash_attention_bwd_fused_cuda,
          "streamed": flash_attention_bwd_streamed_cuda,
          "f32": flash_attention_bwd_f32_cuda,
          "split": flash_attention_bwd_split_cuda}[
        bwd_route(q.shape, k.shape, q.dtype)]
    return fn(q, k, v, o, lse, do, sm_scale, causal, dropout_rate,
              dropout_seed, bias)


# --------------------------------------------------------------------------
# entry
# --------------------------------------------------------------------------
def _dispatch(q, cuda_fn, plain_fn, *args):
    if q.is_cuda:
        return cuda_fn(*args)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return plain_fn(*args)


def flash_attention_fwd(q, k, v, sm_scale, causal=False, dropout_rate=0.0,
                        dropout_seed=None, bias=None):
    """(o, lse): the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    return _dispatch(q, flash_attention_cuda, flash_attention_reference,
                     q, k, v, sm_scale, causal, dropout_rate, dropout_seed,
                     bias)


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale, causal=False,
                        dropout_rate=0.0, dropout_seed=None, bias=None):
    """(dq, dk, dv): the kernels for CUDA tensors, the plain version for
    CPU tensors."""
    return _dispatch(q, flash_attention_bwd_cuda,
                     flash_attention_bwd_reference, q, k, v, o, lse, do,
                     sm_scale, causal, dropout_rate, dropout_seed, bias)


class FlashAttentionFunction(torch.autograd.Function):
    """``_flash_pallas``'s custom vjp (:639-666) as an autograd Function:
    apply(q, k, v, seed, bias, sm_scale, causal, dropout_rate) → (o, lse),
    lse not differentiable. The residual is (q, k, v, o, lse, seed, bias);
    the backward runs the backward kernels (or their plain version on the
    CPU) with the forward's seed, so the dropout mask it regenerates is
    the forward's. The bias gets a zero grad, the seed none."""

    # forward(ctx, ...) and not setup_context: with setup_context torch
    # binds the arguments through inspect.signature on every call

    @staticmethod
    def forward(ctx, q, k, v, seed, bias, sm_scale, causal, dropout_rate):
        o, lse = flash_attention_fwd(q, k, v, sm_scale, causal,
                                     dropout_rate, seed, bias)
        ctx.save_for_backward(q, k, v, o, lse, seed, bias)
        ctx.mark_non_differentiable(lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        ctx.dropout_rate = dropout_rate
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seed, bias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), ctx.sm_scale, ctx.causal,
            ctx.dropout_rate, seed, bias)
        dbias = torch.zeros_like(bias) if ctx.needs_input_grad[4] else None
        return dq, dk, dv, None, dbias, None, None, None


def flash_attention(q, k, v, sm_scale, causal=False, dropout_rate=0.0,
                    dropout_seed=None, bias: Optional[torch.Tensor] = None):
    """q,k,v: [B,H,S,D] → [B,H,S,D], differentiable in q, k and v (entry
    rules of the TPU package's flash_attention, :673). ``bias`` is an
    additive key-padding mask [B, Sk] broadcast over query rows, constant
    for the gradient; dropout_rate > 0 applies the counter-hash attention
    dropout inside the kernels and needs ``dropout_seed`` (an int32 [1]
    tensor or an int)."""
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
    seed = None
    if dropout_rate > 0.0:
        seed = (dropout_seed if isinstance(dropout_seed, torch.Tensor)
                else torch.tensor([int(dropout_seed)], dtype=torch.int32,
                                  device=q.device))
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        # nothing to differentiate (serving, the forward op of a training
        # step): the same kernel without autograd's per-call bookkeeping
        return flash_attention_fwd(q, k, v, sm_scale, causal,
                                   float(dropout_rate), seed, bias)[0]
    o, _ = FlashAttentionFunction.apply(q, k, v, seed, bias, float(sm_scale),
                                        bool(causal), float(dropout_rate))
    return o
