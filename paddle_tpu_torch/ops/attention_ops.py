"""Fused attention ops (counterpart of paddle_tpu/ops/attention_ops.py).

``fused_attention_qkv``: the fused attention op of models/bert.py —
Q/K/V [B, S, H·D] → context [B, S, H·D].

``multihead_matmul``: wire-compatible with the reference's fused inference
op (reference: operators/fused/multihead_matmul_op.cu — packed QKV +
BiasQK additive mask).

Both are differentiable: the flash path through
``FlashAttentionFunction`` (its backward runs the dK/dV and dQ kernels),
the einsum path through torch autograd.

Route (``attention_route``, the TPU package's rule, a pure function of
the shapes): no bias, or a bias of the exact key-padding form
[B, 1, 1, Sk], goes to the flash kernels (ops/cuda/flash_attention.py: the
CUDA kernels for CUDA tensors, their plain versions for CPU tensors); any
other bias shape goes to the op's own einsum path in plain torch, which at
dropout > 0 draws the flash kernels' own counter-hash mask, so the mask
does not depend on the route. On the card the kernels take f32 or bf16 at
any head dim up to 128 (zero-padded to their next instance) and any B·H;
a head dim above 128 or another dtype raises there, as nothing else runs
the flash route on the card. Both paths accumulate in f32.
"""
from __future__ import annotations

import math

import torch

from . import rng
from .registry import register_op, first, out
from .math_ops import bf16_matmul_enabled
from .cuda.flash_attention import flash_attention, keep_mask


def _is_keypad(bias_shape, q_shape, k_shape) -> bool:
    """A bias of EXACTLY the key-padding form [B, 1, 1, Sk]; a merely
    broadcastable one (e.g. [B,1,1,1] or [1,1,1,Sk]) does not qualify.
    q, k: [B, H, S, D]."""
    return bias_shape is not None and len(bias_shape) == 4 \
        and bias_shape[1] == 1 and bias_shape[2] == 1 \
        and bias_shape[0] == q_shape[0] and bias_shape[3] == k_shape[2]


def attention_route(q_shape, k_shape, bias_shape=None) -> str:
    """"flash" or "einsum" for q [B, H, S, D], k [B, H, Sk, D] and an
    additive bias of ``bias_shape`` (None: no bias): the flash kernels take
    no bias or the key-padding form, whatever the head dim and dtype (the
    TPU package's Pallas kernel refuses no shape)."""
    return "flash" if bias_shape is None \
        or _is_keypad(bias_shape, q_shape, k_shape) else "einsum"


def _split_heads(x, n_head):
    b, s, hd = x.shape
    return x.reshape(b, s, n_head, hd // n_head).permute(0, 2, 1, 3) \
        .contiguous()


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _einsum_attention(q, k, v, scale, bias, causal=False, drop=0.0,
                      seed=None):
    """Plain attention for the biases the kernels do not take, with the
    same f32-accumulation contract: scores and softmax in f32, P rounded
    to the operand dtype before the PV product. At ``drop`` > 0 the keep
    mask is the flash kernels' counter hash over (seed, b·H + h, row,
    col)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    B, H, S, Sk = s.shape
    dev = q.device
    if causal:
        mask = torch.arange(S, device=dev)[:, None] \
            >= torch.arange(Sk, device=dev)[None, :]
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if drop > 0.0:
        keep = keep_mask(seed,
                         torch.arange(B * H, device=dev).reshape(B, H, 1, 1),
                         torch.arange(S, device=dev)[:, None],
                         torch.arange(Sk, device=dev)[None, :], drop)
        p = torch.where(keep, p / (1.0 - drop),
                        torch.zeros((), dtype=p.dtype, device=dev))
    return torch.matmul(p.float(), v.float())


@register_op("fused_attention_qkv", inputs=("Q", "K", "V", "Bias"),
             diff_inputs=("Q", "K", "V"), needs_rng=True,
             attr_defaults={"num_heads": 1, "dropout_rate": 0.0,
                            "causal": False})
def _fused_attention_qkv(ins, attrs):
    """Optional Bias: additive attention mask broadcastable to
    [B, H, Sq, Sk] (e.g. padding mask [B, 1, 1, Sk]). Causal masking is
    top-left aligned (query i sees keys <= i) on both paths. Attention
    dropout takes its seed (kernel path: an int32 device tensor, so a
    replayed CUDA graph reads each step's seed) or its mask (einsum path)
    from the op's key; at rate 0 nothing is drawn."""
    q = first(ins, "Q")
    k = first(ins, "K")
    v = first(ins, "V")
    bias = first(ins, "Bias")
    h = attrs.get("num_heads", 1)
    sm_scale = 1.0 / math.sqrt(q.shape[-1] // h)
    out_dtype = q.dtype
    if bf16_matmul_enabled(q):
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    qh, kh, vh = (_split_heads(t, h) for t in (q, k, v))
    causal = attrs.get("causal", False)
    drop = float(attrs.get("dropout_rate", 0.0) or 0.0)
    seed = rng.attention_seed(attrs["_rng"]()) if drop > 0.0 else None
    if attention_route(qh.shape, kh.shape,
                       None if bias is None else bias.shape) == "flash":
        kp = None if bias is None else bias.reshape(bias.shape[0], -1)
        o = flash_attention(qh, kh, vh, sm_scale, causal, dropout_rate=drop,
                            dropout_seed=seed, bias=kp)
    else:
        o = _einsum_attention(qh, kh, vh, sm_scale, bias, causal, drop, seed)
    return out(Out=_merge_heads(o).to(out_dtype))


@register_op("multihead_matmul", inputs=("Input", "W", "Bias", "BiasQK"),
             diff_inputs=("Input", "W", "Bias"),
             attr_defaults={"transpose_Q": False, "transpose_K": True,
                            "transpose_V": False, "alpha": 1.0,
                            "head_number": 1})
def _multihead_matmul(ins, attrs):
    """Reference contract (operators/fused/multihead_matmul_op.cc:80):
    Input is the raw hidden [B, S, N] with the packed projection W
    [N, 3, H·D] and Bias [3, H·D]; pre-projected packed-QKV inputs
    ([B,S,3,H,D] / [B,S,3HD] without W) are also accepted."""
    x = first(ins, "Input")
    w = first(ins, "W")
    b = first(ins, "Bias")
    bias_qk = first(ins, "BiasQK")
    h = attrs.get("head_number", 1)
    alpha = attrs.get("alpha", 1.0)
    if w is not None and w.dim() >= 3:  # raw hidden + packed projection
        wm = w.reshape(w.shape[0], 3, -1)
        qkv = torch.einsum("bsn,nch->bsch", x, wm)
        if b is not None:
            qkv = qkv + b.reshape(3, -1)
        q, k, v = (_split_heads(qkv[:, :, i], h) for i in range(3))
    else:
        if x.dim() == 5:  # [B, S, 3, H, D]
            x5 = x
        else:  # [B, S, 3·H·D]
            bsz, s, hd3 = x.shape
            x5 = x.reshape(bsz, s, 3, h, hd3 // (3 * h))
        q, k, v = (x5[:, :, i].permute(0, 2, 1, 3).contiguous()
                   for i in range(3))
    if attention_route(q.shape, k.shape, None if bias_qk is None
                       else bias_qk.shape) == "flash":
        kp = None if bias_qk is None else \
            bias_qk.reshape(bias_qk.shape[0], -1)
        o = flash_attention(q, k, v, alpha, causal=False, bias=kp)
    else:
        o = _einsum_attention(q, k, v, alpha, bias_qk).to(q.dtype)
    return out(Out=_merge_heads(o))
