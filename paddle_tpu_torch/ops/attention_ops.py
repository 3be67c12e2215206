"""Fused attention ops (counterpart of paddle_tpu/ops/attention_ops.py).

``fused_attention_qkv``: the fused attention op of models/bert.py —
Q/K/V [B, S, H·D] → context [B, S, H·D].

``multihead_matmul``: wire-compatible with the reference's fused inference
op (reference: operators/fused/multihead_matmul_op.cu — packed QKV +
BiasQK additive mask).

Both are differentiable: the flash path through
``FlashAttentionFunction`` (its backward runs the dK/dV and dQ kernels),
the einsum path through torch autograd.

Dispatch rule of the TPU package, unchanged: no bias, or a bias of the
exact key-padding form [B, 1, 1, Sk], goes to the flash kernel
(ops/cuda/flash_attention.py: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors); any other bias shape goes to the op's own einsum
path in plain torch. Both paths accumulate in f32.
"""
from __future__ import annotations

import math

import torch

from . import rng
from .registry import register_op, first, out
from .math_ops import bf16_matmul_enabled
from .cuda.flash_attention import flash_attention


def _keypad_bias(bias, q, k):
    """[B, Sk] view of ``bias`` iff it is EXACTLY the key-padding form
    [B, 1, 1, Sk] (else None). A merely broadcastable bias (e.g.
    [B,1,1,1] or [1,1,1,Sk]) does not qualify. q, k: [B, H, S, D]."""
    if bias is not None and bias.dim() == 4 and bias.shape[1] == 1 \
            and bias.shape[2] == 1 and bias.shape[0] == q.shape[0] \
            and bias.shape[3] == k.shape[2]:
        return bias.reshape(bias.shape[0], bias.shape[3])
    return None


def _split_heads(x, n_head):
    b, s, hd = x.shape
    return x.reshape(b, s, n_head, hd // n_head).permute(0, 2, 1, 3) \
        .contiguous()


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _einsum_attention(q, k, v, scale, bias, causal=False, drop=0.0,
                      key=None):
    """Plain attention for biases the kernel does not take, with the same
    f32-accumulation contract: scores and softmax in f32, P rounded to the
    operand dtype before the PV product."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        S, Sk = q.shape[2], k.shape[2]
        mask = torch.arange(S, device=q.device)[:, None] \
            >= torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if drop > 0.0:
        keep = rng.keep_mask(key, p.shape, drop)
        p = torch.where(keep, p / (1.0 - drop),
                        torch.zeros((), dtype=p.dtype, device=p.device))
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
    kp_bias = _keypad_bias(bias, qh, kh)
    if bias is None or kp_bias is not None:
        seed = rng.attention_seed(attrs["_rng"]()) if drop > 0.0 else None
        o = flash_attention(qh, kh, vh, sm_scale, causal, dropout_rate=drop,
                            dropout_seed=seed, bias=kp_bias)
    else:
        o = _einsum_attention(qh, kh, vh, sm_scale, bias, causal, drop,
                              attrs["_rng"]() if drop > 0.0 else None)
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
    kp_bias = _keypad_bias(bias_qk, q, k)
    if bias_qk is None or kp_bias is not None:
        o = flash_attention(q, k, v, alpha, causal=False, bias=kp_bias)
    else:
        o = _einsum_attention(q, k, v, alpha, bias_qk).to(q.dtype)
    return out(Out=_merge_heads(o))
