"""Recurrent ops (counterpart of paddle_tpu/ops/rnn_ops.py; reference:
paddle/fluid/operators/cudnn_lstm_op.cc, lstm_unit_op.cc). So far: the
fused dense multi-layer ``lstm`` and the single step ``lstm_unit``.

Gates are ordered [i, f, c̃, o] along the last axis, as in the TPU
package. The recurrence is a loop over time inside the op: T is static
for a program, so a CUDA graph captures the whole loop, and the grad is
the generic one, torch autograd over the loop.
"""
from __future__ import annotations

import torch

from . import rng
from .registry import register_op, first, out


def _lstm_layer(xw, h, c, wh, b):
    """One direction of one layer: ``xw`` [B, T, 4H] the projected input,
    ``h``, ``c`` [B, H] the initial state, ``wh`` [H, 4H], ``b`` [4H]. →
    (hs, cs), each [B, T, H]."""
    hs, cs = [], []
    for t in range(xw.shape[1]):
        g = xw[:, t] + h @ wh + b
        i, f, cc, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


@register_op("lstm", needs_rng=True,
             diff_inputs=["Input", "W", "InitH", "InitC"],
             attr_defaults={"max_len": 0, "hidden_size": 0, "num_layers": 1,
                            "is_bidirec": False, "dropout_prob": 0.0,
                            "input_size": 0, "is_test": False, "seed": 0})
def _lstm(ins, attrs):
    """Dense multi-layer (bi)LSTM over [B, T, D]. The flat W packs, per
    layer and direction in that order, [Wx (in × 4H), Wh (H × 4H), b
    (4H)]; the reverse direction runs on the input flipped in time and
    its output is flipped back. LastH and LastC [L·dirs, B, H] hold each
    direction's state after its last step. Between layers, when
    ``is_test`` is false, dropout at ``dropout_prob`` (upscaled), its
    keep mask drawn from the op's key for each layer."""
    x = first(ins, "Input")
    w = first(ins, "W").reshape(-1)
    init_h, init_c = first(ins, "InitH"), first(ins, "InitC")
    H = int(attrs["hidden_size"])
    L = int(attrs.get("num_layers", 1))
    dirs = 2 if attrs.get("is_bidirec", False) else 1
    p = float(attrs.get("dropout_prob", 0.0))
    ptr = 0
    layer_in = x
    last_h, last_c = [], []
    for layer in range(L):
        outs = []
        d_in = layer_in.shape[-1]
        for d in range(dirs):
            wx = w[ptr:ptr + d_in * 4 * H].reshape(d_in, 4 * H)
            ptr += d_in * 4 * H
            wh = w[ptr:ptr + H * 4 * H].reshape(H, 4 * H)
            ptr += H * 4 * H
            b = w[ptr:ptr + 4 * H]
            ptr += 4 * H
            inp = layer_in.flip(1) if d == 1 else layer_in
            hs, cs = _lstm_layer(inp @ wx, init_h[layer * dirs + d],
                                 init_c[layer * dirs + d], wh, b)
            last_h.append(hs[:, -1])
            last_c.append(cs[:, -1])
            outs.append(hs.flip(1) if d == 1 else hs)
        layer_in = torch.cat(outs, -1) if dirs == 2 else outs[0]
        if p and not attrs.get("is_test", False) and layer < L - 1:
            keep = rng.keep_mask(rng.subkey(attrs["_rng"](), layer),
                                 layer_in.shape, p)
            layer_in = torch.where(keep, layer_in / (1.0 - p),
                                   torch.zeros_like(layer_in))
    return out(Out=layer_in, LastH=torch.stack(last_h),
               LastC=torch.stack(last_c))


@register_op("lstm_unit", diff_inputs=["X", "C_prev"],
             attr_defaults={"forget_bias": 0.0})
def _lstm_unit(ins, attrs):
    """One LSTM step from the pre-projected gates X [N, 4H] and C_prev:
    C = σ(f + forget_bias)·C_prev + σ(i)·tanh(c̃), H = σ(o)·tanh(C)."""
    x, c_prev = first(ins, "X"), first(ins, "C_prev")
    i, f, cc, o = x.chunk(4, dim=-1)
    f = f + attrs.get("forget_bias", 0.0)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(cc)
    return out(C=c, H=torch.sigmoid(o) * torch.tanh(c))
