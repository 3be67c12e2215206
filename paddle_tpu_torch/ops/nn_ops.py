"""NN op kernels (counterpart of paddle_tpu/ops/nn_ops.py; this slice:
lookup_table_v2 and layer_norm)."""
from __future__ import annotations

import torch

from .registry import register_op, first, out


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------
def _lookup(w, ids, padding_idx):
    o = w[ids.long()]
    if padding_idx is not None and padding_idx >= 0:
        o = torch.where((ids == padding_idx)[..., None],
                        torch.zeros((), dtype=o.dtype, device=o.device), o)
    return o


@register_op("lookup_table_v2", inputs=("W", "Ids"), diff_inputs=("W",),
             attr_defaults={"padding_idx": -1, "is_sparse": False,
                            "is_distributed": False, "remote_prefetch": False})
def _lookup_table_v2(ins, attrs):
    w, ids = first(ins, "W"), first(ins, "Ids")
    pad = attrs.get("padding_idx", -1)
    return out(Out=_lookup(w, ids, pad if pad >= 0 else None))


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------
@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             diff_inputs=("X", "Scale", "Bias"),
             attr_defaults={"epsilon": 1e-5, "begin_norm_axis": 1})
def _layer_norm(ins, attrs):
    """Statistics in f32 with the biased variance; Mean and Variance have
    shape ``x.shape[:begin_norm_axis]``."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, axes, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), axes, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    norm_shape = (1,) * bna + tuple(x.shape[bna:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    flat = tuple(x.shape[:bna])
    return out(Y=y, Mean=mean.reshape(flat).to(x.dtype),
               Variance=var.reshape(flat).to(x.dtype))
