"""Additional NN op kernels (counterpart of paddle_tpu/ops/nn_extra_ops.py;
so far: add_position_encoding)."""
from __future__ import annotations

import torch

from .math_ops import scalar_as
from .registry import register_op, first, out


@register_op("add_position_encoding", inputs=("X",),
             attr_defaults={"alpha": 1.0, "beta": 1.0})
def _add_position_encoding(ins, attrs):
    """alpha·X + beta·PE for X [B, T, D]: PE's first D/2 columns are
    sin(t / 10000^(i / (D/2))), the others the cos. As the TPU kernel,
    the positions and divisors are built in X's dtype (so in bf16 the
    base 10000 is bf16's 9984) and every scalar is rounded to it."""
    x = first(ins, "X")
    _, t, d = x.shape
    half = d // 2
    dt = x.dtype
    pos = torch.arange(t, dtype=dt, device=x.device)[:, None]
    expo = torch.arange(half, dtype=dt, device=x.device) / half
    div = torch.pow(scalar_as(10000.0, dt), expo)[None, :]
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return out(Out=scalar_as(attrs.get("alpha", 1.0), dt) * x
               + scalar_as(attrs.get("beta", 1.0), dt) * enc[None, :, :])
