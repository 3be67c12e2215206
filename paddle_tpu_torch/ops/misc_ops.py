"""The hash op (counterpart of paddle_tpu/ops/misc_ops.py; reference:
hash_op.cc, whose xxhash buckets a row of int ids).

The TPU kernel is not xxhash: it rolls a row's ids into one 32-bit key
(key·1000003 + id) and mixes it with a 32-bit avalanche for each of
``num_hash`` seeds, then takes it modulo ``mod_by``. Its ids are uint32:
the TPU package runs with x64 off, so an int64 id comes in as int32
(wrapped modulo 2^32) and a negative one as its two's complement. Torch
has no full uint32 arithmetic, so this kernel carries each value in
int64 below 2^32, masks after every multiply and add, and splits the
multiplies by the 32-bit mixing constants into 16-bit halves, whose
products stay below 2^48: the same bits as the TPU kernel's."""
from __future__ import annotations

import torch

from .registry import register_op, first, out

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2^32 for a in [0, 2^32) and a 32-bit constant c."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


@register_op("hash", inputs=("X",), no_grad=True,
             attr_defaults={"num_hash": 1, "mod_by": 100000})
def _hash(ins, attrs):
    """Out [N, num_hash, 1] int32: each row of X's ids hashed
    ``num_hash`` ways into [0, mod_by)."""
    x = first(ins, "X")
    num_hash = int(attrs.get("num_hash", 1))
    mod_by = int(attrs.get("mod_by", 100000))
    ids = x.reshape(x.shape[0], -1).long() & _M32
    key = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for j in range(ids.shape[1]):
        key = (key * 1000003 + ids[:, j]) & _M32
    outs = []
    for h in range(num_hash):
        v = key ^ ((0x9E3779B9 + 0x61C88647 * h) & _M32)
        v = _mul32(v ^ (v >> 16), 0x85EBCA6B)
        v = _mul32(v ^ (v >> 13), 0xC2B2AE35)
        v = v ^ (v >> 16)
        outs.append((v % mod_by).to(torch.int32))
    return out(Out=torch.stack(outs, dim=1)[:, :, None])
