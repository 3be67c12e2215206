"""Counter-based random draws on the executor's device: the port's
counterpart of ``jax.random`` keys (the TPU package folds (program seed,
step, op index) into a key with ``jax.random.fold_in``).

A key is an int64 tensor of shape [1] on the device, holding a 32-bit
value. The executor derives each random op's key on the device from the
program seed, the scope's step counter (a device tensor) and the op's
index, so a CUDA graph that replays a step draws new bits on every replay
without any host work, and the interpreter, which runs the same
derivation, draws the same bits. A kernel turns its key into bits by
hashing (key, element index): no generator state is read or advanced.

The hash is two rounds of xor-shift-multiply over 32-bit values held in
int64 tensors. Both multipliers are below 2^31, so a product of a 32-bit
value stays below 2^63: the arithmetic is exact in int64, identical on
the CPU and the card, with no reliance on integer overflow.
"""
from __future__ import annotations

from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x21F0AAAD, 0x735A2D97


def hash32_int(x: int) -> int:
    """The hash on a Python int (host constants: seeds, op indices)."""
    x &= _M32
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    return x ^ (x >> 15)


def _round_(x: torch.Tensor, shift: int, mult: int) -> torch.Tensor:
    x.bitwise_xor_(x >> shift)
    return x.mul_(mult).bitwise_and_(_M32)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """The hash on an int64 tensor of 32-bit values (a new tensor)."""
    x = x.clone()
    _round_(x, 16, _C1)
    _round_(x, 15, _C2)
    return x.bitwise_xor_(x >> 15)


def step_key(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """The key of one run: the hash of the step counter folded with the
    program seed's hash, on the counter's device."""
    return hash32(hash32(counter & _M32).bitwise_xor_(hash32_int(seed)))


def op_keys(skey: torch.Tensor, hashed_idx: torch.Tensor) -> torch.Tensor:
    """The keys of many ops at once: ``hashed_idx`` holds hash32 of each
    op index (a device constant), ``skey`` the run's key."""
    return hash32(hashed_idx ^ skey)


def fold(keys: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``keys`` folded with a counter tensor ``t`` (a ``while``
    iteration), on the device: the hash of each key xor the counter's
    hash."""
    return hash32(keys ^ hash32(t & _M32))


def fixed_key(seed: int, device) -> torch.Tensor:
    """The key of an op seeded by its own ``seed`` attr: the same every
    run."""
    return torch.full((1,), hash32_int(seed), dtype=torch.int64,
                      device=device)


def hashed_indices(idxs: Sequence[int], device) -> torch.Tensor:
    return torch.tensor([hash32_int(i) for i in idxs], dtype=torch.int64,
                        device=device)


def bits24(key: torch.Tensor, shape) -> torch.Tensor:
    """24 uniform random bits per element of ``shape`` (int64), from the
    key and each element's flat index: the key enters before each round.
    The dropout kernel (ops/cuda/csrc/dropout.cu) draws the same bits."""
    n = 1
    for s in shape:
        n *= int(s)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x.bitwise_xor_(key)
    _round_(x, 16, _C1)
    x.bitwise_xor_(key)
    _round_(x, 15, _C2)
    x.bitwise_xor_(x >> 15)
    return (x >> 8).reshape(tuple(int(s) for s in shape))


def keep_mask(key: torch.Tensor, shape, rate: float) -> torch.Tensor:
    """Dropout keep mask (bool): each element kept with probability
    1 - rate (to 2^-24)."""
    return bits24(key, shape) >= int(rate * float(1 << 24))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 uniform on (0, 1): (bits + 1/2) / 2^24, never 0 or 1."""
    return (bits24(key, shape).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard normal by Box-Muller over two halves of one
    draw."""
    n = 1
    for s in shape:
        n *= int(s)
    u = uniform(key, (2, n))
    z = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos(
        (2.0 * torch.pi) * u[1])
    return z.reshape(tuple(int(s) for s in shape))


def attention_seed(key: torch.Tensor) -> torch.Tensor:
    """The flash-attention kernels' dropout seed (int32 [1], in
    [0, 2^31)) from an op's key."""
    return (key & 0x7FFFFFFF).to(torch.int32).reshape(1)
