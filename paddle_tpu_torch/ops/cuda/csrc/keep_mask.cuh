// The counter-hash attention-dropout mask, shared by the forward and the
// backward flash-attention kernels so that the backward regenerates
// exactly the mask the forward applied: one definition, no drift.
//
// `_keep_mask` (paddle_tpu/ops/pallas/flash_attention.py:149): a
// Wang-style uint32 mix over (seed, batch*head, absolute row, absolute
// col) with wrap-around multiplies; keep when the low 24 bits reach
// rate * 2^24 (`thresh`). The plain PyTorch version is `keep_mask` in
// ops/cuda/flash_attention.py.
#pragma once

#include <stdint.h>

namespace paddle_fa {

__device__ __forceinline__ bool keep(uint32_t seed, uint32_t bh, uint32_t row,
                                     uint32_t col, uint32_t thresh) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^
               (seed + 0x27D4EB2Fu * bh);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return (x & 0xFFFFFFu) >= thresh;
}

}  // namespace paddle_fa
