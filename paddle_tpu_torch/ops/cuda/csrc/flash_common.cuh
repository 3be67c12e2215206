// What the flash-attention kernels share besides the dropout mask and the
// tensor-core blocks (tc_common.cuh): the mask value, the f32 / bf16
// conversions, the tile shape, the score masks, the dQ kernel's CUDA-core
// tile product, the entry points' error codes and the once-per-device
// shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paddle_fa {

constexpr float NEG_INF = -1e30f;  // finite: -inf - -inf never happens
constexpr int BM = 64;             // query rows per tile
constexpr int BN = 64;             // keys per tile
// the dQ kernel's thread layout (the others use tc::THREADS)
constexpr int NT = 256;            // threads per block: 16 row groups x 16
constexpr int RPT = 4;             // tile rows per thread (BM / 16)
constexpr int CPT = 4;             // tile columns per thread (BN / 16)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The TPU kernels feed P (and dS) to their products in the operands'
// dtype: round the same way.
template <typename T>
__device__ __forceinline__ float as_operand(float x) {
  return to_f32(from_f32<T>(x));
}

// The dQ kernel's synchronous staging: rows [r0, r0 + 64) of a [rows, D]
// matrix at `src` into shared memory as f32 with row stride D + 1 (odd: a
// half-warp's column reads hit 16 banks). Rows at or past `limit` read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int limit) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        r0 + r < limit ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// s[i][j] = sum_d A[4 ty + i][d] * B[tx + 16 j][d] over two staged tiles,
// summed in d order with fmaf on the CUDA cores: the dQ kernel's QK^T and
// dO V^T. The forward and the dK/dV kernel compute the same scores on the
// tensor cores in split TF32 (or bf16), in another order, so the three
// kernels' scores agree within rounding, not bit for bit; each kernel is
// held to its plain version within tolerance.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         float (&s)[RPT][CPT], int ty,
                                         int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[RPT], bv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) av[i] = A[(ty * RPT + i) * DP + d];
#pragma unroll
    for (int j = 0; j < CPT; ++j) bv[j] = B[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// scale, then the clamped key-padding bias, then the ragged and causal
// masks: the TPU kernels' order, with the rounding of each step pinned
// (__fmul_rn / __fadd_rn cannot be fused into an fma)
__device__ __forceinline__ float masked_score(float s, float sm_scale,
                                              float bias, int row, int col,
                                              int Sk, int causal) {
  float x = __fadd_rn(__fmul_rn(s, sm_scale), bias);
  if (col >= Sk) x = NEG_INF;
  if (causal && col > row) x = NEG_INF;
  return x;
}

// The key-padding bias of column `col` of batch `b`, clamped at NEG_INF so
// that -inf never meets -inf; 0 without a bias or past Sk.
__device__ __forceinline__ float bias_at(const float* bias, int b, int col,
                                         int Sk) {
  return (bias != nullptr && col < Sk) ? fmaxf(bias[(size_t)b * Sk + col],
                                               NEG_INF)
                                       : 0.f;
}

// negative return codes of the C entry points (a cudaError_t is >= 0)
constexpr int kErrHeadDim = -1;
constexpr int kErrAlign = -2;

inline const char* error_string(int err) {
  if (err == kErrHeadDim) return "unsupported head dim";
  if (err == kErrAlign)
    return "operands read by cp.async must be 16-byte aligned";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

constexpr int kMaxDevices = 64;

// The dynamic shared-memory opt-in is a per-device property of each kernel
// instance: set it on the first launch on a device, not on every launch.
// `done` is the instance's own flag array. Two threads racing here both
// set the same value, which is harmless.
inline cudaError_t ensure_smem_attr(const void* kernel, size_t bytes,
                                    bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && cached) done[dev] = true;
  return err;
}

}  // namespace paddle_fa
