// What the flash-attention kernels share besides the dropout mask and the
// tensor-core blocks (tc_common.cuh): the mask value, the tile shape, the
// score masks, the entry points' error codes, the once-per-device
// shared-memory opt-in and the count of blocks a device holds at once.
#pragma once

#include <cuda_runtime.h>

namespace paddle_fa {

constexpr float NEG_INF = -1e30f;  // finite: -inf - -inf never happens
constexpr int BM = 64;             // query rows per tile
constexpr int BN = 64;             // keys per tile

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
// that -inf never meets -inf; 0 without a bias or past Sk. A NaN stays NaN,
// as jnp.maximum keeps it in the TPU kernels (fmaxf would return NEG_INF
// and quietly mask the key: a NaN input mask must reach the loss, where the
// numeric guard sees it).
__device__ __forceinline__ float bias_at(const float* bias, int b, int col,
                                         int Sk) {
  if (bias == nullptr || col >= Sk) return 0.f;
  const float x = bias[(size_t)b * Sk + col];
  return x < NEG_INF ? NEG_INF : x;
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

// the current device, as an index of the per-device caches below
inline int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices
             ? dev
             : 0;
}

// The blocks of `kernel` (`threads` threads, `smem` bytes of dynamic
// shared memory) that the current device holds at once: its SMs times the
// blocks an SM takes. A persistent kernel launches that many. Cached in
// `cache` per device (0: not asked yet).
inline cudaError_t resident_blocks(const void* kernel, int threads,
                                   size_t smem, int (&cache)[kMaxDevices]) {
  const int dev = current_device();
  if (cache[dev] > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  cache[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  return cudaSuccess;
}

}  // namespace paddle_fa
