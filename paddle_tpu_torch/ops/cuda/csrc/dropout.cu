// Dropout forward in one pass: the counter-hash keep mask of ops/rng.py
// (`bits24`) drawn per element from (key, flat index) and applied to x.
//
// Reads x once and writes out and the uint8 mask once: 9 bytes an f32
// element, against the ~15 int64 elementwise passes of the plain version
// (ops/cuda/dropout.py `dropout_reference`). The hash is the plain
// version's bit for bit: two rounds of xor-shift-multiply over uint32,
// whose wrap-around products equal the plain version's int64 products
// masked to 32 bits. The key is read from device memory, so a CUDA graph
// that captured the launch draws new bits whenever the key changes.
//
// The TPU package draws dropout with jax.random in an XLA fusion
// (paddle_tpu/ops/nn_ops.py:263); it has no Pallas kernel for it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t C1 = 0x21F0AAADu;
constexpr uint32_t C2 = 0x735A2D97u;
constexpr int THREADS = 256;
constexpr int VEC = 4;  // elements per thread and iteration

__device__ __forceinline__ uint32_t bits24(uint32_t key, uint32_t i) {
  uint32_t x = i ^ key;
  x ^= x >> 16;
  x *= C1;
  x ^= key;
  x ^= x >> 15;
  x *= C2;
  x ^= x >> 15;
  return x >> 8;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// upscale_in_train: kept x times `scale` (1 / (1 - rate), rounded to f32
// as PyTorch rounds the reciprocal of a scalar divisor); else kept x as is.
template <typename T>
__device__ __forceinline__ T apply(T v, bool keep, int upscale, float scale) {
  if (!keep) return from_f32<T>(0.0f);
  return upscale ? from_f32<T>(__fmul_rn(to_f32(v), scale)) : v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ key,
                       T* __restrict__ out, uint8_t* __restrict__ mask,
                       int64_t n, uint32_t thresh, int upscale, float scale) {
  const uint32_t k = static_cast<uint32_t>(*key);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS * VEC;
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * VEC;
       base < n; base += stride) {
    if (base + VEC <= n) {
      alignas(16) T v[VEC];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(v) =
            *reinterpret_cast<const float4*>(x + base);
      } else {
        *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(x + base);
      }
      uchar4 m;
      uint8_t* mb = reinterpret_cast<uint8_t*>(&m);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool keep = bits24(k, static_cast<uint32_t>(base + j)) >= thresh;
        mb[j] = keep;
        v[j] = apply(v[j], keep, upscale, scale);
      }
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(out + base) = *reinterpret_cast<float4*>(v);
      } else {
        *reinterpret_cast<uint2*>(out + base) = *reinterpret_cast<uint2*>(v);
      }
      *reinterpret_cast<uchar4*>(mask + base) = m;
    } else {
      for (int64_t i = base; i < n; ++i) {
        const bool keep = bits24(k, static_cast<uint32_t>(i)) >= thresh;
        mask[i] = keep;
        out[i] = apply(x[i], keep, upscale, scale);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* key, void* out, void* mask, int64_t n,
           unsigned int thresh, int upscale, float scale, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + THREADS * VEC - 1) / (THREADS * VEC);
  const int64_t cap = static_cast<int64_t>(sms) * 8;  // grid-stride beyond
  const int blocks = static_cast<int>(want < cap ? want : cap);
  dropout_fwd_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(key),
      static_cast<T*>(out), static_cast<uint8_t*>(mask), n, thresh, upscale,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: [n] contiguous, 16-byte aligned (f32, is_bf16 = 0) or 8-byte
// aligned (bf16); key: int64 [1] on the device holding a 32-bit value;
// mask: uint8 [n], 4-byte aligned; 0 < n < 2^32. An element is kept when
// its 24 hash bits reach `thresh` (rate * 2^24). Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
int paddle_dropout_fwd(const void* x, const void* key, void* out, void* mask,
                       long long n, int is_bf16, unsigned int thresh,
                       int upscale, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, key, out, mask, n, thresh, upscale, scale,
                                 st);
  return launch<float>(x, key, out, mask, n, thresh, upscale, scale, st);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
