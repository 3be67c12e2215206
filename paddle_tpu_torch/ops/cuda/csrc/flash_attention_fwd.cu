// FlashAttention-2 forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_fwd_kernel` / `_pallas_fwd` in
// paddle_tpu/ops/pallas/flash_attention.py (:219, :298) and computes the
// same function:
//   O   = softmax(scale * Q K^T + bias, masked) V       (dropout on V only)
//   lse = m + log(l) per query row
// with m, l and the O accumulator in f32, the key-padding bias clamped at
// NEG_INF = -1e30, top-left causal masking, ragged S / Sk, the counter-hash
// dropout mask of `_keep_mask` (bit-identical), and the dead-row rule of
// `_finalize` (a row whose running max stays at NEG_INF writes O = 0 and
// lse = +1e30). lse is written as [B*H, S] f32, not in the TPU's 128-lane
// layout.
//
// What bounds it on this card. At BERT-base serving shapes (S = Sk = 128,
// D = 64) the kernel does 4*S*Sk*D = 4.2 MFLOP per (batch, head) on
// 128 KB of f32 Q/K/V/O, 32 FLOP per byte: above the ridge point of the
// f32 CUDA cores (their published peak over the memory's), so f32 is
// bound by operations, while bf16 on the tensor cores would be bound by
// bytes. This first version is the simple, exact one: it runs both
// products on the CUDA cores in f32 (bf16 operands are widened on load),
// so it is operation-bound in both types; PERF.md has its measured time
// beside the bound.
//
// Design. The TPU carries m / l / acc across a sequential grid dimension;
// here one thread block owns a 64-row Q tile of one (batch, head) and a
// loop inside the block walks the K/V tiles, staged through shared memory
// in f32. 256 threads form a 16 x 16 grid: thread (ty, tx) owns query rows
// 4*ty .. 4*ty+3, the score columns tx + 16*j of each tile and the output
// columns tx + 16*c. The 16 threads that share a row sit in one half-warp,
// so the row max and row sum are warp shuffles. Shared tiles have an odd
// row stride so that the column reads of a half-warp hit 16 banks.
// Causal tiles above the diagonal are cut by the loop bound; ragged edges
// are loads that return 0 (the TPU needed `_zero_pad_rows` because its
// padded tiles are uninitialised). wgmma/TMA come in a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per K/V tile
constexpr int NT = 256;  // threads per block: 16 row groups x 16 lanes
constexpr int RPT = 4;   // query rows per thread (BM / 16)
constexpr int CPT = 4;   // score columns per thread (BN / 16)

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

// The TPU kernel feeds P to the PV product in V's dtype: round it the same.
template <typename T>
__device__ __forceinline__ float as_operand(float x) {
  return to_f32(from_f32<T>(x));
}

// `_keep_mask` (flash_attention.py:149): a Wang-style uint32 mix over
// (seed, batch*head, absolute row, absolute col) with wrap-around
// multiplies; keep when the low 24 bits reach rate * 2^24.
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

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BM][D+1], Ks [BN][D+1], Vs [BN][D], Ps [BM][BN+1], all f32
  return sizeof(float) *
         (BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, T* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int Sk,
                     float sm_scale, int causal, int dropout, float keep_div,
                     uint32_t thresh) {
  constexpr int DP = D + 1;                  // odd stride: conflict-free
  constexpr int DC = D >= 16 ? D / 16 : 1;   // output columns per thread
  constexpr int PP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* Ps = Vs + BN * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t q_base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)bh * Sk * D;

  for (int e = tid; e < BM * D; e += NT) {
    const int r = e / D, c = e % D;
    Qs[r * DP + c] =
        q0 + r < S ? to_f32(q[q_base + (size_t)(q0 + r) * D + c]) : 0.f;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;

  float m_i[RPT], l_i[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int e = tid; e < BN * D; e += NT) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Sk;
      const size_t g = kv_base + (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_f32(k[g]) : 0.f;
      Vs[r * D + c] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 scores
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, bias (clamped so -inf never meets -inf), ragged and causal
    // masks — in the TPU kernel's order
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + tx + 16 * j;
      const float bj = (bias != nullptr && col < Sk)
                           ? fmaxf(bias[(size_t)b * Sk + col], NEG_INF)
                           : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty * RPT + i;
        float x = __fadd_rn(__fmul_rn(s[i][j], sm_scale), bj);
        if (col >= Sk) x = NEG_INF;
        if (causal && col > row) x = NEG_INF;
        s[i][j] = x;
      }
    }

    // online softmax: l takes the full probabilities, dropout scales only
    // the values that enter the PV product
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < CPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      const int row = q0 + ty * RPT + i;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float p = expf(s[i][j] - m_new);
        rs += p;
        if (dropout) {
          const int col = k0 + tx + 16 * j;
          p = keep(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)col, thresh)
                  ? p / keep_div
                  : 0.f;
        }
        Ps[(ty * RPT + i) * PP + tx + 16 * j] = as_operand<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = alpha * l_i[i] + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? Vs[j * D + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty * RPT + i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  // finalize (`_finalize`): dead rows write zeros and lse = +1e30
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= S) continue;
    const bool dead = m_i[i] <= NEG_INF * 0.5f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        o[q_base + (size_t)row * D + col] =
            from_f32<T>(dead ? 0.f : acc[i][c] / l_i[i]);
    }
    if (tx == 0)
      lse[(size_t)bh * S + row] = dead ? -NEG_INF : m_i[i] + logf(l_i[i]);
  }
}

constexpr int kMaxDevices = 64;

// The shared-memory opt-in is a per-device property of each template
// instance: set it on the first launch on a device, not on every launch.
// Two threads racing here both set the same value, which is harmless.
template <typename T, int D>
cudaError_t ensure_smem_attr() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<D>());
  if (err == cudaSuccess && cached) done[dev] = true;
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seed, void* o, void* lse, int B, int H, int S, int Sk,
           float sm_scale, int causal, int dropout, float keep_div,
           uint32_t thresh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const cudaError_t err = ensure_smem_attr<T, D>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(seed), static_cast<T*>(o),
      static_cast<float*>(lse), H, S, Sk, sm_scale, causal, dropout, keep_div,
      thresh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* bias, const void* seed, void* o, void* lse, int B,
               int H, int S, int Sk, float sm_scale, int causal, int dropout,
               float keep_div, uint32_t thresh, cudaStream_t st) {
#define PADDLE_FA_CASE(DD)                                                   \
  case DD:                                                                   \
    return launch<T, DD>(q, k, v, bias, seed, o, lse, B, H, S, Sk, sm_scale, \
                         causal, dropout, keep_div, thresh, st);
  switch (D) {
    PADDLE_FA_CASE(8)
    PADDLE_FA_CASE(16)
    PADDLE_FA_CASE(32)
    PADDLE_FA_CASE(64)
    PADDLE_FA_CASE(128)
    default:
      return -1;
  }
#undef PADDLE_FA_CASE
}

}  // namespace

extern "C" {

// q, k, v: [B, H, S|Sk, D] contiguous, f32 (is_bf16 = 0) or bf16;
// bias: [B, Sk] f32 or null; seed: int32 [1] on the device, read only when
// dropout != 0; o: like q; lse: [B*H, S] f32. Launches on `stream` and
// returns the launch's cudaError_t (0 on success), or -1 for an
// unsupported head dim.
int paddle_flash_attention_fwd(const void* q, const void* k, const void* v,
                               const void* bias, const void* seed, void* o,
                               void* lse, int B, int H, int S, int Sk, int D,
                               int is_bf16, float sm_scale, int causal,
                               int dropout, float keep_div,
                               unsigned int thresh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, bias, seed, o, lse, B, H, S,
                                     Sk, sm_scale, causal, dropout, keep_div,
                                     thresh, st);
  return dispatch_d<float>(D, q, k, v, bias, seed, o, lse, B, H, S, Sk,
                           sm_scale, causal, dropout, keep_div, thresh, st);
}

const char* paddle_cuda_error_string(int err) {
  return err < 0 ? "unsupported head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
