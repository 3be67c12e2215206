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

#include "flash_common.cuh"
#include "keep_mask.cuh"

namespace {

using namespace paddle_fa;

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

  load_tile<T, D>(Qs, q + q_base, q0, S);
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
    for (int e = tid; e < BN * D; e += NT) {  // K and V in one pass
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Sk;
      const size_t g = kv_base + (size_t)(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_f32(k[g]) : 0.f;
      Vs[r * D + c] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 scores, then scale, bias (clamped
    // so -inf never meets -inf), ragged and causal masks
    float s[RPT][CPT];
    tile_dot<D>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + tx + 16 * j;
      const float bj = bias_at(bias, b, col, Sk);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        s[i][j] = masked_score(s[i][j], sm_scale, bj, q0 + ty * RPT + i, col,
                               Sk, causal);
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seed, void* o, void* lse, int B, int H, int S, int Sk,
           float sm_scale, int causal, int dropout, float keep_div,
           uint32_t thresh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_fwd_kernel<T, D>), smem, attr_set);
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
