// FlashAttention-2 backward for Hopper (sm_90a): the dK/dV kernel and the
// dQ kernel, each with a plain C interface.
//
// Replaces the two TPU kernels of `_pallas_bwd` in
// paddle_tpu/ops/pallas/flash_attention.py: `_bwd_kv_kernel` (:344, its
// pallas_call at :514) and `_bwd_q_kernel` (:421, pallas_call at :543).
// Both recompute the forward's probabilities tile by tile from the saved
// row statistic lse, so nothing of size S x Sk is ever stored:
//   P  = exp(scale * Q K^T + bias - lse)      (masked as in the forward)
//   dP = dO V^T,   P' = P * keep / (1 - rate), dP' = dP * keep / (1 - rate)
//   dS = P * (dP' - delta) * scale,           delta = rowsum(dO * O)
//   dV = P'^T dO,  dK = dS^T Q,  dQ = dS K
// with every sum in f32, P' rounded to dO's dtype before P'^T dO and dS
// rounded to the operands' dtype before dS^T Q and dS K (the TPU kernels'
// rounding points, :397 / :405 / :465). The dropout mask is the forward's,
// regenerated from the same seed by keep_mask.cuh; the scores come from
// the same tile_dot loop as the forward's (flash_common.cuh), so P is the
// forward's P.
//
// What bounds it on this card. The function does 10*S*Sk*D FLOP per
// (batch, head): QK^T, dO V^T, P'^T dO, dS^T Q and dS K. At the training
// shape (S = Sk = 128, D = 64, f32) that is 10.5 MFLOP on about 230 KB of
// inputs and outputs, some 45 FLOP per byte: bound by operations on the
// f32 CUDA cores. The two-kernel design recomputes QK^T and dO V^T in both
// kernels (14*S*Sk*D FLOP executed), the price of writing dK/dV and dQ
// without atomics. Like the forward, this first version runs every product
// on the CUDA cores in f32 (bf16 operands are widened on load); wgmma/TMA
// come in a later version. PERF.md has the measured times beside the bound.
//
// Design. The TPU runs an "arbitrary" (sequential) grid dimension and
// carries the dK/dV (or dQ) accumulator across it in VMEM. Here a block
// owns one output tile and a loop inside the block walks the other
// dimension, the accumulator in registers:
//   dK/dV: a block owns 64 keys of one (batch, head) and loops over the Q
//          tiles; K and V stay in shared memory, each Q tile brings Q, dO,
//          lse and delta. P' and dS go through shared memory to be
//          transposed into the dV and dK products. No atomics: the result
//          is deterministic.
//   dQ:    a block owns 64 query rows and loops over the K tiles; Q, dO,
//          lse and delta stay, each K tile brings K and V.
// 256 threads form a 16 x 16 grid as in the forward: for the score tile
// thread (ty, tx) owns rows 4*ty .. 4*ty+3 and columns tx + 16*j; for the
// accumulators it owns tile rows 4*ty .. 4*ty+3 and head-dim columns
// tx + 16*c. Causal tiles wholly above the diagonal are cut by the loop
// bounds. Ragged edges: rows past S get P = 0 and dS = 0 explicitly (a
// load that returned 0 for lse would give P = exp(s), not 0); columns past
// Sk are masked before the exp. A dead row (lse = +1e30) gets P = 0 and
// adds nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "keep_mask.cuh"

namespace {

using namespace paddle_fa;

template <int D>
constexpr size_t kv_smem_bytes() {
  // Ks, Vs [BN][D+1]; Qs, dOs [BM][D+1]; Ps, dSs [BM][BN+1]; lse, delta [BM]
  return sizeof(float) * (2 * BN * (D + 1) + 2 * BM * (D + 1) +
                          2 * BM * (BN + 1) + 2 * BM);
}

template <int D>
constexpr size_t q_smem_bytes() {
  // Qs, dOs [BM][D+1]; Ks, Vs [BN][D+1]; dSs [BM][BN+1]
  return sizeof(float) *
         (2 * BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        const int* __restrict__ seed_ptr, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int S, int Sk,
                        float sm_scale, int causal, int dropout,
                        float keep_div, uint32_t thresh) {
  constexpr int DP = D + 1;
  constexpr int DC = D >= 16 ? D / 16 : 1;  // head-dim columns per thread
  constexpr int PP = BN + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * DP;
  float* Qs = Vs + BN * DP;
  float* dOs = Qs + BM * DP;
  float* Ps = dOs + BM * DP;
  float* dSs = Ps + BM * PP;
  float* lse_s = dSs + BM * PP;
  float* delta_s = lse_s + BM;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * BN;
  const size_t q_base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)bh * Sk * D;
  const size_t row_base = (size_t)bh * S;

  load_tile<T, D>(Ks, k + kv_base, k0, Sk);
  load_tile<T, D>(Vs, v + kv_base, k0, Sk);
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  float bj[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) bj[j] = bias_at(bias, b, k0 + tx + 16 * j, Sk);

  float dk_acc[RPT][DC], dv_acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: Q tiles whose last row precedes this tile's first key add
  // nothing (`k_start <= q_start + blk_q - 1`, :408-413)
  const int t_begin = causal ? k0 / BM : 0;
  const int n_tiles = (S + BM - 1) / BM;
  for (int t = t_begin; t < n_tiles; ++t) {
    const int q0 = t * BM;
    __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs are consumed
    load_tile<T, D>(Qs, q + q_base, q0, S);
    load_tile<T, D>(dOs, dout + q_base, q0, S);
    for (int e = tid; e < BM; e += NT) {
      const bool in = q0 + e < S;
      lse_s[e] = in ? lse[row_base + q0 + e] : -NEG_INF;
      delta_s[e] = in ? delta[row_base + q0 + e] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot<D>(Qs, Ks, s, ty, tx);
    tile_dot<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int row = q0 + r;
      const bool valid = row < S;  // ragged S: P = 0 and dS = 0 explicitly
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x =
            masked_score(s[i][j], sm_scale, bj[j], row, col, Sk, causal);
        const float p = valid ? expf(x - lse_s[r]) : 0.f;
        float pe = p, dpv = dp[i][j];
        if (dropout) {
          const bool kp =
              keep(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)col, thresh);
          pe = kp ? p / keep_div : 0.f;
          dpv = kp ? dpv / keep_div : 0.f;
        }
        const float ds = valid ? p * (dpv - delta_s[r]) * sm_scale : 0.f;
        Ps[r * PP + tx + 16 * j] = as_operand<T>(pe);
        dSs[r * PP + tx + 16 * j] = as_operand<T>(ds);
      }
    }
    __syncthreads();

    // dV += P'^T dO and dK += dS^T Q over this tile's query rows
#pragma unroll 4
    for (int i = 0; i < BM; ++i) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        dov[c] = col < D ? dOs[i * DP + col] : 0.f;
        qv[c] = col < D ? Qs[i * DP + col] : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < RPT; ++jj) {
        const float pv = Ps[i * PP + ty * RPT + jj];
        const float dsv = dSs[i * PP + ty * RPT + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[jj][c] = fmaf(pv, dov[c], dv_acc[jj][c]);
          dk_acc[jj][c] = fmaf(dsv, qv[c], dk_acc[jj][c]);
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < RPT; ++jj) {
    const int key = k0 + ty * RPT + jj;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        const size_t g = kv_base + (size_t)key * D + col;
        dk[g] = from_f32<T>(dk_acc[jj][c]);
        dv[g] = from_f32<T>(dv_acc[jj][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias,
                       const int* __restrict__ seed_ptr, T* __restrict__ dq,
                       int H, int S, int Sk, float sm_scale, int causal,
                       int dropout, float keep_div, uint32_t thresh) {
  constexpr int DP = D + 1;
  constexpr int DC = D >= 16 ? D / 16 : 1;
  constexpr int PP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * DP;
  float* Ks = dOs + BM * DP;
  float* Vs = Ks + BN * DP;
  float* dSs = Vs + BN * DP;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t q_base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)bh * Sk * D;
  const size_t row_base = (size_t)bh * S;

  load_tile<T, D>(Qs, q + q_base, q0, S);
  load_tile<T, D>(dOs, dout + q_base, q0, S);
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  // rows past S: lse = +1e30 makes P = 0 (their dQ is never stored)
  float lse_r[RPT], delta_r[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    lse_r[i] = row < S ? lse[row_base + row] : -NEG_INF;
    delta_r[i] = row < S ? delta[row_base + row] : 0.f;
  }

  float acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);  // :468-473

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's Ks / Vs / dSs are consumed
    load_tile<T, D>(Ks, k + kv_base, k0, Sk);
    load_tile<T, D>(Vs, v + kv_base, k0, Sk);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
    tile_dot<D>(Qs, Ks, s, ty, tx);
    tile_dot<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + tx + 16 * j;
      const float bj = bias_at(bias, b, col, Sk);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty * RPT + i;
        // ragged Sk: masked_score sets columns past Sk to NEG_INF
        const float x =
            masked_score(s[i][j], sm_scale, bj, row, col, Sk, causal);
        const float p = expf(x - lse_r[i]);
        float dpv = dp[i][j];
        if (dropout)
          dpv = keep(seed, (uint32_t)bh, (uint32_t)row, (uint32_t)col, thresh)
                    ? dpv / keep_div
                    : 0.f;
        const float ds = p * (dpv - delta_r[i]) * sm_scale;
        dSs[(ty * RPT + i) * PP + tx + 16 * j] = as_operand<T>(ds);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < D ? Ks[j * DP + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float dsv = dSs[(ty * RPT + i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(dsv, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dq[q_base + (size_t)row * D + col] = from_f32<T>(acc[i][c]);
    }
  }
}

// One argument list for both kernels: what the wrapper passes through.
struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta, *bias, *seed;
  int B, H, S, Sk;
  float sm_scale;
  int causal, dropout;
  float keep_div;
  uint32_t thresh;
};

template <typename T, int D>
int launch_kv(const BwdArgs& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr size_t smem = kv_smem_bytes<D>();
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_bwd_kv_kernel<T, D>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sk + BN - 1) / BN, a.B * a.H);
  flash_bwd_kv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.bias), static_cast<const int*>(a.seed),
      static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.S, a.Sk, a.sm_scale,
      a.causal, a.dropout, a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_q(const BwdArgs& a, void* dq, cudaStream_t stream) {
  constexpr size_t smem = q_smem_bytes<D>();
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_bwd_q_kernel<T, D>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BM - 1) / BM, a.B * a.H);
  flash_bwd_q_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.bias), static_cast<const int*>(a.seed),
      static_cast<T*>(dq), a.H, a.S, a.Sk, a.sm_scale, a.causal, a.dropout,
      a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

// head dim x dtype dispatch; which = 0 launches dK/dV, 1 launches dQ
template <typename T>
int dispatch(int which, int D, const BwdArgs& a, void* out0, void* out1,
             cudaStream_t st) {
#define PADDLE_FA_BWD_CASE(DD)                              \
  case DD:                                                  \
    return which == 0 ? launch_kv<T, DD>(a, out0, out1, st) \
                      : launch_q<T, DD>(a, out0, st);
  switch (D) {
    PADDLE_FA_BWD_CASE(8)
    PADDLE_FA_BWD_CASE(16)
    PADDLE_FA_BWD_CASE(32)
    PADDLE_FA_BWD_CASE(64)
    PADDLE_FA_BWD_CASE(128)
    default:
      return -1;
  }
#undef PADDLE_FA_BWD_CASE
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta,
        const void* bias, const void* seed, void* out0, void* out1, int B,
        int H, int S, int Sk, int D, int is_bf16, float sm_scale, int causal,
        int dropout, float keep_div, unsigned int thresh, void* stream) {
  const BwdArgs a{q, k, v, dout, lse, delta, bias, seed, B, H, S, Sk,
                  sm_scale, causal, dropout, keep_div, thresh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(which, D, a, out0, out1, st)
                 : dispatch<float>(which, D, a, out0, out1, st);
}

}  // namespace

extern "C" {

// q, dout: [B, H, S, D]; k, v: [B, H, Sk, D]; all contiguous and of one
// dtype, f32 (is_bf16 = 0) or bf16. lse, delta: [B*H, S] f32; bias: [B, Sk]
// f32 or null; seed: int32 [1] on the device, read only when dropout != 0.
// Each launches one kernel on `stream` and returns the launch's
// cudaError_t (0 on success), or -1 for an unsupported head dim.

// dk, dv: like k.
int paddle_flash_attention_bwd_kv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* bias, const void* seed,
                                  void* dk, void* dv, int B, int H, int S,
                                  int Sk, int D, int is_bf16, float sm_scale,
                                  int causal, int dropout, float keep_div,
                                  unsigned int thresh, void* stream) {
  return run(0, q, k, v, dout, lse, delta, bias, seed, dk, dv, B, H, S, Sk,
             D, is_bf16, sm_scale, causal, dropout, keep_div, thresh, stream);
}

// dq: like q.
int paddle_flash_attention_bwd_q(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* bias,
                                 const void* seed, void* dq, int B, int H,
                                 int S, int Sk, int D, int is_bf16,
                                 float sm_scale, int causal, int dropout,
                                 float keep_div, unsigned int thresh,
                                 void* stream) {
  return run(1, q, k, v, dout, lse, delta, bias, seed, dq, nullptr, B, H, S,
             Sk, D, is_bf16, sm_scale, causal, dropout, keep_div, thresh,
             stream);
}

const char* paddle_cuda_error_string(int err) {
  return err < 0 ? "unsupported head dim"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
