// The bf16 flash-attention backward for Hopper (sm_90a) where one block
// holds the whole key range of a (batch, head): S <= 128 and Sk <= 128.
// One kernel, flash_bwd_fused_kernel, computes delta, dQ, dK and dV; a
// plain C interface.
//
// Replaces, on this path, the delta prologue of `_pallas_bwd` (:492) and
// its two TPU kernels in paddle_tpu/ops/pallas/flash_attention.py:
// `_bwd_kv_kernel` (:344, pallas_call :514) and `_bwd_q_kernel` (:421,
// pallas_call :543). f32, and S or Sk above 128, keep the split kernels of
// flash_attention_bwd.cu (ops/cuda/flash_attention.py: `bwd_route`). The
// function is theirs:
//   delta = rowsum(dO * O)                    (f32, here in the kernel)
//   P  = exp(scale * Q K^T + bias - lse)      (masked as in the forward)
//   dP = dO V^T,   P' = P * keep / (1 - rate), dP' = dP * keep / (1 - rate)
//   dS = P * (dP' - delta) * scale
//   dV = P'^T dO,  dK = dS^T Q,  dQ = dS K
// every sum in f32, P' and dS rounded to bf16 before their products (the
// TPU kernels' rounding points, :397 / :405 / :465), each output rounded
// once. The dropout mask is the forward's, regenerated from the same seed,
// batch*head, row and column by keep_mask.cuh; the scores are masked by
// flash_common.cuh's masked_score, as in every other flash kernel.
//
// What bounds it on this card. Per (batch, head) the function reads Q, K,
// V, O and dO (5 x 16 KB at S = Sk = 128, D = 64, bf16) and lse, and
// writes dQ, dK and dV (3 x 16 KB): 128.5 KB against 10 * S * Sk * D =
// 10.5 MFLOP, 80 FLOP a byte, far under the 295 at which the bf16 tensor
// cores would bind. So it is bound by bytes: at the bench lane's shape (B
// = 256, H = 12) 404 MB, 0.121 ms at 3.35 TB/s, against 0.033 ms of
// products at 989 TFLOP/s. The split path moves more: delta in torch
// passes (f32 copies of O and dO), then each of its two kernels reads Q,
// K, V, dO, lse and delta again and recomputes QK^T and dO V^T.
//
// What the design does about it.
// - One block a (batch, head), all of it: Q, K, V, O and dO arrive once,
//   by TMA (cp.async.bulk.tensor, one mbarrier) as [128 rows][64 columns]
//   boxes in 128-byte-swizzled shared memory; rows past S or Sk and
//   columns past D are zero-filled by the copy. Each input is read from
//   device memory once and each output written once; nothing of size
//   S x Sk leaves the block, and nothing is computed twice.
// - delta is taken from O and dO in shared memory (a row's 16-byte chunks
//   are permuted within the row alike in both tiles, so the row sums need
//   no unswizzling).
// - Two warpgroups of 64 query rows each. Every product is a wgmma
//   m64n64k16 (bf16 operands, f32 accumulators): S = Q K^T and dP = dO V^T
//   with both operands K-major in shared memory, 64 keys at a time; P' is
//   written to shared memory in bf16 and dS is kept in registers, packed
//   as bf16, as the A operand of dQ = dS K (K read MN-major, transposed by
//   the descriptor); then dS is written to shared memory too, and each
//   warpgroup takes 64 keys of dV = P'^T dO and dK = dS^T Q, all four
//   operands MN-major. No atomics: every output element is written once,
//   by one thread, and reruns are bitwise alike.
// - Shared memory is reused as the inputs die: at D = 64, P' goes over O
//   and V, dS over K and one spare region: 96 KB with the bias row and the
//   barrier, so two blocks share an SM and one block's loads overlap the
//   other's products. At D = 128, 160 KB and one block an SM. A persistent
//   variant, one block an SM walking the pairs with the next pair's tiles
//   loading into a second 96 KB stage, ran slower at the bench lane's
//   shape: its eight warps an SM hide less of the elementwise work and of
//   the products' latency than two independent blocks' sixteen.
// - Head dims: the instance is 64 columns (D = 8 .. 64; TMA zero-fills the
//   columns past D) or 128 (two 64-column halves a tile); the wrapper pads
//   any other D to the next of 8, 16, 32, 64 and 128 as for the split
//   kernels.
// - The TMA, mbarrier and wgmma helpers and the host's tensor maps are
//   hopper_common.cuh's, shared with the whole-block forward.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "keep_mask.cuh"
#include "tc_common.cuh"

namespace {

using namespace paddle_fa;
using namespace paddle_fa::hopper;
using bf16 = __nv_bfloat16;
using tc::aligned16;
using tc::pack;
using tc::smem_u32;

constexpr int THREADS = 256;  // two warpgroups of 64 query rows

// negative return code besides flash_common.cuh's and hopper_common.cuh's
constexpr int kErrShape = -4;

// Shared memory of a block, in bytes from a 1024-aligned base: the input
// tiles [128][DP] (DP / 64 regions each), then where P' and dS go, key
// half by key half, each [128 query rows][64 keys], once their inputs are
// dead: at DP = 64 P' over O and V, dS over a spare region and K; at DP =
// 128 P' over O, dS over V.
template <int DP>
struct Smem {
  static constexpr int T = DP / COLS * REGION;  // one tile
  static constexpr int Q = 0, DO = T, K = 2 * T, V = 3 * T, O = 4 * T;
  static constexpr int P0 = O, P1 = DP == 64 ? V : O + REGION;
  static constexpr int S0 = DP == 64 ? 5 * T : V;
  static constexpr int S1 = DP == 64 ? K : V + REGION;
  static constexpr int BIAS = DP == 64 ? 6 * T : 5 * T;  // 128 f32
  static constexpr int BAR = BIAS + ROWS * 4;            // one mbarrier
  static constexpr int BYTES = BAR + 8 + 1024;  // + room to align the base
};

// ---- the kernel ------------------------------------------------------------

// Block bh: batch * head bh. Warpgroup wg owns query rows 64 wg .. 64 wg
// + 63 of S, dP, P', dS and dQ, and keys 64 wg .. 64 wg + 63 of dK and dV.
// In an accumulator of m64n64 a thread (warp w of its group, lane 4 g + t)
// holds d[4 j + 2 e2 + e] at row 16 w + g + 8 e2, column 8 j + 2 t + e.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
    flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ bias,
                           const int* __restrict__ seed_ptr,
                           bf16* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int H, int S, int Sk, int D,
                           float sm_scale, int causal, int dropout,
                           float keep_div, uint32_t thresh) {
  using L = Smem<DP>;
  constexpr int NC = DP / COLS;  // 64-column regions of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on such a line
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  const uint32_t bar = base + L::BAR;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;

  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 5 * NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int off = c * REGION;
      tma_load(base + L::Q + off, &tm_q, c * COLS, 0, bh, bar);
      tma_load(base + L::DO + off, &tm_do, c * COLS, 0, bh, bar);
      tma_load(base + L::K + off, &tm_k, c * COLS, 0, bh, bar);
      tma_load(base + L::V + off, &tm_v, c * COLS, 0, bh, bar);
      tma_load(base + L::O + off, &tm_o, c * COLS, 0, bh, bar);
    }
  }
  // the bias row, clamped (0 without a bias and past Sk)
  if (tid < ROWS) bias_s[tid] = bias_at(bias, b, tid, Sk);

  // this thread's two query rows and their statistics; a row past S gets
  // P = 0 and dS = 0 explicitly (its lse is not read)
  int rows[2];
  bool valid[2];
  float lse_r[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    rows[e2] = 64 * wg + 16 * warp + g + 8 * e2;
    valid[e2] = rows[e2] < S;
    lse_r[e2] = valid[e2] ? lse[(size_t)bh * S + rows[e2]] : 0.f;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;

  mbar_wait(bar, 0);

  // delta = rowsum(dO * O): the row's four threads take 32 bytes of each
  // 128-byte row each, then sum across the quad
  float delta_r[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int off = c * REGION + rows[e2] * 128 + 32 * t;
      const uint4* po = reinterpret_cast<const uint4*>(smem + L::O + off);
      const uint4* pd = reinterpret_cast<const uint4*>(smem + L::DO + off);
      acc += dot8(po[0], pd[0]) + dot8(po[1], pd[1]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta_r[e2] = acc;
  }
  __syncthreads();  // O is dead in every warpgroup; the bias row is in

  // dS of the warpgroup's rows in bf16, key half h: the A operand of
  // dQ = dS K at k step kk is ds_a[h][4 kk .. 4 kk + 3]
  uint32_t ds_a[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // S = Q K^T and dP = dO V^T over keys 64 h .. 64 h + 63
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * REGION + (kk % 4) * 32;
      const uint32_t rows_wg = 64 * wg * 128, keys_h = 64 * h * 128;
      wgmma_ss<0, 0>(s, desc_k(base + L::Q + off + rows_wg),
                     desc_k(base + L::K + off + keys_h));
      wgmma_ss<0, 0>(dp, desc_k(base + L::DO + off + rows_wg),
                     desc_k(base + L::V + off + keys_h));
    }
    wg_commit();
    wg_wait_all();
    fence_acc(s);
    fence_acc(dp);
    if (h == 1) __syncthreads();  // V is dead in every warpgroup

    // P' to shared memory, dS into ds_a, element by element as the TPU
    // kernels form them
    unsigned char* preg = smem + (h == 0 ? L::P0 : L::P1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * e2 + e;
          const int key = 64 * h + 8 * j + 2 * t + e;
          const float x = masked_score(s[i], sm_scale, bias_s[key], rows[e2],
                                       key, Sk, causal);
          const float p = valid[e2] ? __expf(x - lse_r[e2]) : 0.f;
          float pv = p, dpv = dp[i];
          if (dropout) {
            const bool kp = keep(seed, (uint32_t)bh, (uint32_t)rows[e2],
                                 (uint32_t)key, thresh);
            pv = kp ? p * keep_scale : 0.f;
            dpv = kp ? dpv * keep_scale : 0.f;
          }
          pe[e] = pv;
          dp[i] = valid[e2] ? p * (dpv - delta_r[e2]) * sm_scale : 0.f;
        }
        *reinterpret_cast<uint32_t*>(preg + swz(rows[e2], j, t)) =
            pack(pe[0], pe[1]);
        ds_a[h][2 * j + e2] =
            pack(dp[4 * j + 2 * e2], dp[4 * j + 2 * e2 + 1]);
      }
    }
  }
  fence_proxy_async();  // P' visible to the products below

  // dQ = dS K: A from registers, K read MN-major (its rows are the keys)
  {
    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
      fence_acc(acc[c]);
    }
    wg_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs<1>(acc[c], ds_a[h][4 * kk], ds_a[h][4 * kk + 1],
                      ds_a[h][4 * kk + 2], ds_a[h][4 * kk + 3],
                      desc_mn(base + L::K + c * REGION +
                              (64 * h + 16 * kk) * 128));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      if (!valid[e2]) continue;
      bf16* row = dq + ((size_t)bh * S + rows[e2]) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * COLS + 8 * j + 2 * t;
          if (col < D)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack(acc[c][4 * j + 2 * e2], acc[c][4 * j + 2 * e2 + 1]);
        }
    }
  }
  __syncthreads();  // K is dead in every warpgroup

  // dS to shared memory, in the bf16 that dQ took
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned char* sreg = smem + (h == 0 ? L::S0 : L::S1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        *reinterpret_cast<uint32_t*>(sreg + swz(rows[e2], j, t)) =
            ds_a[h][2 * j + e2];
  }
  fence_proxy_async();
  __syncthreads();  // P' and dS of every row are in

  // dV = P'^T dO and dK = dS^T Q over the warpgroup's 64 keys, the query
  // rows as K: all four operands MN-major
  float acc_v[NC][32], acc_k[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_v[c][i] = acc_k[c][i] = 0.f;
    fence_acc(acc_v[c]);
    fence_acc(acc_k[c]);
  }
  const uint32_t preg = base + (wg == 0 ? L::P0 : L::P1);
  const uint32_t sreg = base + (wg == 0 ? L::S0 : L::S1);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    const int off = kk * 16 * 128;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      wgmma_ss<1, 1>(acc_v[c], desc_mn(preg + off),
                     desc_mn(base + L::DO + c * REGION + off));
      wgmma_ss<1, 1>(acc_k[c], desc_mn(sreg + off),
                     desc_mn(base + L::Q + c * REGION + off));
    }
  }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    fence_acc(acc_v[c]);
    fence_acc(acc_k[c]);
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int key = 64 * wg + 16 * warp + g + 8 * e2;
    if (key >= Sk) continue;
    const size_t r0 = ((size_t)bh * Sk + key) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * COLS + 8 * j + 2 * t;
        if (col >= D) continue;
        const int i = 4 * j + 2 * e2;
        *reinterpret_cast<uint32_t*>(dk + r0 + col) =
            pack(acc_k[c][i], acc_k[c][i + 1]);
        *reinterpret_cast<uint32_t*>(dv + r0 + col) =
            pack(acc_v[c][i], acc_v[c][i + 1]);
      }
  }
}

// ---- host side -------------------------------------------------------------

struct FusedArgs {
  const void *q, *k, *v, *o, *dout, *lse, *bias, *seed;
  void *dq, *dk, *dv;
  int B, H, S, Sk, D;
  float sm_scale;
  int causal, dropout;
  float keep_div;
  uint32_t thresh;
};

template <int DP>
int launch(const FusedArgs& a, cudaStream_t stream) {
  const int BH = a.B * a.H;
  CUtensorMap mq, mk, mv, mo, mdo;
  if (!(tensor_map(&mq, a.q, BH, a.S, a.D) &&
        tensor_map(&mk, a.k, BH, a.Sk, a.D) &&
        tensor_map(&mv, a.v, BH, a.Sk, a.D) &&
        tensor_map(&mo, a.o, BH, a.S, a.D) &&
        tensor_map(&mdo, a.dout, BH, a.S, a.D)))
    return kErrTensorMap;
  constexpr size_t smem = Smem<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_bwd_fused_kernel<DP>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_fused_kernel<DP><<<(unsigned)BH, THREADS, smem, stream>>>(
      mq, mk, mv, mo, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.bias), static_cast<const int*>(a.seed),
      static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.H, a.S, a.Sk, a.D, a.sm_scale, a.causal,
      a.dropout, a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq: [B, H, S, D]; k, v, dk, dv: [B, H, Sk, D]; all
// contiguous bf16 (is_bf16 = 1), 16-byte aligned, 1 <= S <= 128,
// 1 <= Sk <= 128, D one of 8, 16, 32, 64, 128. lse: [B*H, S] f32; bias:
// [B, Sk] f32 or null; seed: int32 [1] on the device, read only when
// dropout != 0. Launches one kernel on `stream` and returns the launch's
// cudaError_t (0 on success), or a negative code (paddle_cuda_error_string
// names it).
int paddle_flash_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* bias, const void* seed,
    void* dq, void* dk, void* dv, int B, int H, int S, int Sk, int D,
    int is_bf16, float sm_scale, int causal, int dropout, float keep_div,
    unsigned int thresh, void* stream) {
  if (!is_bf16 || S < 1 || S > ROWS || Sk < 1 || Sk > ROWS) return kErrShape;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
        aligned16(dout)))
    return kErrAlign;
  const FusedArgs a{q, k, v, o, dout, lse, bias, seed, dq, dk, dv,
                    B, H, S, Sk, D, sm_scale, causal, dropout, keep_div,
                    thresh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
    case 16:
    case 32:
    case 64:
      return launch<64>(a, st);
    case 128:
      return launch<128>(a, st);
    default:
      return kErrHeadDim;
  }
}

const char* paddle_cuda_error_string(int err) {
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled is not available or refused a tensor map";
  if (err == kErrShape)
    return "the fused backward takes bf16 with 1 <= S, Sk <= 128";
  return error_string(err);
}

}  // extern "C"
