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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "keep_mask.cuh"
#include "tc_common.cuh"

namespace {

using namespace paddle_fa;
using bf16 = __nv_bfloat16;
using tc::aligned16;
using tc::pack;
using tc::smem_u32;

constexpr int ROWS = 128;     // query rows and keys a block holds
constexpr int THREADS = 256;  // two warpgroups of 64 query rows
constexpr int COLS = 64;      // bf16 columns of one 128-byte swizzled row
constexpr int REGION = ROWS * COLS * 2;  // one [128][64] bf16 box: 16 KB

// negative return codes besides flash_common.cuh's
constexpr int kErrTensorMap = -3;
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

// ---- shared memory, TMA and mbarriers -------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// arrive once and expect `bytes` from the copies that signal `bar`
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one [128][64] box of a 3-D tensor map at (column c0, row c1, head c2)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (uint64_t)((bytes & 0x3FFFF) >> 4);
}

// A 128-byte-swizzled operand in shared memory (PTX ISA, matrix
// descriptor): start address, leading and stride byte offsets, layout 1.
// K-major: rows of 64 bf16 along K, 8-row groups 1024 B apart (the
// leading offset is unused); a k step of 16 adds 32 B to the start.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc_field(addr) | desc_field(16) << 16 | desc_field(1024) << 32 |
         1ull << 62;
}
// MN-major: rows of 64 bf16 along M or N, one row per K index, 8-row
// groups along K 1024 B apart; a k step of 16 adds 2048 B. The stride
// between 64-wide blocks along M or N is never used at M = N = 64: it is
// given the same 1024.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_field(addr) | desc_field(1024) << 16 | desc_field(1024) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving an accumulator across the asynchronous
// product that writes it (read before the commit, after the wait)
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PADDLE_ACC32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define PADDLE_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d += A B, m64n64k16, both operands from shared memory; TA / TB = 1 reads
// that operand MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PADDLE_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : PADDLE_ACC32(d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A B, m64n64k16, A from registers (four bf16 pairs a thread, the
// mma.sync m16n8k16 A layout per warp), B from shared memory
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PADDLE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : PADDLE_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TB));
}

#undef PADDLE_ACC32
#undef PADDLE_D32

// ---- small helpers ---------------------------------------------------------

// the byte offset of (row, column pair starting at 8 j + 2 t) in a
// [128][64] bf16 region with the 128-byte swizzle TMA and wgmma use: the
// 16-byte chunk j of a row is stored at chunk j ^ (row % 8)
__device__ __forceinline__ int swz(int row, int j, int t) {
  return row * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
}

// the sum of the elementwise products of eight bf16 pairs, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + i));
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(y + i));
    s += u.x * v.x + u.y * v.y;
  }
  return s;
}

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous bf16 [BH, rows, D] tensor in boxes of 64
// columns x 128 rows x 1 head, 128-byte swizzle; the copy zero-fills what
// lies past D or past `rows`.
bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int rows, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {COLS, ROWS, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
