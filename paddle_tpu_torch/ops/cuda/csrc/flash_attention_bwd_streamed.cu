// The bf16 flash-attention backward for Hopper (sm_90a) where S or Sk is
// above 128, so that one block cannot hold a (batch, head) whole: two
// kernels, launched in this order, each with a plain C interface.
//   flash_bwd_dq_streamed_kernel    delta = rowsum(dO * O), dQ
//   flash_bwd_dkdv_streamed_kernel  dK, dV
//
// Replaces, on this path, the delta prologue of `_pallas_bwd` (:492) and
// its two TPU kernels in paddle_tpu/ops/pallas/flash_attention.py:
// `_bwd_q_kernel` (:421, pallas_call :543) and `_bwd_kv_kernel` (:344,
// pallas_call :514). bf16 with S, Sk <= 128 runs the fused backward
// (flash_attention_bwd_fused.cu); f32 keeps the split kernels of
// flash_attention_bwd.cu (ops/cuda/flash_attention.py: `bwd_route`). The
// function is theirs:
//   delta = rowsum(dO * O)                    (f32, in the dQ kernel)
//   P  = exp(scale * Q K^T + bias - lse)      (masked as in the forward)
//   dP = dO V^T,   P' = P * keep / (1 - rate), dP' = dP * keep / (1 - rate)
//   dS = P * (dP' - delta) * scale
//   dV = P'^T dO,  dK = dS^T Q,  dQ = dS K
// every sum in f32, P' and dS rounded to bf16 before their products (the
// TPU kernels' rounding points, :397 / :405 / :465), each output rounded
// once. The dropout mask is the forward's, regenerated by keep_mask.cuh;
// the scores are masked by flash_common.cuh's masked_score.
//
// What bounds it on this card. The function reads Q, K, V, O, dO and lse
// and writes dQ, dK and dV once (8 x S x D bf16 a (batch, head) at S =
// Sk) against 10 * S * Sk * D FLOP of products; at S = Sk = 512, D = 64
// that is 512 KB against 168 MFLOP, 320 FLOP a byte, so at the S = 512
// bert lane's shape (B = 64, H = 12) it is bound by its products: 0.130
// ms at 989 TFLOP/s against 0.120 ms of bytes; at S = Sk = 256 by bytes.
// Two kernels without atomics recompute P and dP in each: they execute 14
// * S * Sk * D FLOP, not 10. The split route it replaces takes delta in
// torch passes (f32 copies of O and dO) and runs mma.sync on 64-row tiles.
//
// What the design does about it.
// - No floating-point atomics: every output element is written once, by
//   one thread, so reruns are bitwise alike. That is why dQ has its own
//   kernel, as in the TPU kernel's two pallas_calls.
// - The dQ kernel: one block a (batch, head, 128 query rows), two
//   warpgroups of 64 rows. Q, dO and O arrive by TMA; delta is taken from
//   O and dO in shared memory (a row's 16-byte chunks are permuted alike
//   in both, so the row sums need no unswizzling) and written, with the
//   rows' lse times log2 e, to a scratch buffer laid out [B*H][query
//   tile][lse, delta][128] f32, which the dK/dV kernel streams by one
//   bulk copy a tile. K and V then stream in 128-key tiles through a
//   two-stage TMA ring (arrival and release mbarriers for each of K and
//   V a stage; thread 0 refills a slot once all 256 threads have released
//   it; O's slot at first). A warpgroup takes a tile's keys 64 at a time:
//   S = Q K^T and dP = dO V^T by wgmma (both operands K-major in shared
//   memory) as two groups, P formed while dP is in flight, then dS in
//   registers, packed to bf16 as the A operand of dQ += dS K (K read
//   MN-major), whose product is in flight while the next 64 keys' S and dP
//   are issued. dQ leaves by TMA over the warpgroup's own rows of Q.
// - The dK/dV kernel: one block a (batch, head, 128 keys), two
//   warpgroups of 64 keys, dK and dV held in registers. K and V arrive
//   once; Q, dO and the lse/delta tile stream in 128-row tiles through
//   the same kind of ring, 64 rows at a time: S^T = K Q^T and dP^T =
//   V dO^T by wgmma, so P'^T and dS^T come out in the accumulator's
//   registers, keys as rows, and feed dV += P'^T dO and dK += dS^T Q as A
//   operands from registers (dO and Q read MN-major): four products, and
//   nothing of size S x Sk goes through shared memory.
// - P = 2^(s c + bias - lse), with c the softmax scale times log2 e: one
//   multiply-add and one ex2 an element where no mask reaches (every row
//   below S and key below Sk, under causal masking every key at or below
//   the first row; in the dQ kernel also no bias), masked_score elsewhere.
// - Causal tiles wholly above the diagonal are not loaded: key tiles past
//   a query tile's last row in the dQ kernel, query tiles before a key
//   tile's first key in the dK/dV kernel (whose keys then get dK = dV = 0
//   when no query reaches them).
// - Occupancy: the dQ kernel at D = 64 is Q, dO and the ring, 96 KB, two
//   blocks an SM if ptxas keeps it under 128 registers; the dK/dV kernel
//   holds two accumulators beside the four products' operands, one block
//   an SM. At D = 128, one block an SM each. Head dims below 128 are
//   padded by the wrapper as for the other kernels.
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
using tc::aligned16;
using tc::pack;
using tc::smem_u32;

constexpr int THREADS = 256;  // two warpgroups of 64 rows (or keys)
constexpr int WG_ROWS = 64;   // rows (or keys) of a warpgroup: its out box
constexpr int STATS = 2 * ROWS * 4;  // a tile's lse and delta, f32: 1 KB

// negative return code besides flash_common.cuh's and hopper_common.cuh's
constexpr int kErrShape = -4;

// the 1024-aligned base of the dynamic shared memory
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---- dQ --------------------------------------------------------------------

// Shared memory of a dQ block, in bytes from a 1024-aligned base: Q and dO
// [128][DP] (dQ written over Q at the end), then the ring: stage s holds K
// at KV + 2 s T and V at KV + (2 s + 1) T (O in stage 1's K slot before the
// first K tile there); then the mbarriers: Q/dO/O arrived, K and V of each
// stage arrived, K and V of each stage released.
template <int DP>
struct SmemQ {
  static constexpr int T = DP / COLS * REGION;  // one tile
  static constexpr int Q = 0, DO = T, KV = 2 * T, O = KV + 2 * T;
  static constexpr int BAR = 6 * T;
  static constexpr int BYTES = BAR + 9 * 8 + 1024;  // + room to align
};

// Block x: (batch * head bh, 128-row query tile). Warpgroup wg owns query
// rows 64 wg .. 64 wg + 63 of the tile and takes the keys 64 at a time (a
// unit: half a stage). In an accumulator of m64n64 a thread (warp w of its
// group, lane 4 g + t) holds d[4 j + 2 e2 + e] at row 16 w + g + 8 e2,
// column 8 j + 2 t + e.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
    flash_bwd_dq_streamed_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_o,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_dq,
        const float* __restrict__ lse, const float* __restrict__ bias,
        const int* __restrict__ seed_ptr, float* __restrict__ stats, int H,
        int S, int Sk, int n_qt, float sm_scale, int causal, int dropout,
        float keep_div, uint32_t thresh) {
  using L = SmemQ<DP>;
  constexpr int NC = DP / COLS;  // 64-column regions of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + L::BAR;  // Q, dO and O arrived
  const uint32_t bar_k = bar_q + 8;      // + 8 s: K of stage s arrived
  const uint32_t bar_v = bar_q + 24;     // + 8 s: V of stage s arrived
  const uint32_t free_k = bar_q + 40;    // + 8 s: K of stage s released
  const uint32_t free_v = bar_q + 56;    // + 8 s: V of stage s released

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qt;
  // the heaviest causal tiles (the last rows) first
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int q0 = qt * ROWS;
  const int b = bh / H;

  int n_kt = (Sk + ROWS - 1) / ROWS;
  if (causal) n_kt = min(n_kt, (min(q0 + ROWS, S) - 1) / ROWS + 1);

  // K and V of key tile i into stage i & 1
  auto load_k = [&](int i) {
    const int s = i & 1;
    mbar_expect_tx(bar_k + 8 * s, NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(base + L::KV + 2 * s * L::T + c * REGION, &tm_k, c * COLS,
               i * ROWS, bh, bar_k + 8 * s);
  };
  auto load_v = [&](int i) {
    const int s = i & 1;
    mbar_expect_tx(bar_v + 8 * s, NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(base + L::KV + (2 * s + 1) * L::T + c * REGION, &tm_v,
               c * COLS, i * ROWS, bh, bar_v + 8 * s);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(free_k + 8 * s, THREADS);
      mbar_init(free_v + 8 * s, THREADS);
    }
    mbar_expect_tx(bar_q, 3 * NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int off = c * REGION;
      tma_load(base + L::Q + off, &tm_q, c * COLS, q0, bh, bar_q);
      tma_load(base + L::DO + off, &tm_do, c * COLS, q0, bh, bar_q);
      tma_load(base + L::O + off, &tm_o, c * COLS, q0, bh, bar_q);
    }
    load_k(0);
    load_v(0);
  }
  __syncthreads();  // the barriers are initialised

  // this thread's two query rows (local to the tile) and their lse in
  // log2 units; a row past S gets P = 0 and dS = 0 explicitly
  int rows[2];
  bool valid[2];
  float lse2[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    rows[e2] = WG_ROWS * wg + 16 * warp + g + 8 * e2;
    valid[e2] = q0 + rows[e2] < S;
    lse2[e2] = valid[e2] ? lse[(size_t)bh * S + q0 + rows[e2]] * LOG2E : 0.f;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  const float c2 = sm_scale * LOG2E;

  mbar_wait(bar_q, 0);

  // delta = rowsum(dO * O): the row's four threads take 32 bytes of each
  // 128-byte row each, then sum across the quad; lse (log2 units) and
  // delta go to the dK/dV kernel's tile of the scratch buffer
  float delta_r[2];
  float* st = stats + ((size_t)bh * n_qt + qt) * (2 * ROWS);
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int off = c * REGION + rows[e2] * 128 + 32 * t;
      const uint4* po = reinterpret_cast<const uint4*>(smem + L::O + off);
      const uint4* pd = reinterpret_cast<const uint4*>(smem + L::DO + off);
      a += dot8(po[0], pd[0]) + dot8(po[1], pd[1]);
    }
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    delta_r[e2] = valid[e2] ? a : 0.f;
    if (t == 0) {
      st[rows[e2]] = lse2[e2];
      st[ROWS + rows[e2]] = delta_r[e2];
    }
  }
  __syncthreads();  // O is dead in every warpgroup: stage 1 is free
  if (tid == 0 && n_kt > 1) {
    load_k(1);
    load_v(1);
  }

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;
    fence_acc(acc[c]);
  }
  const uint32_t qa = base + L::Q + WG_ROWS * wg * 128;
  const uint32_t da = base + L::DO + WG_ROWS * wg * 128;

  // Units u = 2 i + h (keys 128 i + 64 h .. + 63). Committed groups,
  // oldest first, once unit u has issued its S and dP: dQ(u - 1), S(u),
  // dP(u); an empty group stands for dQ(-1). P is formed while dP is in
  // flight.
  wg_commit();
  for (int i = 0; i < n_kt; ++i) {
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    const uint32_t kd = base + L::KV + 2 * s * L::T, vd = kd + L::T;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = i * ROWS + 64 * h;
      if (h == 0) {
        mbar_wait(bar_k + 8 * s, ph);
        mbar_wait(bar_v + 8 * s, ph);
      }
      float sc[32], dp[32];
      wgmma_abt<DP>(sc, qa, kd + 64 * h * 128);  // S = Q K^T
      wgmma_abt<DP>(dp, da, vd + 64 * h * 128);  // dP = dO V^T
      wg_wait<1>();  // dQ(u - 1) and S(u) have landed
      fence_acc(sc);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
      if (h == 0 && i > 0) {
        // the previous stage's K has no reader left: release it, refill it
        // with tile i + 1 once every thread has
        const int sp = (i - 1) & 1;
        mbar_arrive(free_k + 8 * sp);
        if (tid == 0 && i + 1 < n_kt) {
          mbar_wait(free_k + 8 * sp, ((i - 1) >> 1) & 1);
          load_k(i + 1);
        }
        __syncwarp();  // warp 0 whole again before its next wgmma
      }

      // P = 2^(x - lse) in place, x the scaled, biased and masked score in
      // log2 units; a unit that no mask reaches skips the masks
      const bool plain = bias == nullptr && k0 + 64 <= Sk &&
                         !(causal && k0 + 63 > q0 + WG_ROWS * wg);
      if (plain) {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          sc[x] = exp2_approx(__fmaf_rn(sc[x], c2, -lse2[(x >> 1) & 1]));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            const float bk = bias_at(bias, b, key, Sk);
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int x = 4 * j + 2 * e2 + e;
              const float sx = masked_score(sc[x], sm_scale, bk,
                                            q0 + rows[e2], key, Sk, causal);
              sc[x] = valid[e2] ? exp2_approx(__fmaf_rn(sx, LOG2E, -lse2[e2]))
                                : 0.f;
            }
          }
      }
      wg_wait<0>();  // dP(u) has landed
      fence_acc(dp);
      if (h == 1) {
        // both units of the stage have read its V
        mbar_arrive(free_v + 8 * s);
        if (tid == 0 && i + 2 < n_kt) {
          mbar_wait(free_v + 8 * s, ph);
          load_v(i + 2);
        }
        __syncwarp();
      }

      // dS = P (dP' - delta) scale, packed to bf16 as the A operand of
      // dQ += dS K
      uint32_t ds_a[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dv[2][2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * e2 + e;
            float dpv = dp[x];
            if (dropout)
              dpv = keep(seed, (uint32_t)bh, (uint32_t)(q0 + rows[e2]),
                         (uint32_t)(k0 + 8 * j + 2 * t + e), thresh)
                        ? dpv * keep_scale
                        : 0.f;
            dv[e2][e] = sc[x] * (dpv - delta_r[e2]) * sm_scale;
          }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          ds_a[2 * j + e2] = pack(dv[e2][0], dv[e2][1]);
      }

      // dQ += dS K: A from registers, K read MN-major (its rows are the
      // keys)
      wg_fence();
      wgmma_rab<NC>(acc, ds_a, kd + 64 * h * 128);
      wg_commit();
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(acc[c]);

  // dQ in bf16 over the warpgroup's rows of Q, out by TMA (rows past S
  // and columns past D are not written)
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * e2;
        *reinterpret_cast<uint32_t*>(smem + L::Q + c * REGION +
                                     swz(rows[e2], j, t)) =
            pack(acc[c][x], acc[c][x + 1]);
      }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if ((tid & 127) == 0 && q0 + WG_ROWS * wg < S) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_store(&tm_dq, base + L::Q + c * REGION + WG_ROWS * wg * 128,
                c * COLS, q0 + WG_ROWS * wg, bh);
    tma_store_wait_read();
  }
}

// ---- dK and dV -------------------------------------------------------------

// Shared memory of a dK/dV block, in bytes from a 1024-aligned base: K and
// V [128][DP] (dK and dV written over them at the end), then the ring:
// stage s holds Q at QD + 2 s T and dO at QD + (2 s + 1) T, and its
// lse/delta tile at ST + s STATS; then the mbarriers: K/V arrived, Q (with
// lse/delta) and dO of each stage arrived, each stage released.
template <int DP>
struct SmemKV {
  static constexpr int T = DP / COLS * REGION;  // one tile
  static constexpr int K = 0, V = T, QD = 2 * T;
  static constexpr int ST = 6 * T;
  static constexpr int BAR = ST + 2 * STATS;
  static constexpr int BYTES = BAR + 7 * 8 + 1024;  // + room to align
};

// Block x: (batch * head bh, 128-key tile). Warpgroup wg owns keys 64 wg
// .. 64 wg + 63 of the tile, the rows of its S^T, dP^T, dK and dV
// accumulators (the layout above, keys as rows, query rows as columns),
// and takes the query rows 64 at a time (a unit: half a stage).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_streamed_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_dk,
        const __grid_constant__ CUtensorMap tm_dv,
        const float* __restrict__ stats, const float* __restrict__ bias,
        const int* __restrict__ seed_ptr, int H, int S, int Sk, int n_qt,
        int n_kt, float sm_scale, int causal, int dropout, float keep_div,
        uint32_t thresh) {
  using L = SmemKV<DP>;
  constexpr int NC = DP / COLS;  // 64-column regions of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_kv = base + L::BAR;  // K and V arrived
  const uint32_t bar_q = bar_kv + 8;      // + 8 s: Q, lse/delta of stage s
  const uint32_t bar_d = bar_kv + 24;     // + 8 s: dO of stage s arrived
  const uint32_t bar_e = bar_kv + 40;     // + 8 s: stage s released

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_kt;
  const int kt = (int)(blockIdx.x % n_kt);
  const int k0 = kt * ROWS;
  const int b = bh / H;

  // query tiles: all of S, or under causal masking from the one that
  // holds the tile's first key
  const int tq0 = causal ? kt : 0;
  const int n = max(n_qt - tq0, 0);

  // query tile tq0 + i into stage i & 1
  auto load_stage = [&](int i) {
    const int s = i & 1, tq = tq0 + i;
    const uint32_t qd = base + L::QD + 2 * s * L::T, dd = qd + L::T;
    mbar_expect_tx(bar_q + 8 * s, NC * REGION + STATS);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(qd + c * REGION, &tm_q, c * COLS, tq * ROWS, bh, bar_q + 8 * s);
    bulk_load(base + L::ST + s * STATS,
              stats + ((size_t)bh * n_qt + tq) * (2 * ROWS), STATS,
              bar_q + 8 * s);
    mbar_expect_tx(bar_d + 8 * s, NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(dd + c * REGION, &tm_do, c * COLS, tq * ROWS, bh,
               bar_d + 8 * s);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_q + 8 * s, 1);
      mbar_init(bar_d + 8 * s, 1);
      mbar_init(bar_e + 8 * s, THREADS);
    }
    mbar_expect_tx(bar_kv, 2 * NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(base + L::K + c * REGION, &tm_k, c * COLS, k0, bh, bar_kv);
      tma_load(base + L::V + c * REGION, &tm_v, c * COLS, k0, bh, bar_kv);
    }
    if (n > 0) load_stage(0);
    if (n > 1) load_stage(1);
  }
  __syncthreads();  // the barriers are initialised

  // this thread's two keys (absolute) and their clamped bias, also in
  // log2 units
  int keys[2];
  float bias_k[2], bias2[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    keys[e2] = k0 + WG_ROWS * wg + 16 * warp + g + 8 * e2;
    bias_k[e2] = bias_at(bias, b, keys[e2], Sk);
    bias2[e2] = bias_k[e2] * LOG2E;
  }
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  const float c2 = sm_scale * LOG2E;
  const uint32_t ka = base + L::K + WG_ROWS * wg * 128;
  const uint32_t va = base + L::V + WG_ROWS * wg * 128;

  float acc_v[NC][32], acc_k[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int x = 0; x < 32; ++x) acc_v[c][x] = acc_k[c][x] = 0.f;
    fence_acc(acc_v[c]);
    fence_acc(acc_k[c]);
  }
  mbar_wait(bar_kv, 0);

  // Units u = 2 i + h (query rows 128 (tq0 + i) + 64 h .. + 63).
  // Committed groups, oldest first, once unit u has issued its S^T and
  // dP^T: dV/dK(u - 1), S^T(u), dP^T(u); an empty group stands for
  // dV/dK(-1). P' is formed while dP^T is in flight.
  wg_commit();
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    const uint32_t qd = base + L::QD + 2 * s * L::T, dd = qd + L::T;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + L::ST + s * STATS);
    const float* delta_s = lse_s + ROWS;
    const int q0 = (tq0 + i) * ROWS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = q0 + 64 * h;  // the unit's first query row
      if (h == 0) {
        mbar_wait(bar_q + 8 * s, ph);
        mbar_wait(bar_d + 8 * s, ph);
      }
      float sc[32], dp[32];
      wgmma_abt<DP>(sc, ka, qd + 64 * h * 128);  // S^T = K Q^T
      wgmma_abt<DP>(dp, va, dd + 64 * h * 128);  // dP^T = V dO^T
      wg_wait<1>();  // dV/dK(u - 1) and S^T(u) have landed
      fence_acc(sc);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        fence_acc(acc_v[c]);
        fence_acc(acc_k[c]);
      }
      if (h == 0 && i > 0) {
        // the previous stage has no reader left: release it, refill it
        // with tile i + 1 once every thread has
        const int sp = (i - 1) & 1;
        mbar_arrive(bar_e + 8 * sp);
        if (tid == 0 && i + 1 < n) {
          mbar_wait(bar_e + 8 * sp, ((i - 1) >> 1) & 1);
          load_stage(i + 1);
        }
        __syncwarp();  // warp 0 whole again before its next wgmma
      }

      // P^T = 2^(x - lse) in place (f32, for dS) and P'^T packed to bf16
      // as the A operand of dV += P'^T dO; a unit that no mask reaches
      // (every row below S and every key below Sk and, under causal
      // masking, every key at or below the unit's first row) skips the
      // masks
      const bool plain = r0 + 64 <= S && k0 + ROWS <= Sk &&
                         !(causal && k0 + ROWS - 1 > r0);
      uint32_t p_a[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 64 * h + 8 * j + 2 * t + e;  // row in the tile
          const float lse_q = lse_s[r];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int x = 4 * j + 2 * e2 + e;
            float p;
            if (plain) {
              p = exp2_approx(__fmaf_rn(sc[x], c2, bias2[e2] - lse_q));
            } else {
              const float sx =
                  masked_score(sc[x], sm_scale, bias_k[e2], q0 + r,
                               keys[e2], Sk, causal);
              p = q0 + r < S ? exp2_approx(__fmaf_rn(sx, LOG2E, -lse_q)) : 0.f;
            }
            sc[x] = p;
            pv[e2][e] =
                dropout && !keep(seed, (uint32_t)bh, (uint32_t)(q0 + r),
                                 (uint32_t)keys[e2], thresh)
                    ? 0.f
                    : p * keep_scale;
          }
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          p_a[2 * j + e2] = pack(pv[e2][0], pv[e2][1]);
      }
      wg_wait<0>();  // dP^T(u) has landed
      fence_acc(dp);

      // dS^T = P^T (dP'^T - delta) scale, packed to bf16 as the A operand
      // of dK += dS^T Q
      uint32_t ds_a[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dv[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 64 * h + 8 * j + 2 * t + e;
          const float delta_q = delta_s[r];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int x = 4 * j + 2 * e2 + e;
            float dpv = dp[x];
            if (dropout)
              dpv = keep(seed, (uint32_t)bh, (uint32_t)(q0 + r),
                         (uint32_t)keys[e2], thresh)
                        ? dpv * keep_scale
                        : 0.f;
            dv[e2][e] = sc[x] * (dpv - delta_q) * sm_scale;
          }
        }
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          ds_a[2 * j + e2] = pack(dv[e2][0], dv[e2][1]);
      }

      // dV += P'^T dO and dK += dS^T Q: A from registers, dO and Q read
      // MN-major (their rows are the query rows)
      wg_fence();
      wgmma_rab<NC>(acc_v, p_a, dd + 64 * h * 128);
      wgmma_rab<NC>(acc_k, ds_a, qd + 64 * h * 128);
      wg_commit();
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    fence_acc(acc_v[c]);
    fence_acc(acc_k[c]);
  }

  // dK and dV in bf16 over the warpgroup's keys of K and V, out by TMA
  // (keys past Sk and columns past D are not written)
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int r = WG_ROWS * wg + 16 * warp + g + 8 * e2;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * e2;
        const int off = c * REGION + swz(r, j, t);
        *reinterpret_cast<uint32_t*>(smem + L::K + off) =
            pack(acc_k[c][x], acc_k[c][x + 1]);
        *reinterpret_cast<uint32_t*>(smem + L::V + off) =
            pack(acc_v[c][x], acc_v[c][x + 1]);
      }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if ((tid & 127) == 0 && k0 + WG_ROWS * wg < Sk) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int off = c * REGION + WG_ROWS * wg * 128;
      tma_store(&tm_dk, base + L::K + off, c * COLS, k0 + WG_ROWS * wg, bh);
      tma_store(&tm_dv, base + L::V + off, c * COLS, k0 + WG_ROWS * wg, bh);
    }
    tma_store_wait_read();
  }
}

// ---- host side -------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *o, *dout, *lse, *bias, *seed;
  void *dq, *dk, *dv, *stats;
  int B, H, S, Sk, D;
  float sm_scale;
  int causal, dropout;
  float keep_div;
  uint32_t thresh;
};

template <int DP>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const int BH = a.B * a.H;
  const int n_qt = (a.S + ROWS - 1) / ROWS;
  CUtensorMap mq, mk, mv, mo, mdo, mdq;
  if (!(tensor_map(&mq, a.q, BH, a.S, a.D) &&
        tensor_map(&mk, a.k, BH, a.Sk, a.D) &&
        tensor_map(&mv, a.v, BH, a.Sk, a.D) &&
        tensor_map(&mo, a.o, BH, a.S, a.D) &&
        tensor_map(&mdo, a.dout, BH, a.S, a.D) &&
        tensor_map(&mdq, a.dq, BH, a.S, a.D, WG_ROWS)))
    return kErrTensorMap;
  constexpr size_t smem = SmemQ<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_bwd_dq_streamed_kernel<DP>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_streamed_kernel<DP>
      <<<(unsigned)((size_t)BH * n_qt), THREADS, smem, stream>>>(
          mq, mk, mv, mo, mdo, mdq, static_cast<const float*>(a.lse),
          static_cast<const float*>(a.bias), static_cast<const int*>(a.seed),
          static_cast<float*>(a.stats), a.H, a.S, a.Sk, n_qt, a.sm_scale,
          a.causal, a.dropout, a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkdv(const BwdArgs& a, cudaStream_t stream) {
  const int BH = a.B * a.H;
  const int n_qt = (a.S + ROWS - 1) / ROWS;
  const int n_kt = (a.Sk + ROWS - 1) / ROWS;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!(tensor_map(&mq, a.q, BH, a.S, a.D) &&
        tensor_map(&mk, a.k, BH, a.Sk, a.D) &&
        tensor_map(&mv, a.v, BH, a.Sk, a.D) &&
        tensor_map(&mdo, a.dout, BH, a.S, a.D) &&
        tensor_map(&mdk, a.dk, BH, a.Sk, a.D, WG_ROWS) &&
        tensor_map(&mdv, a.dv, BH, a.Sk, a.D, WG_ROWS)))
    return kErrTensorMap;
  constexpr size_t smem = SmemKV<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_bwd_dkdv_streamed_kernel<DP>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_streamed_kernel<DP>
      <<<(unsigned)((size_t)BH * n_kt), THREADS, smem, stream>>>(
          mq, mk, mv, mdo, mdk, mdv, static_cast<const float*>(a.stats),
          static_cast<const float*>(a.bias), static_cast<const int*>(a.seed),
          a.H, a.S, a.Sk, n_qt, n_kt, a.sm_scale, a.causal, a.dropout,
          a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

int check(const BwdArgs& a) {
  if (a.S < 1 || a.Sk < 1) return kErrShape;
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
        aligned16(a.dout) && aligned16(a.stats)))
    return kErrAlign;
  switch (a.D) {
    case 8:
    case 16:
    case 32:
    case 64:
    case 128:
      return 0;
    default:
      return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// Both entry points: q, o, dout, dq: [B, H, S, D]; k, v, dk, dv: [B, H, Sk,
// D]; all contiguous bf16 (is_bf16 = 1), 16-byte aligned, S >= 1, Sk >= 1,
// D one of 8, 16, 32, 64, 128. lse: [B*H, S] f32 from the forward; bias:
// [B, Sk] f32 or null; seed: int32 [1] on the device, read only when
// dropout != 0; stats: f32 [B*H, ceil(S / 128), 2, 128] (lse times log2 e
// and delta, by 128-row tile), 16-byte aligned, written by the dQ kernel
// and read by the dK/dV kernel, which must run after it on the same
// stream. Each launches one kernel on `stream` and
// returns the launch's cudaError_t (0 on success), or a negative code
// (paddle_cuda_error_string names it).
int paddle_flash_attention_bwd_dq_streamed(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* bias, const void* seed,
    void* dq, void* stats, int B, int H, int S, int Sk, int D, int is_bf16,
    float sm_scale, int causal, int dropout, float keep_div,
    unsigned int thresh, void* stream) {
  const BwdArgs a{q, k, v, o, dout, lse, bias, seed, dq, nullptr, nullptr,
                  stats, B, H, S, Sk, D, sm_scale, causal, dropout, keep_div,
                  thresh};
  if (!is_bf16) return kErrShape;
  if (const int rc = check(a)) return rc;
  if (!(aligned16(o) && aligned16(dq))) return kErrAlign;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_dq<128>(a, st) : launch_dq<64>(a, st);
}

int paddle_flash_attention_bwd_dkdv_streamed(
    const void* q, const void* k, const void* v, const void* dout,
    const void* bias, const void* seed, const void* stats, void* dk,
    void* dv, int B, int H, int S, int Sk, int D, int is_bf16,
    float sm_scale, int causal, int dropout, float keep_div,
    unsigned int thresh, void* stream) {
  const BwdArgs a{q, k, v, nullptr, dout, nullptr, bias, seed, nullptr, dk,
                  dv, const_cast<void*>(stats), B, H, S, Sk, D, sm_scale,
                  causal, dropout, keep_div, thresh};
  if (!is_bf16) return kErrShape;
  if (const int rc = check(a)) return rc;
  if (!(aligned16(dk) && aligned16(dv))) return kErrAlign;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_dkdv<128>(a, st) : launch_dkdv<64>(a, st);
}

const char* paddle_cuda_error_string(int err) {
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled is not available or refused a tensor map";
  if (err == kErrShape)
    return "the streamed backward takes bf16 with S, Sk >= 1";
  return error_string(err);
}

}  // extern "C"
