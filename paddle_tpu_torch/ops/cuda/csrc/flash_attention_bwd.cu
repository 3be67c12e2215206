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
// regenerated from the same seed by keep_mask.cuh. The scores are
// recomputed, not stored, on the tensor cores (split TF32 or bf16,
// tc_common.cuh) in both kernels, so each kernel's P agrees with the
// forward's within rounding, not bit for bit; each is held to its plain
// version within tolerance.
//
// What bounds them on this card. The function does 10*S*Sk*D FLOP per
// (batch, head): QK^T, dO V^T, P'^T dO, dS^T Q and dS K. The two-kernel
// design recomputes QK^T and dO V^T in both kernels (8 + 6 = 14*S*Sk*D
// FLOP executed), the price of writing dK/dV and dQ without atomics. At
// the training shape (B = 32, H = 12, S = Sk = 128, D = 64, f32):
// - the dK/dV kernel does 3.22 GFLOP and moves Q, K, V, dO, lse, delta and
//   the bias in and dK, dV out, 75.9 MB: 22.7 us of bytes at 3.35 TB/s
//   against 19.5 us of split-TF32 products (3 x FLOP at 495 TFLOP/s);
// - the dQ kernel does 6*S*Sk*D FLOP (QK^T, dO V^T, dS K), 2.42 GFLOP, and
//   moves the same inputs in and dQ out, 63.3 MB: 18.9 us of bytes against
//   14.6 us of split-TF32 products.
// Both are bound by bytes on paper; in f32 the tensor-core instruction
// stream (three mma.sync and two operand splits a product) sets their
// time. PERF.md has the measured times beside the bounds.
//
// Shared by both kernels:
// - Products on the tensor cores with mma.sync: f32 as split TF32
//   (m16n8k8, three products), bf16 as it is (m16n8k16), sums in f32. Not
//   wgmma: its TF32 form reads B only K-major from shared memory, and dV,
//   dK and dQ take dO, Q and K along their rows, which are stored row by
//   row: they would need transposed copies, and split TF32 would need hi
//   and lo copies of every B tile besides. mma.sync loads fragments from
//   any layout into registers and splits them there (tc::load_b_kn).
// - The score tile is formed in the accumulator registers and fed, without
//   a trip through shared memory, as the A operand of the next product
//   (tc::a_from_acc). P is __expf(x - lse) (ex2.approx, a few ulp) and
//   dropout multiplies by 1 / (1 - rate): a full expf and a division per
//   element cost measurable time.
// - Operands arrive by cp.async into a two-stage ring, the copy of tile
//   t + 1 issued before the products of tile t. Rows past S or Sk are
//   zero-filled by the copy; a padded query row gets P = 0 explicitly (a
//   zero lse would give P = exp(s), not 0), and columns past Sk are masked
//   before the exp. A dead row (lse = +1e30) gets P = 0 and adds nothing.
//
// The dK/dV kernel. The TPU runs an "arbitrary" (sequential) grid
// dimension and carries the dK/dV accumulator across it in VMEM. Here a
// block owns 64 keys of one (batch, head) and loops over the query rows,
// 32 at a time, dK and dV in registers; no atomics, so the result is
// deterministic.
// - Four warps; warp w owns keys 16w .. 16w+15. Every product is computed
//   key-major, so that the score tiles come out with keys as rows:
//   S^T = K Q^T and dP^T = V dO^T, then P'^T and dS^T are formed in the
//   accumulator registers and become the A operand of dV += P'^T dO and
//   dK += dS^T Q.
// - K and V are copied once; Q, dO, lse and delta arrive in the ring, 32
//   query rows a stage.
// - Causal: query stages whose last row precedes the block's first key
//   are cut by the loop bound.
// - Occupancy: 768 blocks at the training shape. Shared memory is K, V and
//   two stages of Q and dO, 4 x 64 x (D + 16 B) rows, plus 512 B of lse
//   and delta: 70,144 B for f32 at D = 64, 37,376 B for bf16, 135,680 B
//   for f32 at D = 128. ptxas (chip_smoke.py prints it): 168 registers for
//   f32 at D = 64, 166 for bf16, no spills, so three blocks (12 warps) an
//   SM; the 32-row stages are what keep the score tiles, and with them
//   the registers, small enough for the third.
//
// The dQ kernel. The TPU carries the dQ accumulator across the key grid
// dimension; here a block owns 64 query rows of one (batch, head) and
// loops over the key tiles, dQ in registers; no atomics.
// - The forward's layout: two warpgroups (eight warps). Warp w of group g
//   owns rows 16 (w % 4) .. +15 and, of every 64-key tile, keys
//   32 g .. 32 g + 31: S = Q K^T and dP = dO V^T (A = Q or dO by load_a,
//   B = K or V by load_b_nk), dS formed in place of dP, then dQ += dS K
//   (A = dS by a_from_acc, B = K rows by load_b_kn, in the TF32 k order
//   of the forward's P V). The two groups' partial dQ tiles are summed
//   through shared memory at the end, a plain sum with no rescale, in a
//   fixed order, so dQ is deterministic.
// - Q, dO, lse and delta of the block's rows arrive by cp.async once; K
//   and V in the ring, 64 keys a stage.
// - Causal: key tiles past the block's last row are cut by the loop bound
//   (:468-473).
// - Occupancy: 768 blocks at the training shape (two per (batch, head)).
//   Shared memory is Q, dO and two stages of K and V, 6 x 64 x (D + 16 B)
//   rows, plus 512 B of lse and delta: 104,960 B for f32 at D = 64,
//   55,808 B for bf16, 203,264 B for f32 at D = 128, so two blocks (16
//   warps) an SM up to D = 64, one above. Two blocks of 256 threads allow
//   128 registers a thread, for 16 values each of S and dP beside 32 dQ
//   accumulators at D = 64. ptxas (chip_smoke.py prints it): 124
//   registers for f32 at D = 64, 122 for bf16, no spills; 181 and 180 at
//   D = 128. A variant that held half of that score tile at a time, to
//   leave more room, ran 1.8 times slower in f32 (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "keep_mask.cuh"
#include "tc_common.cuh"

namespace {

using namespace paddle_fa;

constexpr int BQ = 32;  // query rows a stage of the dK/dV kernel's ring

template <typename T, int D>
constexpr size_t kv_smem_bytes() {
  // Ks, Vs [64][ST], then two stages of (Qs, dOs) [BQ][ST] and two of
  // (lse, delta) [BQ] f32
  return sizeof(T) * (2 + 2) * tc::Tile<T, D>::ELEMS +
         sizeof(float) * 4 * BQ;
}

// the dQ kernel: two warpgroups, each taking half of every key tile
constexpr int Q_THREADS = 2 * tc::THREADS;
constexpr int Q_SLICE = BN / 2;  // keys of a tile a warp takes

template <typename T, int D>
constexpr size_t q_smem_bytes() {
  // Qs, dOs [64][ST], two stages of (Ks, Vs) [64][ST], lse and delta [BM]
  return sizeof(T) * 6 * tc::Tile<T, D>::ELEMS + sizeof(float) * 2 * BM;
}

// registers: three blocks an SM up to D = 64 (168 a thread), one above
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS, D <= 64 ? 3 : 1)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        const int* __restrict__ seed_ptr, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int S, int Sk,
                        float sm_scale, int causal, int dropout,
                        float keep_div, uint32_t thresh) {
  using M = tc::Mma<T>;
  constexpr int ST = tc::Tile<T, D>::STRIDE;
  constexpr int TILE = tc::Tile<T, D>::ELEMS;
  constexpr int QTILE = BQ * ST;  // a stage's Q or dO rows
  constexpr int NJ = BQ / 8;      // 8-row query tiles of a stage
  constexpr int DN = D / 8;       // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE;
  T* ring = Vs + TILE;  // stage s: Q at ring + 2 s QTILE, dO after it
  float* rowstat = reinterpret_cast<float*>(ring + 4 * QTILE);
  // stage s: lse at rowstat + 2 s BQ, delta after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // one linear grid, the key tiles of a (batch, head) adjacent: B*H is
  // not held to gridDim.y's 65535
  const int k_tiles = (Sk + BN - 1) / BN;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / H;
  const int k0 = (blockIdx.x % k_tiles) * BN;
  const size_t q_base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)bh * Sk * D;
  const size_t row_base = (size_t)bh * S;
  const int m0 = warp * 16;               // the warp's keys in the tile
  const int keys[2] = {k0 + m0 + g, k0 + m0 + g + 8};

  auto issue_q = [&](int tile, int stage) {
    T* Qs = ring + 2 * stage * QTILE;
    const int q0 = tile * BQ;
    tc::copy_tile_async<T, D, tc::THREADS, BQ>(Qs, q + q_base, q0, S);
    tc::copy_tile_async<T, D, tc::THREADS, BQ>(Qs + QTILE, dout + q_base,
                                               q0, S);
    const int e = threadIdx.x;  // BQ lse, then BQ delta
    if (e < 2 * BQ) {
      const int r = e % BQ;
      const bool in = q0 + r < S;
      const float* src = e < BQ ? lse : delta;
      tc::cp_async4(rowstat + 2 * stage * BQ + e,
                    in ? src + row_base + q0 + r : src, in);
    }
  };

  // causal: query rows before this tile's first key add nothing
  // (`k_start <= q_start + blk_q - 1`, :408-413)
  const int t_begin = causal ? k0 / BQ : 0;
  const int n_tiles = (S + BQ - 1) / BQ;
  tc::copy_tile_async<T, D>(Ks, k + kv_base, k0, Sk);
  tc::copy_tile_async<T, D>(Vs, v + kv_base, k0, Sk);
  if (t_begin < n_tiles) issue_q(t_begin, 0);
  tc::cp_async_commit();

  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  float bk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) bk[h] = bias_at(bias, b, keys[h], Sk);

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  for (int it = t_begin; it < n_tiles; ++it) {
    const int stage = (it - t_begin) & 1;
    if (it + 1 < n_tiles) {
      issue_q(it + 1, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and K, V) have landed for every thread
    const int q0 = it * BQ;
    const T* Qs = ring + 2 * stage * QTILE;
    const T* dOs = Qs + QTILE;
    const float* lse_s = rowstat + 2 * stage * BQ;
    const float* delta_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by BQ query rows
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += M::K) {
      typename M::A a;
      tc::load_a<ST, D>(a, Ks, m0, kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename M::B bq;
        tc::load_b_nk<ST, D>(bq, Qs, 8 * j, kk, g, t);
        tc::mma(s[j], a, bq);
      }
      tc::load_a<ST, D>(a, Vs, m0, kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename M::B bo;
        tc::load_b_nk<ST, D>(bo, dOs, 8 * j, kk, g, t);
        tc::mma(dp[j], a, bo);
      }
    }

    // element (key, query row) of each accumulator: s becomes P'^T and dp
    // becomes dS^T, in place
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int r = 8 * j + tc::acc_col(t, i);  // query row in the stage
        const int row = q0 + r;
        const bool valid = row < S;  // ragged S: P = 0 and dS = 0 explicitly
        const float x = masked_score(s[j][i], sm_scale, bk[h], row, keys[h],
                                     Sk, causal);
        const float p = valid ? __expf(x - lse_s[r]) : 0.f;
        float pe = p, dpv = dp[j][i];
        if (dropout) {
          const bool kp = keep(seed, (uint32_t)bh, (uint32_t)row,
                               (uint32_t)keys[h], thresh);
          pe = kp ? p * keep_scale : 0.f;
          dpv = kp ? dpv * keep_scale : 0.f;
        }
        s[j][i] = pe;
        dp[j][i] = valid ? p * (dpv - delta_s[r]) * sm_scale : 0.f;
      }

    // dV += P'^T dO and dK += dS^T Q over this stage's query rows
#pragma unroll
    for (int kk = 0; kk < BQ; kk += M::K) {
      typename M::A pa, da;
      tc::a_from_acc(pa, s, kk / M::K);
      tc::a_from_acc(da, dp, kk / M::K);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        typename M::B bo, bq;
        tc::load_b_kn<ST>(bo, dOs, kk, 8 * n, g, t);
        tc::mma(dv_acc[n], pa, bo);
        tc::load_b_kn<ST>(bq, Qs, kk, 8 * n, g, t);
        tc::mma(dk_acc[n], da, bq);
      }
    }
    __syncthreads();  // stage `stage` is free for tile it + 2
  }
  tc::cp_async_wait<0>();  // no copy outlives the block (causal, no tiles)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = keys[h];
    if (key >= Sk) continue;
    const size_t g0 = kv_base + (size_t)key * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      tc::store2(dk + g0 + 8 * n, dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      tc::store2(dv + g0 + 8 * n, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// registers: two blocks an SM up to D = 64 (128 a thread), one above
template <typename T, int D>
__global__ void __launch_bounds__(Q_THREADS, D <= 64 ? 2 : 1)
    flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias,
                       const int* __restrict__ seed_ptr, T* __restrict__ dq,
                       int H, int S, int Sk, float sm_scale, int causal,
                       int dropout, float keep_div, uint32_t thresh) {
  using M = tc::Mma<T>;
  constexpr int ST = tc::Tile<T, D>::STRIDE;
  constexpr int TILE = tc::Tile<T, D>::ELEMS;
  constexpr int NJ = Q_SLICE / 8;  // 8-key accumulator tiles of a warp
  constexpr int DN = D / 8;        // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE;
  T* ring = dOs + TILE;  // stage s: K at ring + 2 s TILE, V after it
  float* lse_s = reinterpret_cast<float*>(ring + 4 * TILE);
  float* delta_s = lse_s + BM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp >> 2;          // which keys of each tile
  const int m0 = (warp & 3) * 16;       // the warp's rows in the tile
  const int c0 = group * Q_SLICE;       // the warp's keys in the tile
  const int q_tiles = (S + BM - 1) / BM;  // one linear grid, as dK/dV's
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H;
  const int q0 = (blockIdx.x % q_tiles) * BM;
  const size_t q_base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)bh * Sk * D;
  const size_t row_base = (size_t)bh * S;
  const int rows[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  // ragged S: P = 0 explicitly (the zero-filled lse would give exp(s))
  const bool valid[2] = {rows[0] < S, rows[1] < S};

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);  // :468-473

  auto issue_kv = [&](int tile, int stage) {
    T* Ks = ring + 2 * stage * TILE;
    tc::copy_tile_async<T, D, Q_THREADS>(Ks, k + kv_base, tile * BN, Sk);
    tc::copy_tile_async<T, D, Q_THREADS>(Ks + TILE, v + kv_base, tile * BN,
                                         Sk);
  };
  tc::copy_tile_async<T, D, Q_THREADS>(Qs, q + q_base, q0, S);
  tc::copy_tile_async<T, D, Q_THREADS>(dOs, dout + q_base, q0, S);
  {
    const int e = threadIdx.x;  // BM lse, then BM delta
    if (e < 2 * BM) {
      const int r = e % BM;
      const bool in = q0 + r < S;
      const float* src = e < BM ? lse : delta;
      tc::cp_async4(lse_s + e, in ? src + row_base + q0 + r : src, in);
    }
  }
  issue_kv(0, 0);
  tc::cp_async_commit();

  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue_kv(it + 1, (it + 1) & 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and Q, dO, lse, delta) landed for all
    const T* Ks = ring + 2 * (it & 1) * TILE;
    const T* Vs = Ks + TILE;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_r[h] = lse_s[m0 + g + 8 * h];
      delta_r[h] = delta_s[m0 + g + 8 * h];
    }

    const int k0 = it * BN + c0;  // the warp's first key

    // S = Q K^T and dP = dO V^T: the warp's 16 rows by its 32 keys
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += M::K) {
      typename M::A a;
      tc::load_a<ST, D>(a, Qs, m0, kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename M::B bk;
        tc::load_b_nk<ST, D>(bk, Ks, c0 + 8 * j, kk, g, t);
        tc::mma(s[j], a, bk);
      }
      tc::load_a<ST, D>(a, dOs, m0, kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        typename M::B bv;
        tc::load_b_nk<ST, D>(bv, Vs, c0 + 8 * j, kk, g, t);
        tc::mma(dp[j], a, bv);
      }
    }

    // dS = P (dP' - delta) scale in place of dP, at each element's
    // absolute (row, key): scale, clamped bias, ragged and causal masks
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        const float bj = bias_at(bias, b, col, Sk);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * h + e;
          const float x = masked_score(s[j][i], sm_scale, bj, rows[h], col,
                                       Sk, causal);
          const float p = valid[h] ? __expf(x - lse_r[h]) : 0.f;
          float dpv = dp[j][i];
          if (dropout)
            dpv = keep(seed, (uint32_t)bh, (uint32_t)rows[h], (uint32_t)col,
                       thresh)
                      ? dpv * keep_scale
                      : 0.f;
          dp[j][i] = p * (dpv - delta_r[h]) * sm_scale;
        }
      }

    // dQ += dS K over the warp's keys, dS from the registers it was formed
    // in (rounded to the operands' dtype there, :465)
#pragma unroll
    for (int kk = 0; kk < Q_SLICE; kk += M::K) {
      typename M::A a;
      tc::a_from_acc(a, dp, kk / M::K);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        typename M::B bk;
        tc::load_b_kn<ST>(bk, Ks, c0 + kk, 8 * n, g, t);
        tc::mma(acc[n], a, bk);
      }
    }
    __syncthreads();  // stage it & 1 is free for tile it + 2
  }

  // sum the two warpgroups' partial dQ of each row through the free ring:
  // group 1 hands over, group 0 adds and stores (rows past S never)
  float* xch = reinterpret_cast<float*>(ring);
  const int slot = threadIdx.x & (tc::THREADS - 1);
  static_assert(4 * DN * tc::THREADS * sizeof(float) <=
                    4 * sizeof(T) * tc::Tile<T, D>::ELEMS,
                "the merge fits in the ring");
  if (group == 1) {
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xch[(4 * n + i) * tc::THREADS + slot] = acc[n][i];
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!valid[h]) continue;
    T* row = dq + q_base + (size_t)rows[h] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      tc::store2(row + 8 * n,
                 acc[n][2 * h] + xch[(4 * n + 2 * h) * tc::THREADS + slot],
                 acc[n][2 * h + 1] +
                     xch[(4 * n + 2 * h + 1) * tc::THREADS + slot]);
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
  if (!(tc::aligned16(a.q) && tc::aligned16(a.k) && tc::aligned16(a.v) &&
        tc::aligned16(a.dout)))
    return kErrAlign;
  constexpr size_t smem = kv_smem_bytes<T, D>();
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_bwd_kv_kernel<T, D>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.Sk + BN - 1) / BN) *
                  (unsigned)(a.B * a.H));
  flash_bwd_kv_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
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
  if (!(tc::aligned16(a.q) && tc::aligned16(a.k) && tc::aligned16(a.v) &&
        tc::aligned16(a.dout)))
    return kErrAlign;
  constexpr size_t smem = q_smem_bytes<T, D>();
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_bwd_q_kernel<T, D>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.S + BM - 1) / BM) *
                  (unsigned)(a.B * a.H));
  flash_bwd_q_kernel<T, D><<<grid, Q_THREADS, smem, stream>>>(
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
      return kErrHeadDim;
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
// cudaError_t (0 on success), or a negative code (paddle_cuda_error_string
// names it). Both kernels read q, k, v and dout with cp.async: they must
// be 16-byte aligned.

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
  return error_string(err);
}

}  // extern "C"
