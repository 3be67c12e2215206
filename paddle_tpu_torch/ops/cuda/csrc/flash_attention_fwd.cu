// FlashAttention-2 forward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface.
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
// lse = +1e30). P enters P V in the operands' dtype. lse is written as
// [B*H, S] f32, not in the TPU's 128-lane layout.
//
// What bounds it on this card. The function does 4*S*Sk*D FLOP per (batch,
// head) and moves Q, K, V, O, the bias and lse once. At the served shape
// (B = 8, H = 12, S = Sk = 128, D = 64, f32) that is 0.40 GFLOP on 12.6 MB:
// 3.8 us of bytes at 3.35 TB/s against 2.4 us of split-TF32 products
// (3 x FLOP at 495 TFLOP/s), so it is bound by bytes, in bf16 too.
//
// Design (tc_common.cuh has the fragments and the numerics):
// - One block per 64 query rows of one (batch, head), of two warpgroups
//   (eight warps). Warp w of group g owns rows 16 (w % 4) .. +15 and, of
//   every 64-key tile, keys 32 g .. 32 g + 31: each group runs the online
//   softmax over its half of the keys with its own (m, l, acc), and the
//   two merge through shared memory at the end, rescaled to the common
//   max (a split of the key axis inside the block). Per warp that halves
//   the serial work of a tile, and it puts 16 warps on an SM. The row max
//   and row sum within a warp are quad shuffles. 64-row tiles give 192
//   blocks at B = 8 (96 (batch, head) pairs) on 132 SMs, where 128-row
//   tiles would leave 36 SMs idle.
// - Q K^T and P V run on the tensor cores with mma.sync: f32 operands as
//   split TF32 (m16n8k8, three products), bf16 operands as they are
//   (m16n8k16), sums in f32. Not wgmma: its TF32 form reads B from shared
//   memory and only K-major, so split TF32 would need hi and lo copies of
//   each K tile written back to shared memory, and P V's B operand (V,
//   stored key by key) would need a transposed copy; mma.sync takes its
//   fragments from registers in any layout and splits them there. With
//   split TF32 the f32 kernel runs six times the tensor-core instructions
//   of the bf16 one, and those, not the bytes, set its time: PERF.md has
//   it beside the bound.
// - S stays in registers: the accumulator tile of Q K^T is masked,
//   exponentiated, dropped out and fed as the A operand of P V
//   (tc::a_from_acc), with no trip through shared memory. The exponentials
//   of the loop are __expf (ex2.approx, a few ulp: far inside the 1e-4
//   the kernel is held to), the dropout scale a multiply by 1 / (1 - rate)
//   and the final 1 / l one division a row: each a division or a full
//   expf an element cost the kernel measurably.
// - Q and the K/V tiles arrive by cp.async, 16 bytes a thread, into a
//   two-stage ring: the copy of K/V tile t + 1 is issued before the
//   products of tile t. Rows past S or Sk are zero-filled by the copy, and
//   columns past Sk are masked before the exp.
// - Causal tiles above the diagonal are cut by the loop bound.
// - Occupancy: shared memory is Q plus two stages of K and V, 5 x 64 x
//   (D + 16 B) rows: 87,040 B for f32 at D = 64, 46,080 B for bf16,
//   168,960 B for f32 at D = 128. ptxas (chip_smoke.py prints it): 121
//   registers for f32 at D = 64, 117 for bf16, no spills, so two blocks
//   (16 warps) an SM; 159 for f32 at D = 128, one block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "keep_mask.cuh"
#include "tc_common.cuh"

namespace {

using namespace paddle_fa;

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * 5 * tc::Tile<T, D>::ELEMS;  // Q, 2 x (K, V)
}

constexpr int GROUPS = 2;                   // warpgroups a block
constexpr int FWD_THREADS = GROUPS * tc::THREADS;
constexpr int SLICE = BN / GROUPS;          // keys of a tile a warp takes
constexpr int NJ = SLICE / 8;               // its 8-key accumulator tiles

// registers: two blocks an SM up to D = 64 (128 a thread), one above
template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS, D <= 64 ? 2 : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const int* __restrict__ seed_ptr, T* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int Sk,
                     float sm_scale, int causal, int dropout, float keep_div,
                     uint32_t thresh) {
  using M = tc::Mma<T>;
  constexpr int ST = tc::Tile<T, D>::STRIDE;
  constexpr int TILE = tc::Tile<T, D>::ELEMS;
  constexpr int DN = D / 8;  // 8-column output tiles
  constexpr int NX = 4 * DN + 4;  // values a thread hands over in the merge
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + TILE;  // stage s: K at ring + 2 s TILE, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp >> 2;            // which keys of each tile
  const int m0 = (warp & 3) * 16;         // the warp's rows in the tile
  const int c0 = group * SLICE;           // the warp's keys in the tile
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BM;
  const size_t q_base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)bh * Sk * D;
  const int rows[2] = {q0 + m0 + g, q0 + m0 + g + 8};

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  auto issue_kv = [&](int tile, int stage) {
    T* Ks = ring + 2 * stage * TILE;
    tc::copy_tile_async<T, D, FWD_THREADS>(Ks, k + kv_base, tile * BN, Sk);
    tc::copy_tile_async<T, D, FWD_THREADS>(Ks + TILE, v + kv_base,
                                           tile * BN, Sk);
  };
  tc::copy_tile_async<T, D, FWD_THREADS>(Qs, q + q_base, q0, S);
  issue_kv(0, 0);
  tc::cp_async_commit();

  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN + c0;  // the warp's first key
    if (it + 1 < n_tiles) {
      issue_kv(it + 1, (it + 1) & 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed for every thread
    const T* Ks = ring + 2 * (it & 1) * TILE;
    const T* Vs = Ks + TILE;

    // S = Q K^T: the warp's 16 rows by its 32 keys, NJ tiles of 8
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
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
    }

    // scale, clamped bias, ragged and causal masks at each element's
    // absolute (row, column)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        const float bj = bias_at(bias, b, col, Sk);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[j][2 * h + e] = masked_score(s[j][2 * h + e], sm_scale, bj,
                                         rows[h], col, Sk, causal);
      }

    // online softmax per row (h = 0: row g, h = 1: row g + 8) over the
    // warp's keys; l takes the full probabilities, dropout scales only the
    // values that enter P V
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      const float alpha = __expf(m_i[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = __expf(s[j][2 * h + e] - m_new);
          rs += p;
          if (dropout) {
            const int col = k0 + 8 * j + 2 * t + e;
            p = keep(seed, (uint32_t)bh, (uint32_t)rows[h], (uint32_t)col,
                     thresh)
                    ? p * keep_scale
                    : 0.f;
          }
          s[j][2 * h + e] = p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_i[h] = alpha * l_i[h] + rs;
      m_i[h] = m_new;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }

    // acc += P V over the warp's keys, P from the registers it was
    // computed in
#pragma unroll
    for (int kk = 0; kk < SLICE; kk += M::K) {
      typename M::A a;
      tc::a_from_acc(a, s, kk / M::K);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        typename M::B bv;
        tc::load_b_kn<ST>(bv, Vs, c0 + kk, 8 * n, g, t);
        tc::mma(acc[n], a, bv);
      }
    }
    __syncthreads();  // stage it & 1 is free for tile it + 2
  }

  // merge the two warpgroups' (m, l, acc) of each row through the free
  // ring: group 1 hands over, group 0 rescales both to the common max
  // (a group whose keys were all masked has m = NEG_INF and drops out)
  float* xch = reinterpret_cast<float*>(ring);
  const int slot = threadIdx.x & (tc::THREADS - 1);
  if (group == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xch[(4 * DN + h) * tc::THREADS + slot] = m_i[h];
      xch[(4 * DN + 2 + h) * tc::THREADS + slot] = l_i[h];
    }
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xch[(4 * n + i) * tc::THREADS + slot] = acc[n][i];
  }
  static_assert(NX * tc::THREADS * sizeof(float) <=
                    4 * sizeof(T) * tc::Tile<T, D>::ELEMS,
                "the merge fits in the ring");
  __syncthreads();
  if (group == 1) return;

  // finalize (`_finalize`): dead rows write zeros and lse = +1e30
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_b = xch[(4 * DN + h) * tc::THREADS + slot];
    const float l_b = xch[(4 * DN + 2 + h) * tc::THREADS + slot];
    const float m = fmaxf(m_i[h], m_b);
    const float ca = expf(m_i[h] - m), cb = expf(m_b - m);
    const float l = ca * l_i[h] + cb * l_b;
    const int row = rows[h];
    if (row >= S) continue;
    const bool dead = m <= NEG_INF * 0.5f;
    // O = (ca acc_a + cb acc_b) / l, the weights divided by l once a row;
    // dead rows write zeros
    const float ia = dead ? 0.f : ca / l, ib = dead ? 0.f : cb / l;
    T* orow = o + q_base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      tc::store2(orow + 8 * n,
                 ia * acc[n][2 * h] +
                     ib * xch[(4 * n + 2 * h) * tc::THREADS + slot],
                 ia * acc[n][2 * h + 1] +
                     ib * xch[(4 * n + 2 * h + 1) * tc::THREADS + slot]);
    if (t == 0) lse[(size_t)bh * S + row] = dead ? -NEG_INF : m + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seed, void* o, void* lse, int B, int H, int S, int Sk,
           float sm_scale, int causal, int dropout, float keep_div,
           uint32_t thresh, cudaStream_t stream) {
  if (!(tc::aligned16(q) && tc::aligned16(k) && tc::aligned16(v)))
    return kErrAlign;
  constexpr size_t smem = smem_bytes<T, D>();
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_fwd_kernel<T, D>), smem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_kernel<T, D><<<grid, FWD_THREADS, smem, stream>>>(
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
      return kErrHeadDim;
  }
#undef PADDLE_FA_CASE
}

}  // namespace

extern "C" {

// q, k, v: [B, H, S|Sk, D] contiguous and 16-byte aligned, f32
// (is_bf16 = 0) or bf16; bias: [B, Sk] f32 or null; seed: int32 [1] on the
// device, read only when dropout != 0; o: like q; lse: [B*H, S] f32.
// Launches on `stream` and returns the launch's cudaError_t (0 on
// success), or a negative code (paddle_cuda_error_string names it).
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
  return error_string(err);
}

}  // extern "C"
