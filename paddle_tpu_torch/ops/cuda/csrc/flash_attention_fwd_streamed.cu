// The bf16 flash-attention forward for Hopper (sm_90a) where S or Sk is
// above 128, so that one block cannot hold a (batch, head) whole: the keys
// stream through shared memory. One kernel, flash_fwd_streamed_kernel; a
// plain C interface.
//
// Replaces, on this path, the TPU kernel `_fwd_kernel` / `_pallas_fwd` in
// paddle_tpu/ops/pallas/flash_attention.py (:219, :298; pallas_call :318).
// bf16 with S, Sk <= 128 runs the whole-block forward
// (flash_attention_fwd_whole.cu); f32 keeps the tiled kernel of
// flash_attention_fwd.cu (ops/cuda/flash_attention.py: `fwd_route`, which
// asks the predicate `bwd_route` asks, so the forward and the backward
// agree on the route). The function is theirs:
//   O   = softmax(scale * Q K^T + bias, masked) V       (dropout on V only)
//   lse = m + log(l) per query row
// with the key-padding bias clamped at NEG_INF, top-left causal masking
// and ragged S / Sk (flash_common.cuh's masked_score), the counter-hash
// dropout mask of keep_mask.cuh bit for bit (l sums the full
// probabilities; dropout scales only what enters P V), P rounded to bf16
// before P V, every sum in f32, and the dead-row rule of `_finalize`
// (:282): a row whose max stays at NEG_INF writes O = 0 and lse = +1e30.
// lse is [B*H, S] f32, the layout the backward kernels read.
//
// What bounds it on this card. Per (batch, head) the function reads Q, K
// and V and writes O (4 x S x D bf16 at S = Sk) and lse, against
// 4 * S * Sk * D FLOP: at S = Sk = 512, D = 64, 256 KB against 67 MFLOP,
// 256 FLOP a byte, just under the 295 at which the bf16 tensor cores
// bind. So at the S = 512 bert lane's shape (B = 64, H = 12, no bias) it
// is bound by its products: 51.5 GFLOP, 0.052 ms at 989 TFLOP/s, against
// 0.048 ms of bytes; at S = Sk = 256 by bytes. The tiled kernel it
// replaces runs mma.sync on 64-row tiles with every fragment loaded from
// shared memory by each warp, and reads K and V once per 64 query rows.
//
// What the design does about it.
// - One block a (batch, head, 128 query rows), one linear grid: K and V
//   are read once per 128 query rows. The two warpgroups take 64 rows
//   each and share every K and V tile.
// - K and V stream in 128-key tiles by TMA (cp.async.bulk.tensor) into a
//   two-stage ring of 128-byte-swizzled [128][64] regions
//   (hopper_common.cuh). Each stage has an mbarrier for K's arrival, one
//   for V's, and one for each's release that all 256 threads arrive on
//   once their last product reading it has retired; thread 0 then refills
//   it (K with tile t + 2 once S of tile t has landed, V with tile t + 1
//   once P V of tile t - 1 has), so each copy has about a tile's work to
//   arrive in. Rows past Sk and columns past D are zero-filled by the
//   copy. Q arrives with the first K tile.
// - A warpgroup takes a tile's keys 64 at a time, software-pipelined:
//   S = Q K^T of the next 64 keys (a wgmma m64n64k16 chain, both operands
//   K-major in shared memory) and P V of the previous 64 are in flight
//   while this 64's softmax runs in registers. O += P V is wgmma with A
//   from registers (P packed to bf16 in the accumulator's own layout) and
//   V read MN-major through the descriptor's transpose bit.
// - The softmax is online across the 64-key units, in log2 units: a
//   running max m of the scores times log2 e and a running sum in f32, O
//   rescaled by 2^(m_old - m_new) before each P V, P = 2^(s c - m) one
//   multiply-add and one ex2 an element. A unit no mask reaches (no bias,
//   every key below Sk, under causal masking every key at or below the
//   warpgroup's first row) skips masked_score; the others take it as
//   every flash kernel does. Each thread keeps its part of l and reduces
//   it across the quad once, at the end. Causal key tiles wholly above
//   the diagonal are not loaded.
// - O leaves through shared memory by TMA, over the warpgroup's own rows
//   of Q (dead after its last Q K^T), as in the whole-block forward; lse
//   goes straight out, converted back to natural log.
// - Occupancy: at D = 64, Q 16 KB and the ring 2 x (16 + 16) KB, 81 KB a
//   block, so two blocks (16 warps) an SM if ptxas keeps the registers
//   under 128 (chip_smoke.py's [build] line). At D = 128, 161 KB, one
//   block an SM. Head dims below 128 are padded by the wrapper to the next
//   of 8, 16, 32, 64 (the 64-column instance) and 128.
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

constexpr int THREADS = 256;  // two warpgroups of 64 query rows
constexpr int WG_ROWS = 64;   // query rows of a warpgroup: its O box

// negative return code besides flash_common.cuh's and hopper_common.cuh's
constexpr int kErrShape = -4;

// Shared memory of a block, in bytes from a 1024-aligned base: Q [128][DP]
// (O written over it at the end), then the ring: stage s holds K at
// KV + 2 s T and V at KV + (2 s + 1) T; then the mbarriers: K and V of
// each stage arrived, K and V of each stage released.
template <int DP>
struct Smem {
  static constexpr int T = DP / COLS * REGION;  // one tile
  static constexpr int Q = 0, KV = T;
  static constexpr int BAR = 5 * T;
  static constexpr int BYTES = BAR + 8 * 8 + 1024;  // + room to align
};

// Block x: (batch * head bh, 128-row query tile). Warpgroup wg owns query
// rows 64 wg .. 64 wg + 63 of the tile and takes the keys 64 at a time (a
// unit: half a stage). In an accumulator of m64n64 a thread (warp w of its
// group, lane 4 g + t) holds d[4 j + 2 e2 + e] at row 16 w + g + 8 e2,
// column 8 j + 2 t + e.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
    flash_fwd_streamed_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_o,
                              const float* __restrict__ bias,
                              const int* __restrict__ seed_ptr,
                              float* __restrict__ lse, int H, int S, int Sk,
                              int n_qt, float sm_scale, int causal,
                              int dropout, float keep_div, uint32_t thresh) {
  using L = Smem<DP>;
  constexpr int NC = DP / COLS;  // 64-column regions of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on such a line
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_k = base + L::BAR;   // + 8 s: K of stage s arrived
  const uint32_t bar_v = bar_k + 16;      // + 8 s: V of stage s arrived
  const uint32_t free_k = bar_k + 32;     // + 8 s: K of stage s released
  const uint32_t free_v = bar_k + 48;     // + 8 s: V of stage s released

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qt;
  // the heaviest causal tiles (the last rows) first
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int q0 = qt * ROWS;
  const int b = bh / H;

  // key tiles: all of Sk, or under causal masking up to the one that
  // holds the tile's last row
  int n_kt = (Sk + ROWS - 1) / ROWS;
  if (causal) n_kt = min(n_kt, (min(q0 + ROWS, S) - 1) / ROWS + 1);

  // K (with Q for the first) and V of key tile i into stage i & 1
  auto load_k = [&](int i) {
    const int s = i & 1;
    mbar_expect_tx(bar_k + 8 * s, (i == 0 ? 2 : 1) * NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (i == 0)
        tma_load(base + L::Q + c * REGION, &tm_q, c * COLS, q0, bh, bar_k);
      tma_load(base + L::KV + 2 * s * L::T + c * REGION, &tm_k, c * COLS,
               i * ROWS, bh, bar_k + 8 * s);
    }
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
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(free_k + 8 * s, THREADS);
      mbar_init(free_v + 8 * s, THREADS);
    }
    load_k(0);
    load_v(0);
    if (n_kt > 1) {
      load_k(1);
      load_v(1);
    }
  }
  __syncthreads();  // the barriers are initialised

  int rows[2];  // this thread's two query rows, absolute
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2)
    rows[e2] = q0 + WG_ROWS * wg + 16 * warp + g + 8 * e2;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  // the softmax runs in log2 units: m is the running max of the scores
  // times log2 e, and P = 2^(s c2 - m) one multiply-add and one ex2
  const float c2 = sm_scale * LOG2E;
  const uint32_t qa = base + L::Q + WG_ROWS * wg * 128;  // the WG's Q rows

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[c][x] = 0.f;
    fence_acc(acc[c]);
  }

  // A software pipeline over units u = 2 i + h (keys 128 i + 64 h ..
  // + 63): while unit u's softmax runs, S of unit u + 1 and P V of unit
  // u - 1 are in flight. Committed groups, oldest first, when unit u
  // starts: S(u), PV(u - 1); an empty group stands for PV(-1) and for
  // S(past the end), so the waits below count alike in every unit.
  float sc[2][32];
  mbar_wait(bar_k, 0);
  wgmma_abt<DP>(sc[0], qa, base + L::KV);
  wg_commit();
  for (int i = 0; i < n_kt; ++i) {
    const int s = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    const uint32_t kd = base + L::KV + 2 * s * L::T, vd = kd + L::T;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = i * ROWS + 64 * h;
      // S of the next unit
      if (h == 0) {
        wgmma_abt<DP>(sc[1], qa, kd + 64 * 128);
      } else if (i + 1 < n_kt) {
        const int s1 = (i + 1) & 1;
        mbar_wait(bar_k + 8 * s1, ((i + 1) >> 1) & 1);
        wgmma_abt<DP>(sc[0], qa, base + L::KV + 2 * s1 * L::T);
      } else {
        wg_commit();
      }
      wg_wait<2>();  // S(u) has landed
      fence_acc(sc[h]);
      if (h == 1) {
        // both units of the stage have read its K: release it, refill
        // it with tile i + 2 once every thread has
        mbar_arrive(free_k + 8 * s);
        if (tid == 0 && i + 2 < n_kt) {
          mbar_wait(free_k + 8 * s, ph);
          load_k(i + 2);
        }
        __syncwarp();  // warp 0 whole again before its next wgmma
      }

      // the scores in log2 units and the unit's row max: a unit that no
      // mask reaches (no bias, every key below Sk and, under causal
      // masking, below the warpgroup's first row) skips the masks
      const bool plain = bias == nullptr && k0 + 64 <= Sk && sm_scale > 0.f &&
                         !(causal && k0 + 63 > q0 + WG_ROWS * wg);
      float mx[2] = {NEG_INF, NEG_INF};
      if (plain) {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[h][x]);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) mx[e2] *= c2;
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
              sc[h][x] = masked_score(sc[h][x], sm_scale, bk, rows[e2], key,
                                      Sk, causal) *
                         LOG2E;
              mx[e2] = fmaxf(mx[e2], sc[h][x]);
            }
          }
      }
      float alpha[2], mneg[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        mx[e2] = fmaxf(mx[e2], __shfl_xor_sync(0xffffffffu, mx[e2], 1));
        mx[e2] = fmaxf(mx[e2], __shfl_xor_sync(0xffffffffu, mx[e2], 2));
        const float mn = fmaxf(m[e2], mx[e2]);
        alpha[e2] = exp2_approx(m[e2] - mn);
        m[e2] = mn;
        mneg[e2] = -mn;
        l[e2] *= alpha[e2];
      }

      // P = 2^(x - m): l sums the full probabilities; the dropped-out and
      // rescaled values are packed to bf16 as the A operand of P V
      uint32_t p[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float pe[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sx = sc[h][4 * j + 2 * e2 + e];
            float x = exp2_approx(plain ? __fmaf_rn(sx, c2, mneg[e2])
                                        : sx + mneg[e2]);
            l[e2] += x;
            if (dropout)
              x = keep(seed, (uint32_t)bh, (uint32_t)rows[e2],
                       (uint32_t)(k0 + 8 * j + 2 * t + e), thresh)
                      ? x * keep_scale
                      : 0.f;
            pe[e] = x;
          }
          p[2 * j + e2] = pack(pe[0], pe[1]);
        }

      wg_wait<1>();  // P V of the previous unit has landed
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
      if (h == 0 && i > 0) {
        // both units of the previous stage have read its V: release it,
        // refill it with tile i + 1 once every thread has
        const int sp = (i - 1) & 1;
        mbar_arrive(free_v + 8 * sp);
        if (tid == 0 && i + 1 < n_kt) {
          mbar_wait(free_v + 8 * sp, ((i - 1) >> 1) & 1);
          load_v(i + 1);
        }
        __syncwarp();
      }

      // O = alpha O + P V: A from registers, V read MN-major (its rows are
      // the keys)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[c][x] *= alpha[(x >> 1) & 1];
        fence_acc(acc[c]);
      }
      if (h == 0) mbar_wait(bar_v + 8 * s, ph);
      wg_fence();
      wgmma_rab<NC>(acc, p, vd + 64 * h * 128);
      wg_commit();
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(acc[c]);

  // finalize (`_finalize`): O / l in bf16 over the warpgroup's rows of Q,
  // lse to device memory; dead rows write zeros and lse = +1e30
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 1);
    l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 2);
    const bool dead = m[e2] <= NEG_INF * 0.5f;
    const float inv = 1.f / l[e2];
    const int r = rows[e2] - q0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = 4 * j + 2 * e2;
        *reinterpret_cast<uint32_t*>(smem + L::Q + c * REGION +
                                     swz(r, j, t)) =
            pack(dead ? 0.f : acc[c][x] * inv,
                 dead ? 0.f : acc[c][x + 1] * inv);
      }
    if (t == 0 && rows[e2] < S)
      lse[(size_t)bh * S + rows[e2]] =
          dead ? -NEG_INF : (m[e2] + __log2f(l[e2])) * LN2;
  }
  fence_proxy_async();  // O visible to the TMA store
  named_barrier(1 + wg, 128);
  if ((tid & 127) == 0 && q0 + WG_ROWS * wg < S) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_store(&tm_o, base + L::Q + c * REGION + WG_ROWS * wg * 128,
                c * COLS, q0 + WG_ROWS * wg, bh);
    tma_store_wait_read();
  }
}

// ---- host side -------------------------------------------------------------

struct FwdArgs {
  const void *q, *k, *v, *bias, *seed;
  void *o, *lse;
  int B, H, S, Sk, D;
  float sm_scale;
  int causal, dropout;
  float keep_div;
  uint32_t thresh;
};

template <int DP>
int launch(const FwdArgs& a, cudaStream_t stream) {
  const int BH = a.B * a.H;
  const int n_qt = (a.S + ROWS - 1) / ROWS;
  CUtensorMap mq, mk, mv, mo;
  if (!(tensor_map(&mq, a.q, BH, a.S, a.D) &&
        tensor_map(&mk, a.k, BH, a.Sk, a.D) &&
        tensor_map(&mv, a.v, BH, a.Sk, a.D) &&
        tensor_map(&mo, a.o, BH, a.S, a.D, WG_ROWS)))
    return kErrTensorMap;
  constexpr size_t smem = Smem<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_fwd_streamed_kernel<DP>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_streamed_kernel<DP>
      <<<(unsigned)((size_t)BH * n_qt), THREADS, smem, stream>>>(
          mq, mk, mv, mo, static_cast<const float*>(a.bias),
          static_cast<const int*>(a.seed), static_cast<float*>(a.lse), a.H,
          a.S, a.Sk, n_qt, a.sm_scale, a.causal, a.dropout, a.keep_div,
          a.thresh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: [B, H, S, D]; k, v: [B, H, Sk, D]; all contiguous bf16 (is_bf16 =
// 1), 16-byte aligned, S >= 1, Sk >= 1, D one of 8, 16, 32, 64, 128. bias:
// [B, Sk] f32 or null; seed: int32 [1] on the device, read only when
// dropout != 0; lse: [B*H, S] f32. Launches one kernel on `stream` and
// returns the launch's cudaError_t (0 on success), or a negative code
// (paddle_cuda_error_string names it).
int paddle_flash_attention_fwd_streamed(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        const void* seed, void* o, void* lse,
                                        int B, int H, int S, int Sk, int D,
                                        int is_bf16, float sm_scale,
                                        int causal, int dropout,
                                        float keep_div, unsigned int thresh,
                                        void* stream) {
  if (!is_bf16 || S < 1 || Sk < 1) return kErrShape;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return kErrAlign;
  const FwdArgs a{q, k, v, bias, seed, o, lse, B, H, S, Sk, D, sm_scale,
                  causal, dropout, keep_div, thresh};
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
    return "the streamed forward takes bf16 with S, Sk >= 1";
  return error_string(err);
}

}  // extern "C"
