// The f32 flash-attention dK/dV kernel for Hopper (sm_90a): split-TF32
// wgmma products on tiles that TMA loads. One kernel,
// flash_bwd_dkdv_f32_kernel; a plain C interface.
//
// Replaces, on every f32 training path (the f32 BERT pretraining step,
// AMP, the NaN guard, windows), the TPU kernel `_bwd_kv_kernel` (:344) of
// `_pallas_bwd` in paddle_tpu/ops/pallas/flash_attention.py (pallas_call
// :514), in place of flash_attention_bwd.cu's flash_bwd_kv_kernel (kept as
// the old route). The f32 backward route (ops/cuda/flash_attention.py,
// `bwd_route` "f32") takes delta = rowsum(dO * O) in torch, then this
// kernel, then flash_attention_bwd.cu's dQ kernel, which reads the same
// lse and delta. The function is the old kernel's:
//   P  = exp(scale * Q K^T + bias - lse)      (masked as in the forward)
//   dP = dO V^T,   P' = P * keep / (1 - rate), dP' = dP * keep / (1 - rate)
//   dS = P * (dP' - delta) * scale
//   dV = P'^T dO,  dK = dS^T Q
// with every sum in f32 and the rounding points of flash_attention_bwd.cu
// (:11-15: P' in dO's dtype, dS in the operands' dtype; both f32 here).
// The dropout mask is the forward's, regenerated from the same seed by
// keep_mask.cuh; a dead row (lse = +1e30) and a row past S give P = 0;
// keys past Sk are masked and not written. No atomics: the block that
// takes 64 keys owns their dK and dV, so reruns are bitwise. Every product
// is split TF32, lo*hi + hi*lo + hi*hi with f32 sums, as in tc_common.cuh.
//
// What bounds it on this card. At the train shape (B = 32, H = 12, S = Sk
// = 128, D = 64, f32, bias) it does 8 * S * Sk * D FLOP a (batch, head)
// (S^T, dP^T, dV, dK), 3.22 GFLOP, and moves Q, K, V, dO, lse, delta and
// the bias in and dK, dV out, 75.9 MB: 22.7 us of bytes at 3.35 TB/s
// against 19.5 us of products as three TF32 terms at 495 TFLOP/s
// (flash_attention_bwd.cu:26-33). The old kernel's mma.sync m16n8k8
// stream, three instructions a product with every warp re-splitting its
// fragments on every use, sets its time instead.
//
// What the design does about it.
// - wgmma m64nNk8 .tf32, three products a k step, key-major: S^T = K Q^T
//   and dP^T = V dO^T with both operands from shared memory (N = 32 query
//   rows), then dV += P'^T dO and dK += dS^T Q with P'^T and dS^T from the
//   registers the first two products left them in (N = the head dim). No
//   warp loads a B fragment.
// - Each operand is split into hi and lo once an item (K, V) or once a
//   stage (Q, dO), by one pass over shared memory after its TMA load
//   lands, never once a use. TF32's wgmma reads B only K-major: dV and dK
//   read dO and Q along their rows, so the same pass also writes dO^T and
//   Q^T, hi and lo, each query row at its tf32_slot (hopper_common.cuh),
//   where P'^T's and dS^T's accumulator registers read as A fragments
//   expect it. The splits round by integer operations (split_tf32:
//   cvt.rna's bits at a quarter of its cost), and each S^T and dP^T chain
//   starts with its accumulator's scale-d off: an instruction zeroing it
//   beside products in flight made ptxas serialize them (C7515).
// - A work item is 64 keys of one (batch, head). Two warpgroups share its
//   K and V and take alternate 32-row query stages, each through its own
//   ring slot with its own dK and dV, summed at the item's end in a fixed
//   order (no atomics): while one runs its elementwise pass and splits,
//   the other's products keep the tensor cores busy. A stage's next load
//   is issued as soon as its S^T and dP^T have read the slot's landing
//   buffers.
// - Persistent (PADDLE_F32_PERSISTENT): as many blocks as the card holds
//   at once, each looping over items; the next item's K and V land in
//   buffers of their own, and each warpgroup's first stage of it in its
//   slot, under this item's products. tools/f32_attention_ab.py times it
//   against one block an item, side by side.
// - lse and delta are read from device memory while the products they
//   follow run.
// - Causal: query stages whose last row precedes the item's first key
//   are cut by the loop bound.
//
// Layout, shared memory and occupancy. K and V are [64 keys][DP] as
// DP / 32 regions of [64][32] f32 (128-byte rows, 128-byte swizzle); a
// stage's Q and dO are [32][DP] as regions of [32][32], their transposes
// [DP][32 rows], one region. K and V hi and lo and the next K and V as
// they land, 6 x 16 KB, and a slot for each warpgroup of Q, dO, Q^T and
// dO^T hi and lo, 2 x 8 x 8 KB: 224 KB at DP = 64 (230,424 B with the
// barriers and the 1024-byte alignment), one block (eight warps) an SM;
// head dims 8, 16, 32 run the DP = 32 instance, 112 KB. 32-row stages
// keep S^T, dP^T and their split copies in 96 registers beside dK and
// dV's 64. ptxas's registers and spills: chip_smoke.py's [build] lines.
#include <cuda.h>
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
using tc::smem_u32;

constexpr int THREADS = 256;  // two warpgroups
constexpr int KEYS = 64;      // keys of a block
constexpr int BQ = 32;        // query rows of a stage
constexpr int KREGION = KEYS * 128;  // [64][32] f32: 8 KB
constexpr int QREGION = BQ * 128;    // [32][32] f32: 4 KB

constexpr int kErrShape = -4;

// 1: as many blocks as the card holds at once, each looping over work
// items (64-key tiles), the next item's K and V and its first query stages
// loaded under this one's products; 0: one block an item
// (tools/f32_attention_ab.py builds both and times them side by side)
#ifndef PADDLE_F32_PERSISTENT
#define PADDLE_F32_PERSISTENT 1
#endif

// Shared memory of a block, in bytes from a 1024-aligned base: K and V hi
// and lo, the next item's K and V as they land, then a ring slot for each
// warpgroup of (Q hi, Q lo, Q^T hi, Q^T lo, dO hi, dO lo, dO^T hi, dO^T
// lo), then three mbarriers (K and V; each slot's Q and dO).
template <int DP>
struct Smem {
  static constexpr int KT = DP / F32_COLS * KREGION;  // [64][DP]
  static constexpr int QT = DP / F32_COLS * QREGION;  // [32][DP]
  static constexpr int TT = DP * 128;                 // [DP][32]
  static constexpr int KH = 0, KL = KT, VH = 2 * KT, VL = 3 * KT;
  static constexpr int KLAND = 4 * KT, VLAND = 5 * KT;
  static constexpr int RING = 6 * KT;
  // offsets within a stage
  static constexpr int QH = 0, QL = QT, QTH = 2 * QT, QTL = 2 * QT + TT;
  static constexpr int OH = 2 * QT + 2 * TT, OL = 3 * QT + 2 * TT;
  static constexpr int OTH = 4 * QT + 2 * TT, OTL = 4 * QT + 3 * TT;
  static constexpr int STAGE = 4 * QT + 4 * TT;
  static constexpr int BAR = RING + 2 * STAGE;
  static constexpr int BYTES = BAR + 3 * 8 + 1024;  // + room to align
};

// A stage's Q (or dO) [32 rows][DP], landed at `st + hi`, split into hi
// (in place) and lo (`st + lo`), and its transpose [DP][32] into `st +
// th`, `st + tl`, row r at column tf32_slot(r), by one warpgroup. Lane =
// query row; warp w takes the 4-column chunks w DP / 16 .. + DP / 16 - 1:
// for each column the warp writes one 128-byte row of the transpose, every
// lane to its own bank.
template <int DP>
__device__ __forceinline__ void split_stage_tensor(unsigned char* st, int hi,
                                                   int lo, int th, int tl) {
  constexpr int CPW = DP / 16;  // chunks a warp
  const int warp = (threadIdx.x >> 5) & 3, r = threadIdx.x & 31;
  const int slot = tf32_slot(r);
#pragma unroll
  for (int cc = 0; cc < CPW; ++cc) {
    const int c = warp * CPW + cc;  // columns 4 c .. 4 c + 3
    const int off = (c / 8) * QREGION + swz_f32(r, 4 * (c & 7));
    float4 l4;
    const float4 h4 = split4(*reinterpret_cast<float4*>(st + hi + off), l4);
    *reinterpret_cast<float4*>(st + hi + off) = h4;
    *reinterpret_cast<float4*>(st + lo + off) = l4;
    const float hs[4] = {h4.x, h4.y, h4.z, h4.w};
    const float ls[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int to = swz_f32(4 * c + i, slot);
      *reinterpret_cast<float*>(st + th + to) = hs[i];
      *reinterpret_cast<float*>(st + tl + to) = ls[i];
    }
  }
}

// Work item x: (batch * head bh, 64-key tile); block b takes items b,
// b + gridDim.x, ... (PADDLE_F32_PERSISTENT: as many blocks as fit on the
// card at once; else one block an item). Warpgroup wg takes an item's
// query stages n = wg, wg + 2, ..., each through its own ring slot, and
// keeps its own dK and dV; the two are summed at the item's end. In an
// accumulator of m64nN a thread (warp w of its warpgroup, lane 4 g + t)
// holds d[4 j + 2 e2 + e] at row (key) 16 w + g + 8 e2, column 8 j + 2 t +
// e (a query row of the stage, or a column of dK and dV).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ bias,
                              const int* __restrict__ seed_ptr,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int H, int S, int Sk, int D, int n_kt,
                              int n_items, float sm_scale, int causal,
                              int dropout, float keep_div, uint32_t thresh) {
  using L = Smem<DP>;
  constexpr int NC = DP / F32_COLS;  // regions of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on such a line
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_kv = base + L::BAR;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warpgroup's ring slot and the mbarrier of its landings
  const uint32_t st = base + L::RING + wg * L::STAGE;
  unsigned char* const stp = smem + L::RING + wg * L::STAGE;
  const uint32_t bar_q = bar_kv + 8 + 8 * wg;

  // an item's first query stage (causal: query rows before its first key
  // add nothing, `k_start <= q_start + blk_q - 1`, :408-413) and its
  // stages (none where every row precedes the tile's keys)
  const int n_qs = (S + BQ - 1) / BQ;
  auto item_k0 = [&](int x) { return (x % n_kt) * KEYS; };
  auto item_first = [&](int x) { return causal ? item_k0(x) / BQ : 0; };
  auto item_stages = [&](int x) { return n_qs - item_first(x); };

  // Q and dO of stage n of item x into warpgroup w's slot (their hi
  // copies); K and V of item x into their landing buffers
  auto load_q = [&](int x, int n, int w) {
    const uint32_t dst = base + L::RING + w * L::STAGE;
    const uint32_t bar = bar_kv + 8 + 8 * w;
    const int row = (item_first(x) + n) * BQ;
    mbar_expect_tx(bar, 2 * L::QT);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(dst + L::QH + c * QREGION, &tm_q, c * F32_COLS, row,
               x / n_kt, bar);
      tma_load(dst + L::OH + c * QREGION, &tm_do, c * F32_COLS, row,
               x / n_kt, bar);
    }
  };
  auto load_kv = [&](int x) {
    mbar_expect_tx(bar_kv, 2 * L::KT);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(base + L::KLAND + c * KREGION, &tm_k, c * F32_COLS,
               item_k0(x), x / n_kt, bar_kv);
      tma_load(base + L::VLAND + c * KREGION, &tm_v, c * F32_COLS,
               item_k0(x), x / n_kt, bar_kv);
    }
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    mbar_init(bar_kv + 16, 1);
  }
  __syncthreads();  // the barriers are initialised
  if (tid == 0 && blockIdx.x < n_items) load_kv(blockIdx.x);

  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  uint32_t kv_phase = 0, q_phase = 0;
  int fetched = -1;  // the item whose first stage this slot holds or awaits

  for (int x = blockIdx.x; x < n_items; x += gridDim.x) {
    const int bh = x / n_kt, k0 = item_k0(x), b = bh / H;
    const int t_begin = item_first(x), n_st = item_stages(x);
    const int next = x + gridDim.x;  // this block's next item
    const size_t row_base = (size_t)bh * S;

    // this warpgroup's first stage of the item, unless the last item's
    // products already fetched it
    if (wtid == 0 && wg < n_st && fetched != x) load_q(x, wg, wg);
    __syncwarp();
    // K and V into their hi and lo copies: every warp's products of the
    // last item have retired (the barrier closing it); then the landing
    // buffers take the next item's
    mbar_wait(bar_kv, kv_phase);
    kv_phase ^= 1;
    split_rows<THREADS>(smem + L::KLAND, smem + L::KH, smem + L::KL, L::KT);
    split_rows<THREADS>(smem + L::VLAND, smem + L::VH, smem + L::VL, L::KT);
    fence_proxy_async();  // the copies visible to wgmma
    __syncthreads();
    if (tid == 0 && next < n_items) load_kv(next);
    __syncwarp();

    int keys[2];
    float bk[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      keys[e2] = k0 + 16 * warp + g + 8 * e2;
      bk[e2] = bias_at(bias, b, keys[e2], Sk);
    }
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    for (int n = wg; n < n_st; n += 2) {
      const int it = t_begin + n;
      // the slot's landing; its last products have retired in every warp
      // of the warpgroup (the wait at the end of the last stage)
      mbar_wait(bar_q, q_phase);
      q_phase ^= 1;
      named_barrier(1 + wg, 128);
      split_stage_tensor<DP>(stp, L::QH, L::QL, L::QTH, L::QTL);
      split_stage_tensor<DP>(stp, L::OH, L::OL, L::OTH, L::OTL);
      fence_proxy_async();  // the copies visible to wgmma
      named_barrier(1 + wg, 128);

      // S^T = K Q^T and dP^T = V dO^T: the item's 64 keys by 32 rows
      float sa[16], dpa[16];
      wg_fence();
      wgmma_tf32_split_ss<BQ, DP>(sa, base + L::KH, base + L::KL, KREGION,
                                  st + L::QH, st + L::QL, QREGION);
      wgmma_tf32_split_ss<BQ, DP>(dpa, base + L::VH, base + L::VL, KREGION,
                                  st + L::OH, st + L::OL, QREGION);
      wg_commit();

      // lse and delta of this thread's eight query rows, under the
      // products
      float lse_r[8], delta_r[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int row = it * BQ + 8 * (c >> 1) + 2 * t + (c & 1);
        lse_r[c] = row < S ? lse[row_base + row] : 0.f;
        delta_r[c] = row < S ? delta[row_base + row] : 0.f;
      }

      wg_wait<0>();
      fence_acc(sa);
      fence_acc(dpa);
      // every warp's S^T and dP^T have read the landing buffers: refill
      // them with this warpgroup's next stage, of this item or the next
      named_barrier(1 + wg, 128);
      if (wtid == 0) {
        if (n + 2 < n_st) {
          load_q(x, n + 2, wg);
        } else if (next < n_items && wg < item_stages(next)) {
          load_q(next, wg, wg);
          fetched = next;
        }
      }
      __syncwarp();  // warp 0 whole again before its next wgmma

      // element (key, query row): P'^T and dS^T, split into the A
      // fragments of dV += P'^T dO and dK += dS^T Q
      uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * j + e;
          const int row = it * BQ + 8 * j + 2 * t + e;
          const bool valid = row < S;  // ragged S: P = 0 and dS = 0
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int xx = 4 * j + 2 * e2 + e;
            const float xs = masked_score(sa[xx], sm_scale, bk[e2], row,
                                          keys[e2], Sk, causal);
            const float p = valid ? __expf(xs - lse_r[c]) : 0.f;
            float pe = p, dpv = dpa[xx];
            if (dropout) {
              const bool kp = keep(seed, (uint32_t)bh, (uint32_t)row,
                                   (uint32_t)keys[e2], thresh);
              pe = kp ? p * keep_scale : 0.f;
              dpv = kp ? dpv * keep_scale : 0.f;
            }
            split_tf32(pe, ph[xx], pl[xx]);
            split_tf32(valid ? p * (dpv - delta_r[c]) * sm_scale : 0.f,
                       dh[xx], dl[xx]);
          }
        }

      fence_acc(dv_acc);
      fence_acc(dk_acc);
      wg_fence();
      wgmma_tf32_split_rs<DP, BQ>(dv_acc, ph, pl, st + L::OTH, st + L::OTL,
                                  L::TT);
      wgmma_tf32_split_rs<DP, BQ>(dk_acc, dh, dl, st + L::QTH, st + L::QTL,
                                  L::TT);
      wg_commit();
      wg_wait<0>();  // the slot's copies are free for the next split
      fence_acc(dv_acc);
      fence_acc(dk_acc);
    }

    // warpgroup 1 hands its dK and dV over through its slot's split
    // copies (Q lo and Q^T, dO lo and dO^T: no load lands there), warpgroup
    // 0 adds them to its own (a fixed order: reruns are bitwise) and
    // stores both for its two keys (none past Sk, no column past D)
    float* xk = reinterpret_cast<float*>(smem + L::RING + L::STAGE + L::QL);
    float* xv = reinterpret_cast<float*>(smem + L::RING + L::STAGE + L::OL);
    static_assert(DP / 2 * 128 * sizeof(float) <= (size_t)(L::QT + L::TT),
                  "the hand-over fits in a slot's split copies");
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) {
        xk[i * 128 + wtid] = dk_acc[i];
        xv[i * 128 + wtid] = dv_acc[i];
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) {
        dk_acc[i] += xk[i * 128 + wtid];
        dv_acc[i] += xv[i * 128 + wtid];
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int key = keys[e2];
        if (key >= Sk) continue;
        const size_t r0 = ((size_t)bh * Sk + key) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col >= D) continue;
          tc::store2(dk + r0 + col, dk_acc[4 * j + 2 * e2],
                     dk_acc[4 * j + 2 * e2 + 1]);
          tc::store2(dv + r0 + col, dv_acc[4 * j + 2 * e2],
                     dv_acc[4 * j + 2 * e2 + 1]);
        }
      }
    }
    // the hand-over is read before warpgroup 1's next split, which
    // follows the next item's K and V split and its barrier
  }
}

// ---- host side -------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta, *bias, *seed;
  void *dk, *dv;
  int B, H, S, Sk, D;
  float sm_scale;
  int causal, dropout;
  float keep_div;
  uint32_t thresh;
};

template <int DP>
int launch(const BwdArgs& a, cudaStream_t stream) {
  const int BH = a.B * a.H;
  const int n_kt = (a.Sk + KEYS - 1) / KEYS;
  CUtensorMap mq, mk, mv, mdo;
  if (!(tensor_map_f32(&mq, a.q, BH, a.S, a.D, BQ) &&
        tensor_map_f32(&mk, a.k, BH, a.Sk, a.D, KEYS) &&
        tensor_map_f32(&mv, a.v, BH, a.Sk, a.D, KEYS) &&
        tensor_map_f32(&mdo, a.dout, BH, a.S, a.D, BQ)))
    return kErrTensorMap;
  constexpr size_t smem = Smem<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const void* kernel =
      reinterpret_cast<const void*>(flash_bwd_dkdv_f32_kernel<DP>);
  cudaError_t err = ensure_smem_attr(kernel, smem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)BH * n_kt;
  int grid = (int)items;
#if PADDLE_F32_PERSISTENT
  static int resident[kMaxDevices] = {};
  err = resident_blocks(kernel, THREADS, smem, resident);
  if (err != cudaSuccess) return (int)err;
  if (items > resident[current_device()])
    grid = resident[current_device()];
#endif
  flash_bwd_dkdv_f32_kernel<DP><<<(unsigned)grid, THREADS, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.bias),
      static_cast<const int*>(a.seed), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.H, a.S, a.Sk, a.D, n_kt, (int)items,
      a.sm_scale, a.causal, a.dropout, a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dout: [B, H, S, D]; k, v: [B, H, Sk, D]; all contiguous f32 (is_bf16
// = 0), 16-byte aligned, S >= 1, Sk >= 1, D one of 8, 16, 32, 64. lse,
// delta: [B*H, S] f32; bias: [B, Sk] f32 or null; seed: int32 [1] on the
// device, read only when dropout != 0; dk, dv: like k. Launches one kernel
// on `stream` and returns the launch's cudaError_t (0 on success), or a
// negative code (paddle_cuda_error_string names it).
int paddle_flash_attention_bwd_dkdv_f32(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        const void* bias, const void* seed,
                                        void* dk, void* dv, int B, int H,
                                        int S, int Sk, int D, int is_bf16,
                                        float sm_scale, int causal,
                                        int dropout, float keep_div,
                                        unsigned int thresh, void* stream) {
  if (is_bf16 || S < 1 || Sk < 1) return kErrShape;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
    return kErrAlign;
  const BwdArgs a{q, k, v, dout, lse, delta, bias, seed, dk, dv, B, H, S,
                  Sk, D, sm_scale, causal, dropout, keep_div, thresh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8:
    case 16:
    case 32:
      return launch<32>(a, st);
    case 64:
      return launch<64>(a, st);
    default:
      return kErrHeadDim;
  }
}

const char* paddle_cuda_error_string(int err) {
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled is not available or refused a tensor map";
  if (err == kErrShape)
    return "the f32 dK/dV kernel takes f32 with S, Sk >= 1";
  return error_string(err);
}

}  // extern "C"
