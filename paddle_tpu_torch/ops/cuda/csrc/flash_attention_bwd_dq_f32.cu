// The f32 flash-attention dQ kernel for Hopper (sm_90a), with delta =
// rowsum(dO * O) taken inside: split-TF32 wgmma products on tiles that
// TMA loads. One kernel, flash_bwd_dq_f32_kernel; a plain C interface.
//
// Replaces, on every f32 training path (the f32 BERT pretraining step,
// AMP, the NaN guard, windows), the TPU kernel `_bwd_q_kernel` (:421) of
// `_pallas_bwd` in paddle_tpu/ops/pallas/flash_attention.py (pallas_call
// :543) and its delta prologue (:492), in place of flash_attention_bwd.cu's
// flash_bwd_q_kernel and the torch passes of `bwd_delta` (kept as the old
// route). The f32 backward route (ops/cuda/flash_attention.py, `bwd_route`
// "f32") runs this kernel, then flash_attention_bwd_dkdv_f32.cu, which
// reads the delta written here. The function is the old pair's:
//   delta = rowsum(dO * O)                          (once a query row)
//   P   = exp(scale * Q K^T + bias - lse)           (masked as in the forward)
//   dP' = (dO V^T) * keep / (1 - rate)
//   dS  = P * (dP' - delta) * scale,   dQ = dS K
// with every sum in f32 and dS rounded to the operands' dtype (:465; f32
// here). The dropout mask is the forward's, regenerated from the same seed
// by keep_mask.cuh; a dead row (lse = +1e30) and a row past S give P = 0;
// keys past Sk are masked. It writes dQ [B, H, S, D] and delta [B*H, S]
// f32. No atomics: each element of dQ and delta is written once, by one
// thread, from sums in a fixed order, so reruns are bitwise. Every product
// is split TF32, lo*hi + hi*lo + hi*hi with f32 sums, as in tc_common.cuh.
//
// What bounds it on this card. At the train shape (B = 32, H = 12, S = Sk
// = 128, D = 64, f32, bias) it does 6 * S * Sk * D FLOP a (batch, head)
// (S, dP, dQ), 2.42 GFLOP, and moves Q, K, V, O, dO, lse and the bias in
// and dQ and delta out, 75.9 MB: 22.7 us of bytes at 3.35 TB/s against
// 14.6 us of products as three TF32 terms at 495 TFLOP/s. The old pair ran
// the products as mma.sync m16n8k8 streams, every warp re-splitting its
// fragments on every use, after torch passes that read O and dO once more.
//
// What the design does about it.
// - wgmma m64nNk8 .tf32, three products a k step: S = Q K^T and dP = dO V^T
//   with both operands from shared memory (64 query rows by N = 32 keys),
//   then dQ += dS K with dS from the registers the first two products left
//   it in (N = the head dim). No warp loads a B fragment.
// - Delta in one pass over O and dO in shared memory, written to device
//   memory and to shared memory; the pass also splits dO.
// - Each operand is split into hi and lo once an item (Q, dO) or once a
//   stage (K, V), by one pass over shared memory after its TMA load lands,
//   never once a use. TF32's wgmma reads B only K-major: dQ reads K along
//   its rows, so the pass that splits K also writes K^T, hi and lo, each key
//   at its tf32_slot (hopper_common.cuh), where dS's accumulator registers
//   read as A fragments expect it. V needs no transpose: dO V^T reads V
//   K-major as stored. The splits round by integer operations (split_tf32),
//   and each S and dP chain starts with its accumulator's scale-d off: an
//   instruction zeroing it beside products in flight made ptxas serialize
//   them (C7515).
// - Two layouts, one source (PADDLE_DQ_SHARED_ROWS):
//   0 (a warpgroup an item half, the default): a work item is 128 query
//     rows of one (batch, head); each warpgroup takes 64 of them and every
//     key stage, through its own ring slot, with no barrier between the
//     two, so one's elementwise pass and splits run under the other's
//     products: Q, dO and O land in place (O in Q's lo buffer, free until
//     the split), the next item's as soon as the last stage's S and dP have
//     read them.
//   1 (shared rows): a work item is 64 query rows. The two warpgroups
//     share its Q, dO and delta and take alternate 32-key stages, each
//     through its own ring slot with its own dQ, summed at the item's end
//     in a fixed order; the next item's Q, dO and O land in buffers of
//     their own under this item's products.
//   tools/f32_attention_ab.py builds both and times them side by side: at
//   the f32 train step's shape (B = 32, H = 12, S = Sk = 128, D = 64, bias,
//   dropout 0.1) the default took 0.0693 ms against 0.0712 (medians of 4
//   turns, NVIDIA H100 80GB HBM3, 700 W; at B = 8 0.0226 against 0.0232;
//   at B = 32 without dropout 0.0705 against 0.0689), so the layout that
//   joins its warpgroups at no barrier is kept.
// - Persistent (PADDLE_F32_PERSISTENT): as many blocks as the card holds at
//   once, each looping over items; each warpgroup's first key stage of the
//   next item lands in its slot under this item's last products.
// - lse is read from device memory once an item, under the splits.
// - Causal: key stages past the item's last row are cut by the loop bound
//   (:468-473), and the heaviest items of a (batch, head) go first.
//
// Layout, shared memory and occupancy. A 64-row tile (Q, dO, O) is [64][DP]
// as DP / 32 regions of [64][32] f32 (8 KB, one TMA box, 128-byte rows with
// the 128-byte swizzle); a stage's K and V are [32][DP] as regions of
// [32][32], K^T [DP][32 keys], one region. A warpgroup an item half (the
// default): for each warpgroup Q and dO hi and lo, 4 x 16 KB at DP = 64,
// and a slot of K, V and K^T hi and lo, 6 x 8 KB: 224 KB (230,944 B with
// each warpgroup's delta, the barriers and the 1024-byte alignment), one
// block (eight warps) an SM; head dims 8, 16, 32 run the DP = 32 instance,
// 112 KB. Shared rows: Q and dO hi and lo and the next item's Q, dO and O
// as they land, 7 x 16 KB, and a slot for each warpgroup, 2 x 48 KB:
// 214,304 B. 32-key stages keep S, dP and dS's split copies in 64
// registers beside dQ's 32. ptxas's registers and spills: chip_smoke.py's
// [build] lines.
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
constexpr int ROWS = 64;      // query rows of a warpgroup's products
constexpr int KS = 32;        // keys of a stage
constexpr int QREGION = ROWS * 128;  // [64][32] f32: 8 KB
constexpr int KREGION = KS * 128;    // [32][32] f32: 4 KB

constexpr int kErrShape = -4;

// 1: as many blocks as the card holds at once, each looping over work
// items, each warpgroup's first stage of the next item loaded under this
// one's products; 0: one block an item (tools/f32_attention_ab.py builds
// both and times them side by side)
#ifndef PADDLE_F32_PERSISTENT
#define PADDLE_F32_PERSISTENT 1
#endif

// 0: an item is 128 rows, 64 a warpgroup, each on every stage; 1: an item
// is 64 query rows, both warpgroups on its alternate key stages
#ifndef PADDLE_DQ_SHARED_ROWS
#define PADDLE_DQ_SHARED_ROWS 0
#endif
constexpr bool SHARED = PADDLE_DQ_SHARED_ROWS != 0;
constexpr int ITEM_ROWS = SHARED ? ROWS : 2 * ROWS;

// Shared memory of a block, in bytes from a 1024-aligned base. A ring slot
// holds (K hi, V hi, K lo, V lo, K^T hi, K^T lo); K lands in K hi and V in
// V hi. Shared rows: Q hi, Q lo, dO hi, dO lo, the next Q, dO and O as they
// land, a slot for each warpgroup, delta [64]. A warpgroup an item half:
// for each warpgroup Q hi (Q lands here), Q lo (O lands here), dO hi (dO
// lands here), dO lo and its slot, then each warpgroup's delta [64]. Then
// four mbarriers (each warpgroup's rows, each warpgroup's slot; shared
// rows use the first of the rows' two).
template <int DP>
struct Smem {
  static constexpr int QT = DP / F32_COLS * QREGION;  // [64][DP]
  static constexpr int KT = DP / F32_COLS * KREGION;  // [32][DP]
  static constexpr int TT = DP * 128;                 // [DP][32]
  // offsets within a slot (K lo and V lo side by side: the hand-over)
  static constexpr int KH = 0, VH = KT, KL = 2 * KT, VL = 3 * KT;
  static constexpr int KTH = 4 * KT, KTL = 4 * KT + TT;
  static constexpr int STAGE = 4 * KT + 2 * TT;
  // offsets within a set of rows
  static constexpr int QH = 0, QL = QT, DOH = 2 * QT, DOL = 3 * QT;
  static constexpr int QLAND = 4 * QT, DOLAND = 5 * QT, OLAND = 6 * QT;
  // the block's rows (shared) or a warpgroup's (an item half), then its
  // slot; every tile on a 1024-byte line (the swizzle's period)
  static constexpr int ROWSET = SHARED ? 7 * QT : 4 * QT;
  static constexpr int WG = SHARED ? 0 : ROWSET + STAGE;
  static constexpr int DELTA = SHARED ? ROWSET + 2 * STAGE : 2 * WG;
  static constexpr int BAR = DELTA + (SHARED ? 1 : 2) * ROWS * 4;
  static constexpr int BYTES = BAR + 4 * 8 + 1024;  // + room to align

  // warpgroup w's rows, slot and delta
  __device__ static constexpr int rows(int w) { return w * WG; }
  __device__ static constexpr int slot(int w) {
    return SHARED ? ROWSET + w * STAGE : w * WG + ROWSET;
  }
  __device__ static constexpr int delta(int w) {
    return DELTA + (SHARED ? 0 : w * ROWS * 4);
  }
};

// A stage's K [32 keys][DP], landed at `st + hi`, split into hi (in place)
// and lo (`st + lo`), and its transpose [DP][32] into `st + th`, `st + tl`,
// key r at column tf32_slot(r), by one warpgroup. Lane = key; warp w takes
// the 4-column chunks w DP / 16 .. + DP / 16 - 1: for each column the warp
// writes one 128-byte row of the transpose, every lane to its own bank.
template <int DP>
__device__ __forceinline__ void split_stage_k(unsigned char* st, int hi,
                                              int lo, int th, int tl) {
  constexpr int CPW = DP / 16;  // chunks a warp
  const int warp = (threadIdx.x >> 5) & 3, r = threadIdx.x & 31;
  const int slot = tf32_slot(r);
#pragma unroll
  for (int cc = 0; cc < CPW; ++cc) {
    const int c = warp * CPW + cc;  // columns 4 c .. 4 c + 3
    const int off = (c / 8) * KREGION + swz_f32(r, 4 * (c & 7));
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

// `bytes` of f32 at `hi` split into hi (in place) and lo (at `lo`), one
// layout, over the 128 threads of this thread's warpgroup
__device__ __forceinline__ void split_wg(unsigned char* hi, unsigned char* lo,
                                         int bytes) {
  for (int c = threadIdx.x & 127; c < bytes / 16; c += 128) {
    float4 l;
    const float4 h = split4(reinterpret_cast<const float4*>(hi)[c], l);
    reinterpret_cast<float4*>(hi)[c] = h;
    reinterpret_cast<float4*>(lo)[c] = l;
  }
}

// delta = rowsum(dO * O) of a 64-row tile, by NT threads (NT / 64 a row,
// `idx` this thread's index among them): O at `o`, dO at `d`, both [64][DP]
// in 32-column regions; dO is split on the way into hi (`dh`, which may be
// `d`: in place, each chunk read and written by one thread) and lo (`dl`).
// The row's sum goes to `ds[row]` and, for a row below S, to `out[row]`
// (device memory). Each thread sums its chunks in order, then the row's
// threads by shuffles: a fixed order, bitwise on a rerun.
template <int DP, int NT>
__device__ __forceinline__ void delta_pass(const unsigned char* o,
                                           unsigned char* d, unsigned char* dh,
                                           unsigned char* dl, float* ds,
                                           float* out, int valid_rows,
                                           int idx) {
  constexpr int TPR = NT / ROWS;     // threads a row
  constexpr int CPT = DP / 4 / TPR;  // 4-column chunks a thread
  const int r = idx / TPR, part = idx % TPR;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = part + TPR * i;  // columns 4 c .. 4 c + 3
    const int off = (c / 8) * QREGION + swz_f32(r, 4 * (c & 7));
    const float4 ov = *reinterpret_cast<const float4*>(o + off);
    const float4 dv = *reinterpret_cast<const float4*>(d + off);
    acc += ov.x * dv.x + ov.y * dv.y + ov.z * dv.z + ov.w * dv.w;
    float4 l4;
    const float4 h4 = split4(dv, l4);
    *reinterpret_cast<float4*>(dh + off) = h4;
    *reinterpret_cast<float4*>(dl + off) = l4;
  }
#pragma unroll
  for (int m = 1; m < TPR; m <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (part == 0) {
    ds[r] = acc;
    if (r < valid_rows) out[r] = acc;
  }
}

// Work item x: (batch * head bh, ITEM_ROWS query rows), the heaviest causal
// items of a (batch, head) first; block b takes items b, b + gridDim.x, ...
// (PADDLE_F32_PERSISTENT: as many blocks as fit on the card at once; else
// one block an item). In an accumulator of m64nN a thread (warp w of its
// warpgroup, lane 4 g + t) holds d[4 j + 2 e2 + e] at row 16 w + g + 8 e2
// (a query row of the warpgroup's 64), column 8 j + 2 t + e (a key of the
// stage, or a column of dQ).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ bias,
                            const int* __restrict__ seed_ptr,
                            float* __restrict__ dq, float* __restrict__ delta,
                            int H, int S, int Sk, int D, int n_qt,
                            int n_items, float sm_scale, int causal,
                            int dropout, float keep_div, uint32_t thresh) {
  using L = Smem<DP>;
  constexpr int NC = DP / F32_COLS;  // regions of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on such a line
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warpgroup's rows, ring slot and delta, and the mbarriers of their
  // landings (shared rows: the block's rows and the first barrier)
  const int rs = L::rows(wg);
  const uint32_t st = base + L::slot(wg);
  unsigned char* const stp = smem + L::slot(wg);
  float* const delta_s = reinterpret_cast<float*>(smem + L::delta(wg));
  const uint32_t bar_rows = base + L::BAR + (SHARED ? 0 : 8 * wg);
  const uint32_t bar_kv = base + L::BAR + 16 + 8 * wg;

  // an item's (batch * head, first row of this warpgroup's 64) and its key
  // stages: all of Sk, or under causal masking up to the one that holds
  // its last row (none for a warpgroup whose rows all lie past S)
  const int n_ks = (Sk + KS - 1) / KS;
  auto item_bh = [&](int x) { return x / n_qt; };
  auto item_r0 = [&](int x, int w) {
    return (n_qt - 1 - x % n_qt) * ITEM_ROWS + (SHARED ? 0 : ROWS * w);
  };
  auto item_stages = [&](int x, int w) {
    const int r0 = item_r0(x, w);
    if (r0 >= S) return 0;
    return causal ? min(n_ks, (min(r0 + ROWS, S) - 1) / KS + 1) : n_ks;
  };
  // this warpgroup's first stage and the step between its stages
  constexpr int STEP = SHARED ? 2 : 1;
  const int first = SHARED ? wg : 0;

  // Q, dO and O of item x for warpgroup w (shared rows: into the landing
  // buffers; else in place, O into Q's lo buffer); K and V of stage n of
  // item x into warpgroup w's slot
  auto load_rows = [&](int x, int w) {
    const uint32_t bar = base + L::BAR + (SHARED ? 0 : 8 * w);
    const uint32_t dst = base + L::rows(w);
    const int row = item_r0(x, w);
    const uint32_t to_q = dst + (SHARED ? L::QLAND : L::QH);
    const uint32_t to_o = dst + (SHARED ? L::OLAND : L::QL);
    const uint32_t to_do = dst + (SHARED ? L::DOLAND : L::DOH);
    mbar_expect_tx(bar, 3 * L::QT);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(to_q + c * QREGION, &tm_q, c * F32_COLS, row, item_bh(x), bar);
      tma_load(to_o + c * QREGION, &tm_o, c * F32_COLS, row, item_bh(x), bar);
      tma_load(to_do + c * QREGION, &tm_do, c * F32_COLS, row, item_bh(x),
               bar);
    }
  };
  auto load_kv = [&](int x, int n, int w) {
    const uint32_t dst = base + L::slot(w);
    const uint32_t bar = base + L::BAR + 16 + 8 * w;
    mbar_expect_tx(bar, 2 * L::KT);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(dst + L::KH + c * KREGION, &tm_k, c * F32_COLS, n * KS,
               item_bh(x), bar);
      tma_load(dst + L::VH + c * KREGION, &tm_v, c * F32_COLS, n * KS,
               item_bh(x), bar);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(base + L::BAR + 8 * i, 1);
  }
  __syncthreads();  // the barriers are initialised
  if (SHARED && tid == 0 && blockIdx.x < n_items) load_rows(blockIdx.x, 0);

  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  uint32_t rows_phase = 0, kv_phase = 0;
  // the items whose rows (a warpgroup an item half) and first stage this
  // warpgroup's buffers hold or await
  int fetched_rows = -1, fetched_kv = -1;

  for (int x = blockIdx.x; x < n_items; x += gridDim.x) {
    const int bh = item_bh(x), b = bh / H;
    const int r0 = item_r0(x, wg), n_st = item_stages(x, wg);
    const int next = x + gridDim.x;  // this block's next item
    const size_t row_base = (size_t)bh * S;
    // a warpgroup an item half: one whose rows all lie past S has nothing
    // to do (no barrier joins the two warpgroups)
    if (!SHARED && n_st == 0) continue;

    // this warpgroup's rows (a warpgroup an item half) and first stage,
    // unless the last item's products already fetched them
    if (wtid == 0) {
      if (!SHARED && fetched_rows != x) load_rows(x, wg);
      if (first < n_st && fetched_kv != x) load_kv(x, first, wg);
    }
    __syncwarp();

    // delta from O and dO as they landed, dO split on the way, then Q
    // split: shared rows by the block from the landing buffers, which then
    // take the next item's; else by the warpgroup, in place
    mbar_wait(bar_rows, rows_phase);
    rows_phase ^= 1;
    unsigned char* const rp = smem + rs;
    if (SHARED) {
      delta_pass<DP, THREADS>(rp + L::OLAND, rp + L::DOLAND, rp + L::DOH,
                              rp + L::DOL, delta_s, delta + row_base + r0,
                              S - r0, tid);
      split_rows<THREADS>(rp + L::QLAND, rp + L::QH, rp + L::QL, L::QT);
      fence_proxy_async();  // the copies visible to wgmma
      __syncthreads();
      if (tid == 0 && next < n_items) load_rows(next, 0);
      __syncwarp();
    } else {
      delta_pass<DP, 128>(rp + L::QL, rp + L::DOH, rp + L::DOH, rp + L::DOL,
                          delta_s, delta + row_base + r0, S - r0, wtid);
      named_barrier(1 + wg, 128);  // O (in Q's lo buffer) is read
      split_wg(rp + L::QH, rp + L::QL, L::QT);
      fence_proxy_async();  // the copies visible to wgmma
      named_barrier(1 + wg, 128);
    }

    // this thread's two query rows: lse from device memory, delta from
    // the pass above
    int rows[2];
    bool valid[2];
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = 16 * warp + g + 8 * e2;
      rows[e2] = r0 + r;
      valid[e2] = rows[e2] < S;  // ragged S: P = 0 and dS = 0
      lse_r[e2] = valid[e2] ? lse[row_base + rows[e2]] : 0.f;
      delta_r[e2] = delta_s[r];
    }
    float dq_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

    for (int n = first; n < n_st; n += STEP) {
      const int k0 = n * KS;
      // the slot's landing; its last products have retired in every warp
      // of the warpgroup (the wait at the end of the last stage)
      mbar_wait(bar_kv, kv_phase);
      kv_phase ^= 1;
      named_barrier(1 + wg, 128);
      split_stage_k<DP>(stp, L::KH, L::KL, L::KTH, L::KTL);
      split_wg(stp + L::VH, stp + L::VL, L::KT);
      fence_proxy_async();  // the copies visible to wgmma
      named_barrier(1 + wg, 128);

      // S = Q K^T and dP = dO V^T: the warpgroup's 64 rows by 32 keys
      float sa[16], dpa[16];
      const uint32_t qb = base + rs;
      wg_fence();
      wgmma_tf32_split_ss<KS, DP>(sa, qb + L::QH, qb + L::QL, QREGION,
                                  st + L::KH, st + L::KL, KREGION);
      wgmma_tf32_split_ss<KS, DP>(dpa, qb + L::DOH, qb + L::DOL, QREGION,
                                  st + L::VH, st + L::VL, KREGION);
      wg_commit();

      // the clamped bias of this thread's eight keys, under the products
      int keys[8];
      float bk[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        keys[c] = k0 + 8 * (c >> 1) + 2 * t + (c & 1);
        bk[c] = bias_at(bias, b, keys[c], Sk);
      }

      wg_wait<0>();
      fence_acc(sa);
      fence_acc(dpa);
      // every warp's S and dP have read the slot's K and V and the rows'
      // Q and dO: the slot takes this warpgroup's next stage, of this item
      // or the next (and, a warpgroup an item half, its rows the next
      // item's)
      named_barrier(1 + wg, 128);
      if (wtid == 0) {
        if (n + STEP < n_st) {
          load_kv(x, n + STEP, wg);
        } else if (next < n_items && first < item_stages(next, wg)) {
          load_kv(next, first, wg);
          fetched_kv = next;
          if (!SHARED) {
            load_rows(next, wg);
            fetched_rows = next;
          }
        }
      }
      __syncwarp();  // warp 0 whole again before its next wgmma

      // element (query row, key): dS, split into the A fragments of
      // dQ += dS K
      uint32_t dh[16], dl[16];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int xx = 4 * j + 2 * e2 + e;
            const int key = keys[2 * j + e];
            const float xs = masked_score(sa[xx], sm_scale, bk[2 * j + e],
                                          rows[e2], key, Sk, causal);
            const float p = valid[e2] ? __expf(xs - lse_r[e2]) : 0.f;
            float dpv = dpa[xx];
            if (dropout)
              dpv = keep(seed, (uint32_t)bh, (uint32_t)rows[e2],
                         (uint32_t)key, thresh)
                        ? dpv * keep_scale
                        : 0.f;
            split_tf32(valid[e2] ? p * (dpv - delta_r[e2]) * sm_scale : 0.f,
                       dh[xx], dl[xx]);
          }

      fence_acc(dq_acc);
      wg_fence();
      wgmma_tf32_split_rs<DP, KS>(dq_acc, dh, dl, st + L::KTH, st + L::KTL,
                                  L::TT);
      wg_commit();
      wg_wait<0>();  // the slot's copies are free for the next split
      fence_acc(dq_acc);
    }

    if (SHARED) {
      // warpgroup 1 hands its dQ over through its slot's K lo and V lo (no
      // load lands there), warpgroup 0 adds it to its own (a fixed order:
      // reruns are bitwise)
      float* xq = reinterpret_cast<float*>(smem + L::slot(1) + L::KL);
      static_assert(DP / 2 * 128 * sizeof(float) <= (size_t)(2 * L::KT),
                    "the hand-over fits in a slot's K lo and V lo");
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) xq[i * 128 + wtid] = dq_acc[i];
      }
      __syncthreads();
      if (wg == 1) continue;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq_acc[i] += xq[i * 128 + wtid];
      // the hand-over is read before warpgroup 1's next split, which
      // follows the next item's row split and its barrier
    }
    // dQ of this thread's rows (none past S, no column past D)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      if (!valid[e2]) continue;
      float* out = dq + (row_base + rows[e2]) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= D) continue;
        tc::store2(out + col, dq_acc[4 * j + 2 * e2],
                   dq_acc[4 * j + 2 * e2 + 1]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

struct DqArgs {
  const void *q, *k, *v, *o, *dout, *lse, *bias, *seed;
  void *dq, *delta;
  int B, H, S, Sk, D;
  float sm_scale;
  int causal, dropout;
  float keep_div;
  uint32_t thresh;
};

template <int DP>
int launch(const DqArgs& a, cudaStream_t stream) {
  const int BH = a.B * a.H;
  const int n_qt = (a.S + ITEM_ROWS - 1) / ITEM_ROWS;
  CUtensorMap mq, mk, mv, mo, mdo;
  if (!(tensor_map_f32(&mq, a.q, BH, a.S, a.D, ROWS) &&
        tensor_map_f32(&mk, a.k, BH, a.Sk, a.D, KS) &&
        tensor_map_f32(&mv, a.v, BH, a.Sk, a.D, KS) &&
        tensor_map_f32(&mo, a.o, BH, a.S, a.D, ROWS) &&
        tensor_map_f32(&mdo, a.dout, BH, a.S, a.D, ROWS)))
    return kErrTensorMap;
  constexpr size_t smem = Smem<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const void* kernel =
      reinterpret_cast<const void*>(flash_bwd_dq_f32_kernel<DP>);
  cudaError_t err = ensure_smem_attr(kernel, smem, attr_set);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)BH * n_qt;
  int grid = (int)items;
#if PADDLE_F32_PERSISTENT
  static int resident[kMaxDevices] = {};
  err = resident_blocks(kernel, THREADS, smem, resident);
  if (err != cudaSuccess) return (int)err;
  if (items > resident[current_device()])
    grid = resident[current_device()];
#endif
  flash_bwd_dq_f32_kernel<DP><<<(unsigned)grid, THREADS, smem, stream>>>(
      mq, mk, mv, mo, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.bias), static_cast<const int*>(a.seed),
      static_cast<float*>(a.dq), static_cast<float*>(a.delta), a.H, a.S,
      a.Sk, a.D, n_qt, (int)items, a.sm_scale, a.causal, a.dropout,
      a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout: [B, H, S, D]; k, v: [B, H, Sk, D]; all contiguous f32
// (is_bf16 = 0), 16-byte aligned, S >= 1, Sk >= 1, D one of 8, 16, 32, 64.
// lse: [B*H, S] f32; bias: [B, Sk] f32 or null; seed: int32 [1] on the
// device, read only when dropout != 0; dq: like q; delta: [B*H, S] f32,
// written. Launches one kernel on `stream` and returns the launch's
// cudaError_t (0 on success), or a negative code (paddle_cuda_error_string
// names it).
int paddle_flash_attention_bwd_dq_f32(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      const void* bias, const void* seed,
                                      void* dq, void* delta, int B, int H,
                                      int S, int Sk, int D, int is_bf16,
                                      float sm_scale, int causal, int dropout,
                                      float keep_div, unsigned int thresh,
                                      void* stream) {
  if (is_bf16 || S < 1 || Sk < 1) return kErrShape;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
        aligned16(dout)))
    return kErrAlign;
  const DqArgs a{q, k, v, o, dout, lse, bias, seed, dq, delta, B, H, S,
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
    return "the f32 dQ kernel takes f32 with S, Sk >= 1";
  return error_string(err);
}

}  // extern "C"
