// The f32 flash-attention forward for Hopper (sm_90a): split-TF32 wgmma
// products on tiles that TMA loads. One kernel, flash_fwd_f32_kernel; a
// plain C interface.
//
// Replaces, on every f32 path (the f32 BERT pretraining step, AMP, whose
// attention stays f32, the NaN guard, windows, serving and greedy decode),
// the TPU kernel `_fwd_kernel` / `_pallas_fwd` in
// paddle_tpu/ops/pallas/flash_attention.py (:219, :298; pallas_call :318),
// in place of the tiled kernel of flash_attention_fwd.cu (kept as the old
// route). ops/cuda/flash_attention.py's `fwd_route` sends f32 at head dims
// up to 64 here; f32 at 65..128 stays on the tiled kernel, a choice by
// shape (the D = 128 tile's hi, lo and transposed copies do not fit beside
// a second block). The function is the tiled kernel's:
//   O   = softmax(scale * Q K^T + bias, masked) V       (dropout on V only)
//   lse = m + log(l) per query row
// with the key-padding bias clamped at NEG_INF = -1e30, top-left causal
// masking and ragged S / Sk (flash_common.cuh's masked_score), the
// counter-hash dropout mask of keep_mask.cuh bit for bit (l sums the full
// probabilities; dropout scales only what enters P V), every sum in f32,
// and the dead-row rule of `_finalize` (:282): a row whose max stays at
// NEG_INF writes O = 0 and lse = +1e30. lse is [B*H, S] f32, the layout
// the dQ kernel reads. Both products are split TF32 as in tc_common.cuh:
// x = hi + lo, each TF32, and A B = lo*hi + hi*lo + hi*hi with f32 sums
// (one TF32 term misses the 1e-4 the kernel is held to).
//
// What bounds it on this card. At the train shape (B = 32, H = 12, S = Sk
// = 128, D = 64, f32, bias) the function reads Q, K, V and the bias and
// writes O and lse, 50.5 MB: 15.1 us at 3.35 TB/s; its 1.61 GFLOP as
// three TF32 products are 9.8 us at 495 TFLOP/s. So bytes bound it, the
// products near behind. The tiled kernel runs each product as three
// mma.sync m16n8k8 instructions, every warp re-splitting its fragments
// into hi and lo on every use (tc::load_b_kn), and that instruction
// stream, not the bytes, sets its time.
//
// What the design does about it.
// - wgmma m64nNk8 .tf32, three products a k step, A from registers and B
//   from shared memory: S = Q K^T (N = 64 keys) and O += P V (N = the
//   head dim). The tensor cores take a whole 64-row tile a warpgroup, and
//   no warp loads a B fragment.
// - Each operand is split into hi and lo once a block or once a tile, never
//   once a use: Q's A fragments once a block, in registers, from the tile
//   TMA landed; each K and V tile by one pass over shared memory after its
//   TMA load lands. TF32's wgmma reads B only K-major, so V (stored key by
//   key) is written transposed, V^T [d][key], in that pass; K keeps its
//   layout (hi in place, lo beside it). The transposed copy puts key
//   8 i + 2 t + e at k slot 8 i + t + 4 e (hopper_common.cuh's
//   tf32_slot): P's accumulator registers then are P V's A fragment as
//   they stand, as in the tiled kernel's a_from_acc. P is split in
//   registers, once an element. The splits round by integer operations
//   (hopper_common.cuh's split_tf32: cvt.rna's bits at a quarter of its
//   cost), and each product chain starts with its accumulator's scale-d
//   off, so no instruction zeroes it beside products in flight.
// - A work item is 64 query rows of one (batch, head), taken by one
//   warpgroup; the heaviest causal items of a (batch, head) first. K and V
//   stream in 64-key tiles; the next tile's TMA loads (K into K's hi
//   buffer, V into K's lo buffer, both free once S has landed) are issued
//   before the softmax, so they land under the softmax and P V.
// - Persistent (PADDLE_F32_PERSISTENT): as many blocks as the card holds
//   at once, each looping over items; the next item's Q is loaded as soon
//   as this one's fragments are in registers, and its first K and V tile
//   under this item's last softmax and P V. tools/f32_attention_ab.py
//   times it against one block an item, side by side.
// - The softmax is online across tiles in natural units (__expf, the
//   tiled kernel's), every element through masked_score; each thread
//   keeps its part of l and reduces it across the quad once, at the end.
//   Causal key tiles wholly above the diagonal are not loaded.
// - O and lse leave straight from the registers, columns past the head
//   dim and rows past S not written.
//
// Layout, shared memory and occupancy. A tile is [64 rows][DP f32] as
// DP / 32 regions of [64][32] (8 KB, one TMA box, 128-byte rows with the
// 128-byte swizzle); V^T is [DP rows][64 keys] as two regions of [DP][32]
// (keys 0..31, 32..63). Five tiles: Q as it lands, K hi (K lands here)
// and lo (V lands here), V^T hi and lo: 5 x 16 KB = 80 KB at DP = 64
// (82,960 B with the barriers and the 1024-byte alignment; head dims 8,
// 16, 32 run the DP = 32 instance, 40 KB). So two blocks (eight warps)
// an SM at DP = 64 (the registers, Q's 64 fragments among them, allow no
// third), more at DP = 32; while one block splits or runs its softmax the
// other's products keep the tensor cores busy. ptxas's registers and
// spills: chip_smoke.py's [build] lines.
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

constexpr int THREADS = 128;  // one warpgroup
constexpr int TILE = 64;      // query rows of a block, keys of a tile
constexpr int FREGION = TILE * 128;  // [64][32] f32: one TMA box, 8 KB

// negative return code besides flash_common.cuh's and hopper_common.cuh's
constexpr int kErrShape = -4;

// 1: as many blocks as the card holds at once, each looping over work
// items, the next item's Q and first K and V tiles loaded under this
// one's last products; 0: one block an item (tools/f32_attention_ab.py
// builds both and times them side by side)
#ifndef PADDLE_F32_PERSISTENT
#define PADDLE_F32_PERSISTENT 1
#endif

// Shared memory of a block, in bytes from a 1024-aligned base: five tiles
// of DP / 32 regions each (Q as it lands; K hi and lo; V^T hi and lo),
// then two mbarriers (Q with the first K and V; each later K and V).
template <int DP>
struct Smem {
  static constexpr int T = DP / F32_COLS * FREGION;  // one tile
  static constexpr int Q = 0, KH = T, KL = 2 * T;
  static constexpr int VH = 3 * T, VL = 4 * T;  // V^T, by 32-key regions
  static constexpr int VREGION = DP * 128;       // [DP][32] of V^T
  static constexpr int BAR = 5 * T;
  static constexpr int BYTES = BAR + 2 * 8 + 1024;  // + room to align
};

// V [64 keys][DP] at `src` (its landing regions) split into V^T's hi and
// lo copies [DP][64 keys] at `vh`, `vl`, keys at their tf32_slot. Warp w
// takes keys 32 (w % 2) .. + 31, one a lane, and the 4-column chunks
// (w / 2) DP / 8 .. + DP / 8 - 1: for each column the warp writes one
// 128-byte row of V^T, every lane to its own bank.
template <int DP>
__device__ __forceinline__ void split_v_transposed(const unsigned char* src,
                                                   unsigned char* vh,
                                                   unsigned char* vl) {
  constexpr int CPW = DP / 8;  // chunks a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = (warp & 1) * 32 + lane;
  const int slot = tf32_slot(lane);
  unsigned char* h = vh + (warp & 1) * Smem<DP>::VREGION;
  unsigned char* l = vl + (warp & 1) * Smem<DP>::VREGION;
#pragma unroll
  for (int cc = 0; cc < CPW; ++cc) {
    const int c = (warp >> 1) * CPW + cc;  // columns 4 c .. 4 c + 3
    float4 lo;
    const float4 hi = split4(
        *reinterpret_cast<const float4*>(src + (c / 8) * FREGION +
                                         swz_f32(key, 4 * (c & 7))),
        lo);
    const float hs[4] = {hi.x, hi.y, hi.z, hi.w};
    const float ls[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = swz_f32(4 * c + i, slot);
      *reinterpret_cast<float*>(h + off) = hs[i];
      *reinterpret_cast<float*>(l + off) = ls[i];
    }
  }
}

// Work item x: (batch * head bh, 64-row query tile); block b takes items
// b, b + gridDim.x, ... (PADDLE_F32_PERSISTENT: as many blocks as fit on
// the card at once; else one block an item). In an accumulator of m64nN a
// thread (warp w, lane 4 g + t) holds d[4 j + 2 e2 + e] at row
// 16 w + g + 8 e2, column 8 j + 2 t + e.
template <int DP>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ bias,
                         const int* __restrict__ seed_ptr,
                         float* __restrict__ o, float* __restrict__ lse,
                         int H, int S, int Sk, int D, int n_qt, int n_items,
                         float sm_scale, int causal, int dropout,
                         float keep_div, uint32_t thresh) {
  using L = Smem<DP>;
  constexpr int NC = DP / F32_COLS;  // regions of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on such a line
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar_q = base + L::BAR, bar_kv = bar_q + 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // an item's (batch * head, first query row) and its key tiles: all of
  // Sk, or under causal masking up to the one that holds its last row;
  // the heaviest causal tiles (the last rows) of a (batch, head) first
  auto item_bh = [&](int x) { return x / n_qt; };
  auto item_q0 = [&](int x) { return (n_qt - 1 - x % n_qt) * TILE; };
  auto item_tiles = [&](int x) {
    const int n = (Sk + TILE - 1) / TILE;
    return causal ? min(n, (min(item_q0(x) + TILE, S) - 1) / TILE + 1) : n;
  };
  // Q of item x into its buffer; K of key tile i of item x into K's hi
  // buffer, V into K's lo buffer
  auto load_q = [&](int x) {
    mbar_expect_tx(bar_q, L::T);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(base + L::Q + c * FREGION, &tm_q, c * F32_COLS, item_q0(x),
               item_bh(x), bar_q);
  };
  auto load_kv = [&](int x, int i) {
    mbar_expect_tx(bar_kv, 2 * L::T);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(base + L::KH + c * FREGION, &tm_k, c * F32_COLS, i * TILE,
               item_bh(x), bar_kv);
      tma_load(base + L::KL + c * FREGION, &tm_v, c * F32_COLS, i * TILE,
               item_bh(x), bar_kv);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    if (blockIdx.x < n_items) {
      load_q(blockIdx.x);
      load_kv(blockIdx.x, 0);
    }
  }
  __syncthreads();  // the barriers are initialised

  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;
  uint32_t q_phase = 0, kv_phase = 0;

  for (int x = blockIdx.x; x < n_items; x += gridDim.x) {
    const int bh = item_bh(x), q0 = item_q0(x), b = bh / H;
    const int n_kt = item_tiles(x);
    const int next = x + gridDim.x;  // this block's next item
    int rows[2];  // this thread's two query rows, absolute
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) rows[e2] = q0 + 16 * warp + g + 8 * e2;

    // Q's A fragments of S = Q K^T, split in registers once an item: k
    // step kk's a0 .. a3 at rows 16 w + g (+ 8), columns 8 kk + t (+ 4),
    // stored in the accumulator's order that wgmma_tf32_split_rs reads;
    // then the buffer takes the next item's Q
    mbar_wait(bar_q, q_phase);
    q_phase ^= 1;
    uint32_t qh[DP / 2], ql[DP / 2];
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * warp + g + 8 * (i & 1);
        const int c = 8 * (kk & 3) + t + 4 * (i >> 1);
        const int xx = 4 * kk + 2 * (i & 1) + (i >> 1);
        split_tf32(*reinterpret_cast<const float*>(
                       smem + L::Q + (kk / 4) * FREGION + swz_f32(r, c)),
                   qh[xx], ql[xx]);
      }
    __syncthreads();  // every thread has read Q
    if (tid == 0 && next < n_items) load_q(next);
    __syncwarp();

    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's part of each row's sum
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    for (int i = 0; i < n_kt; ++i) {
      const int k0 = i * TILE;
      // the clamped bias of this thread's 16 keys, loaded under the split
      // and the products
      float bk[16];
#pragma unroll
      for (int c = 0; c < 16; ++c)
        bk[c] = bias_at(bias, b, k0 + 8 * (c >> 1) + 2 * t + (c & 1), Sk);
      // the landed K and V into their hi and lo copies: V first (it lands
      // where K's lo goes); V^T's last reader, the previous P V, has
      // retired in every warp (the barrier closing the last tile)
      mbar_wait(bar_kv, kv_phase);
      kv_phase ^= 1;
      split_v_transposed<DP>(smem + L::KL, smem + L::VH, smem + L::VL);
      __syncthreads();
      split_rows<THREADS>(smem + L::KH, smem + L::KH, smem + L::KL, L::T);
      fence_proxy_async();  // the copies visible to wgmma
      __syncthreads();

      // S = Q K^T
      float s[32];
      wg_fence();
      wgmma_tf32_split_rs<64, DP, true>(s, qh, ql, base + L::KH,
                                        base + L::KL, FREGION);
      wg_commit();
      wg_wait<0>();
      fence_acc(s);
      // every warp's S has read K: its buffers take the next tile, of
      // this item or of the next
      __syncthreads();
      if (tid == 0) {
        if (i + 1 < n_kt)
          load_kv(x, i + 1);
        else if (next < n_items)
          load_kv(next, 0);
      }
      __syncwarp();  // warp 0 whole again before its shuffles and wgmma

      // scale, clamped bias, ragged and causal masks; the tile's row max
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int xx = 4 * j + 2 * e2 + e;
            s[xx] = masked_score(s[xx], sm_scale, bk[2 * j + e], rows[e2],
                                 key, Sk, causal);
            mx[e2] = fmaxf(mx[e2], s[xx]);
          }
        }
      float alpha[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        mx[e2] = fmaxf(mx[e2], __shfl_xor_sync(0xffffffffu, mx[e2], 1));
        mx[e2] = fmaxf(mx[e2], __shfl_xor_sync(0xffffffffu, mx[e2], 2));
        const float mn = fmaxf(m[e2], mx[e2]);
        alpha[e2] = __expf(m[e2] - mn);
        m[e2] = mn;
        l[e2] *= alpha[e2];
      }

      // P = exp(x - m): l sums the full probabilities; the dropped-out
      // and rescaled values are split into P V's A fragments
      uint32_t ph[32], pl[32];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int xx = 4 * j + 2 * e2 + e;
            float p = __expf(s[xx] - m[e2]);
            l[e2] += p;
            if (dropout)
              p = keep(seed, (uint32_t)bh, (uint32_t)rows[e2],
                       (uint32_t)(k0 + 8 * j + 2 * t + e), thresh)
                      ? p * keep_scale
                      : 0.f;
            split_tf32(p, ph[xx], pl[xx]);
          }

      // O = alpha O + P V: A from registers, V^T from shared memory
#pragma unroll
      for (int xx = 0; xx < DP / 2; ++xx) acc[xx] *= alpha[(xx >> 1) & 1];
      fence_acc(acc);
      wg_fence();
      wgmma_tf32_split_rs<DP, TILE>(acc, ph, pl, base + L::VH, base + L::VL,
                                    L::VREGION);
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
      __syncthreads();  // every warp's P V has read V^T
    }

    // finalize (`_finalize`): O / l and lse to device memory; dead rows
    // write zeros and lse = +1e30
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 1);
      l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 2);
      const int row = rows[e2];
      if (row >= S) continue;
      const bool dead = m[e2] <= NEG_INF * 0.5f;
      const float inv = dead ? 0.f : 1.f / l[e2];
      float* orow = o + ((size_t)bh * S + row) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < D)
          tc::store2(orow + col, acc[4 * j + 2 * e2] * inv,
                     acc[4 * j + 2 * e2 + 1] * inv);
      }
      if (t == 0)
        lse[(size_t)bh * S + row] =
            dead ? -NEG_INF : m[e2] + logf(l[e2]);
    }
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
  const int n_qt = (a.S + TILE - 1) / TILE;
  CUtensorMap mq, mk, mv;
  if (!(tensor_map_f32(&mq, a.q, BH, a.S, a.D, TILE) &&
        tensor_map_f32(&mk, a.k, BH, a.Sk, a.D, TILE) &&
        tensor_map_f32(&mv, a.v, BH, a.Sk, a.D, TILE)))
    return kErrTensorMap;
  constexpr size_t smem = Smem<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(flash_fwd_f32_kernel<DP>);
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
  flash_fwd_f32_kernel<DP><<<(unsigned)grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<const float*>(a.bias),
      static_cast<const int*>(a.seed), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.H, a.S, a.Sk, a.D, n_qt, (int)items,
      a.sm_scale, a.causal, a.dropout, a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: [B, H, S, D]; k, v: [B, H, Sk, D]; all contiguous f32 (is_bf16 =
// 0), 16-byte aligned, S >= 1, Sk >= 1, D one of 8, 16, 32, 64. bias: [B,
// Sk] f32 or null; seed: int32 [1] on the device, read only when dropout
// != 0; lse: [B*H, S] f32. Launches one kernel on `stream` and returns the
// launch's cudaError_t (0 on success), or a negative code
// (paddle_cuda_error_string names it).
int paddle_flash_attention_fwd_f32(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* seed, void* o, void* lse,
                                   int B, int H, int S, int Sk, int D,
                                   int is_bf16, float sm_scale, int causal,
                                   int dropout, float keep_div,
                                   unsigned int thresh, void* stream) {
  if (is_bf16 || S < 1 || Sk < 1) return kErrShape;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return kErrAlign;
  const FwdArgs a{q, k, v, bias, seed, o, lse, B, H, S, Sk, D, sm_scale,
                  causal, dropout, keep_div, thresh};
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
    return "the f32 forward takes f32 with S, Sk >= 1";
  return error_string(err);
}

}  // extern "C"
