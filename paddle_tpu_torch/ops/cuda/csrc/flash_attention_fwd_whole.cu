// The bf16 flash-attention forward for Hopper (sm_90a) where one block
// holds the whole key range of a (batch, head): S <= 128 and Sk <= 128.
// One kernel, flash_fwd_whole_kernel; a plain C interface.
//
// Replaces, on this path, the TPU kernel `_fwd_kernel` / `_pallas_fwd` in
// paddle_tpu/ops/pallas/flash_attention.py (:219, :298; pallas_call :318).
// f32, and S or Sk above 128, keep the tiled kernel of
// flash_attention_fwd.cu (ops/cuda/flash_attention.py: `fwd_route`, which
// decides by the predicate `bwd_route` uses, so the forward and the fused
// backward agree on what "whole" means). The function is theirs:
//   O   = softmax(scale * Q K^T + bias, masked) V       (dropout on V only)
//   lse = m + log(l) per query row
// with the key-padding bias clamped at NEG_INF, top-left causal masking
// and ragged S / Sk (flash_common.cuh's masked_score), the counter-hash
// dropout mask of keep_mask.cuh bit for bit (l sums the full
// probabilities; dropout scales only what enters P V), P rounded to bf16
// before P V, every sum in f32, and the dead-row rule of `_finalize`
// (:282): a row whose max stays at NEG_INF writes O = 0 and lse = +1e30.
// lse is [B*H, S] f32, the layout the fused backward reads.
//
// What bounds it on this card. Per (batch, head) the function reads Q, K
// and V (3 x 16 KB at S = Sk = 128, D = 64, bf16) and the bias row, and
// writes O (16 KB) and lse (512 B): 64.5 KB against 4 * S * Sk * D =
// 4.2 MFLOP, 64 FLOP a byte, far under the 295 at which the bf16 tensor
// cores would bind. So it is bound by bytes: at the bench lane's shape (B
// = 256, H = 12, no bias) 202.9 MB, 0.0606 ms at 3.35 TB/s, against 0.013
// ms of products at 989 TFLOP/s. The tiled kernel runs two blocks a
// (batch, head) at S = 128, each reading all of K and V, splits the keys
// between its two warpgroups (an online softmax in each, then a merge
// through shared memory behind a barrier, one warpgroup idle after it),
// and exposes its first tile's load.
//
// What the design does about it.
// - One block a (batch, head), one linear grid over B*H: Q, K and V are
//   read from device memory once, by TMA (cp.async.bulk.tensor) as
//   [128 rows][64 columns] boxes in 128-byte-swizzled shared memory,
//   hopper_common.cuh's tensor maps and helpers, as in the fused backward.
//   Rows past S or Sk and columns past D are zero-filled by the copy. Q
//   and K arrive on one mbarrier and V on a second, so S = Q K^T and the
//   softmax run while V is still arriving.
// - Two warpgroups of 64 query rows, each holding all 128 keys of its
//   rows: S = Q K^T is two wgmma m64n64k16 chains (64 keys each, both
//   operands K-major in shared memory), accumulated in registers. The
//   softmax is one pass, not an online one: the row max and the row sum
//   are final after one quad reduction each, with no rescale and no merge
//   between warpgroups (the plain version's function,
//   flash_attention_reference).
// - O = P V by wgmma with A from registers: P is packed to bf16 in the
//   accumulator's own layout (as dS feeds dQ in the fused backward), and
//   V is read MN-major through the descriptor's transpose bit, with no
//   transposed copy.
// - O leaves through shared memory: each warpgroup writes its 64 rows,
//   scaled by 1 / l and swizzled, over its own rows of Q (dead once its
//   Q K^T has retired), and one of its threads stores them by TMA, which
//   clips rows past S and columns past D; a warpgroup never waits for the
//   other. lse goes straight out, eight consecutive rows a store.
// - Occupancy: at D = 64 Q, K and V take 48 KB, with the bias row and two
//   barriers 50 KB a block, so two blocks (16 warps) share an SM and one
//   block's loads overlap the other's products; ptxas's registers
//   (chip_smoke.py's [build] line) must stay under 128 a thread for that.
//   At D = 128, 97 KB and one block an SM: its accumulators (64 of S, 64
//   of O) do not fit 128 registers.
// - Head dims: the instance is 64 columns (D = 8 .. 64; TMA zero-fills the
//   columns past D and the store leaves them) or 128 (two 64-column halves
//   a tile); the wrapper pads any other D to the next of 8, 16, 32, 64 and
//   128 as for the other kernels.
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

// Shared memory of a block, in bytes from a 1024-aligned base: Q, K and V
// [128][DP] each (DP / 64 regions), O written over Q, the bias row, and
// two mbarriers (Q and K; V).
template <int DP>
struct Smem {
  static constexpr int T = DP / COLS * REGION;  // one tile
  static constexpr int Q = 0, K = T, V = 2 * T;
  static constexpr int BIAS = 3 * T;             // 128 f32
  static constexpr int BAR = BIAS + ROWS * 4;    // two mbarriers
  static constexpr int BYTES = BAR + 16 + 1024;  // + room to align the base
};

// Block bh: batch * head bh. Warpgroup wg owns query rows 64 wg .. 64 wg
// + 63 of S, P and O. In an accumulator of m64n64 a thread (warp w of its
// group, lane 4 g + t) holds d[4 j + 2 e2 + e] at row 16 w + g + 8 e2,
// column 8 j + 2 t + e: each row's 64 columns lie in the four threads of a
// quad.
template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
    flash_fwd_whole_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const float* __restrict__ bias,
                           const int* __restrict__ seed_ptr,
                           float* __restrict__ lse, int H, int S, int Sk,
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
  const uint32_t bar_qk = base + L::BAR, bar_v = bar_qk + 8;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;

  if (tid == 0) {
    mbar_init(bar_qk, 1);
    mbar_init(bar_v, 1);
    mbar_expect_tx(bar_qk, 2 * NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(base + L::Q + c * REGION, &tm_q, c * COLS, 0, bh, bar_qk);
      tma_load(base + L::K + c * REGION, &tm_k, c * COLS, 0, bh, bar_qk);
    }
    mbar_expect_tx(bar_v, NC * REGION);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load(base + L::V + c * REGION, &tm_v, c * COLS, 0, bh, bar_v);
  }
  // the bias row, clamped (0 without a bias and past Sk)
  if (tid < ROWS) bias_s[tid] = bias_at(bias, b, tid, Sk);
  __syncthreads();  // the barriers are initialised, the bias row is in

  int rows[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2)
    rows[e2] = WG_ROWS * wg + 16 * warp + g + 8 * e2;
  const uint32_t seed = dropout ? (uint32_t)seed_ptr[0] : 0u;
  const float keep_scale = 1.f / keep_div;

  mbar_wait(bar_qk, 0);

  // S = Q K^T over the warpgroup's rows and all 128 keys: keys 64 h ..
  // 64 h + 63 in s[h]
  float s[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[h][i] = 0.f;
    fence_acc(s[h]);
  }
  wg_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * REGION + (kk % 4) * 32;
      wgmma_ss<0, 0>(s[h], desc_k(base + L::Q + off + WG_ROWS * wg * 128),
                     desc_k(base + L::K + off + 64 * h * 128));
    }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int h = 0; h < 2; ++h) fence_acc(s[h]);

  // one softmax pass over whole rows: the masked scores and their max
  float m[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * e2 + e;
          const int key = 64 * h + 8 * j + 2 * t + e;
          s[h][i] = masked_score(s[h][i], sm_scale, bias_s[key], rows[e2],
                                 key, Sk, causal);
          m[e2] = fmaxf(m[e2], s[h][i]);
        }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    m[e2] = fmaxf(m[e2], __shfl_xor_sync(0xffffffffu, m[e2], 1));
    m[e2] = fmaxf(m[e2], __shfl_xor_sync(0xffffffffu, m[e2], 2));
  }

  // P = exp(S - m): l sums the full probabilities; the dropped-out and
  // rescaled values are packed to bf16 as the A operand of P V, key half
  // h at k step kk in p[h][4 kk .. 4 kk + 3]
  float l[2] = {0.f, 0.f};
  uint32_t p[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float pe[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 64 * h + 8 * j + 2 * t + e;
          float x = __expf(s[h][4 * j + 2 * e2 + e] - m[e2]);
          l[e2] += x;
          if (dropout)
            x = keep(seed, (uint32_t)bh, (uint32_t)rows[e2], (uint32_t)key,
                     thresh)
                    ? x * keep_scale
                    : 0.f;
          pe[e] = x;
        }
        p[h][2 * j + e2] = pack(pe[0], pe[1]);
      }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 1);
    l[e2] += __shfl_xor_sync(0xffffffffu, l[e2], 2);
  }

  // O = P V: A from registers, V read MN-major (its rows are the keys)
  mbar_wait(bar_v, 0);
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
        wgmma_rs<1>(acc[c], p[h][4 * kk], p[h][4 * kk + 1], p[h][4 * kk + 2],
                    p[h][4 * kk + 3],
                    desc_mn(base + L::V + c * REGION +
                            (64 * h + 16 * kk) * 128));
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(acc[c]);

  // finalize (`_finalize`): O / l in bf16 over the warpgroup's rows of Q,
  // lse to device memory; dead rows write zeros and lse = +1e30
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const bool dead = m[e2] <= NEG_INF * 0.5f;
    const float inv = 1.f / l[e2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * e2;
        *reinterpret_cast<uint32_t*>(smem + L::Q + c * REGION +
                                     swz(rows[e2], j, t)) =
            pack(dead ? 0.f : acc[c][i] * inv,
                 dead ? 0.f : acc[c][i + 1] * inv);
      }
    if (t == 0 && rows[e2] < S)
      lse[(size_t)bh * S + rows[e2]] =
          dead ? -NEG_INF : m[e2] + logf(l[e2]);
  }
  fence_proxy_async();  // O visible to the TMA store
  named_barrier(1 + wg, 128);
  if ((tid & 127) == 0 && WG_ROWS * wg < S) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_store(&tm_o, base + L::Q + c * REGION + WG_ROWS * wg * 128,
                c * COLS, WG_ROWS * wg, bh);
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
  CUtensorMap mq, mk, mv, mo;
  if (!(tensor_map(&mq, a.q, BH, a.S, a.D) &&
        tensor_map(&mk, a.k, BH, a.Sk, a.D) &&
        tensor_map(&mv, a.v, BH, a.Sk, a.D) &&
        tensor_map(&mo, a.o, BH, a.S, a.D, WG_ROWS)))
    return kErrTensorMap;
  constexpr size_t smem = Smem<DP>::BYTES;
  static bool attr_set[kMaxDevices] = {};
  const cudaError_t err = ensure_smem_attr(
      reinterpret_cast<const void*>(flash_fwd_whole_kernel<DP>), smem,
      attr_set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_whole_kernel<DP><<<(unsigned)BH, THREADS, smem, stream>>>(
      mq, mk, mv, mo, static_cast<const float*>(a.bias),
      static_cast<const int*>(a.seed), static_cast<float*>(a.lse), a.H, a.S,
      a.Sk, a.sm_scale, a.causal, a.dropout, a.keep_div, a.thresh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: [B, H, S, D]; k, v: [B, H, Sk, D]; all contiguous bf16 (is_bf16 =
// 1), 16-byte aligned, 1 <= S <= 128, 1 <= Sk <= 128, D one of 8, 16, 32,
// 64, 128. bias: [B, Sk] f32 or null; seed: int32 [1] on the device, read
// only when dropout != 0; lse: [B*H, S] f32. Launches one kernel on
// `stream` and returns the launch's cudaError_t (0 on success), or a
// negative code (paddle_cuda_error_string names it).
int paddle_flash_attention_fwd_whole(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* seed, void* o, void* lse,
                                     int B, int H, int S, int Sk, int D,
                                     int is_bf16, float sm_scale, int causal,
                                     int dropout, float keep_div,
                                     unsigned int thresh, void* stream) {
  if (!is_bf16 || S < 1 || S > ROWS || Sk < 1 || Sk > ROWS) return kErrShape;
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
    return "the whole-block forward takes bf16 with 1 <= S, Sk <= 128";
  return error_string(err);
}

}  // extern "C"
