// Tensor-core building blocks of all three flash-attention kernels (the
// forward, dK/dV and dQ): 16-byte asynchronous copies into a ring of
// shared-memory tiles, the split-TF32 form of an f32 operand, and the
// mma.sync fragments of both operand types with their (row, column) maps.
//
// Numerics. TF32 keeps 10 of f32's 23 mantissa bits, about three decimal
// digits: one TF32 product of the attention scores misses the f32 plain
// version by more than chip_smoke.py's 1e-4 (tests/test_torch_flash_tc_
// numerics.py shows it). So an f32 operand x is split into hi = tf32(x)
// and lo = tf32(x - hi), and a product is summed in f32 as
// lo*hi + hi*lo + hi*hi: three TF32 products, about 21 bits of each
// operand, at a third of the TF32 rate. bf16 operands go to the bf16
// tensor cores as they are, with f32 accumulation.
//
// Fragments (PTX ISA, mma.sync.m16n8k8 .tf32 and m16n8k16 .bf16). In a
// warp, lane = 4 g + t (g = lane / 4, t = lane % 4). The f32 accumulator
// of a 16 x 8 tile holds c[i] at row g + 8 (i / 2), column 2 t + i % 2;
// the masks, the bias and the dropout hash read those (row, column)
// pairs. An accumulator tile becomes the A
// operand of the next product without leaving registers:
//   bf16: columns 2t, 2t+1 of tiles 2s and 2s+1 are exactly the k slots
//         of A at step s;
//   TF32: A wants k slots t and t+4, the accumulator holds columns 2t and
//         2t+1. Instead of moving values between lanes, the product's k
//         order is relabelled: slot t is column 2t, slot t+4 is column
//         2t+1, and load_b_kn reads B's rows in the same order. A sum over
//         k does not depend on the order of its terms.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paddle_fa {
namespace tc {

constexpr int THREADS = 128;  // a warpgroup: four warps of 16 rows each

// ---- asynchronous copies (cp.async) ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with pred false nothing is read
// and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled when pred is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged tile of T with D columns: row stride D + 16 bytes. Rows stay
// 16-byte aligned for cp.async, and the 8 rows x 4 words that one
// fragment load touches fall in 32 distinct banks (row stride = 4 words
// mod 32 for every head dim but bf16 D = 8, which has 2-way conflicts).
template <typename T, int D>
struct Tile {
  static constexpr int CHUNK = 16 / (int)sizeof(T);  // elements per copy
  static constexpr int STRIDE = D + CHUNK;
  static constexpr int ELEMS = 64 * STRIDE;  // one 64-row tile
};

// Issue the copies of rows [r0, r0 + ROWS) of a row-major [limit, D]
// matrix at src into dst, spread over the block's NTHREADS threads; rows
// at or past limit are zero-filled.
template <typename T, int D, int NTHREADS = THREADS, int ROWS = 64>
__device__ __forceinline__ void copy_tile_async(T* dst, const T* src, int r0,
                                                int limit) {
  constexpr int C = Tile<T, D>::CHUNK;
  constexpr int PER_ROW = D / C;
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += NTHREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * C;
    const bool in = r0 + r < limit;
    cp_async16(dst + r * Tile<T, D>::STRIDE + c,
               in ? src + (size_t)(r0 + r) * D + c : src, in);
  }
}

// ---- split TF32 -------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value; lo is x - hi rounded to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ---- fragments --------------------------------------------------------------

struct FragA32 {  // 16 x 8 TF32, split
  uint32_t hi[4], lo[4];
};
struct FragB32 {  // 8 x 8 TF32, split
  uint32_t hi[2], lo[2];
};
struct FragA16 {  // 16 x 16 bf16, two values a register
  uint32_t x[4];
};
struct FragB16 {  // 16 x 8 bf16
  uint32_t x[2];
};

template <typename T>
struct Mma;
template <>
struct Mma<float> {
  using A = FragA32;
  using B = FragB32;
  static constexpr int K = 8;  // reduction depth of one instruction
};
template <>
struct Mma<__nv_bfloat16> {
  using A = FragA16;
  using B = FragB16;
  static constexpr int K = 16;
};

// the column of accumulator element i within its 8-column tile (its row
// is g + 8 (i / 2))
__device__ __forceinline__ int acc_col(int t, int i) { return 2 * t + (i & 1); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 in one register, lo in the low half (the lower k or column)
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16(lo), __float2bfloat16(hi));
}

// A: rows m0 .. m0+15, columns k0 .. of a row-major tile (row stride ST).
// D is the tile's column count: a bf16 step past it reads 0 (head dim 8
// runs one k = 16 step with its upper half zero).
template <int ST, int D>
__device__ __forceinline__ void load_a(FragA32& a, const float* s, int m0,
                                       int k0, int g, int t) {
  const float* p = s + (m0 + g) * ST + k0 + t;
  split(p[0], a.hi[0], a.lo[0]);
  split(p[8 * ST], a.hi[1], a.lo[1]);
  split(p[4], a.hi[2], a.lo[2]);
  split(p[8 * ST + 4], a.hi[3], a.lo[3]);
}
template <int ST, int D>
__device__ __forceinline__ void load_a(FragA16& a, const __nv_bfloat16* s,
                                       int m0, int k0, int g, int t) {
  const __nv_bfloat16* p = s + (m0 + g) * ST + k0 + 2 * t;
  a.x[0] = ld32(p);
  a.x[1] = ld32(p + 8 * ST);
  a.x[2] = k0 + 8 < D ? ld32(p + 8) : 0u;
  a.x[3] = k0 + 8 < D ? ld32(p + 8 * ST + 8) : 0u;
}

// B (k x n) whose tile is stored n-major: row n, column k (the K and V
// tiles for Q K^T and dO V^T, the Q and dO tiles for K Q^T and V dO^T).
template <int ST, int D>
__device__ __forceinline__ void load_b_nk(FragB32& b, const float* s, int n0,
                                          int k0, int g, int t) {
  const float* p = s + (n0 + g) * ST + k0 + t;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[4], b.hi[1], b.lo[1]);
}
template <int ST, int D>
__device__ __forceinline__ void load_b_nk(FragB16& b, const __nv_bfloat16* s,
                                          int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = s + (n0 + g) * ST + k0 + 2 * t;
  b.x[0] = ld32(p);
  b.x[1] = k0 + 8 < D ? ld32(p + 8) : 0u;
}

// B (k x n) whose tile is stored k-major: row k, column n (V for P V; dO
// and Q for P'^T dO and dS^T Q; K for dS K), in the k order of a_from_acc.
template <int ST>
__device__ __forceinline__ void load_b_kn(FragB32& b, const float* s, int k0,
                                          int n0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * ST + n0 + g;
  split(p[0], b.hi[0], b.lo[0]);   // k slot t     = row 2t
  split(p[ST], b.hi[1], b.lo[1]);  // k slot t + 4 = row 2t + 1
}
template <int ST>
__device__ __forceinline__ void load_b_kn(FragB16& b, const __nv_bfloat16* s,
                                          int k0, int n0, int g, int t) {
  const __nv_bfloat16* p = s + (k0 + 2 * t) * ST + n0 + g;
  b.x[0] = pack(p[0], p[ST]);
  b.x[1] = pack(p[8 * ST], p[9 * ST]);
}

// A at k step `step` from accumulator tiles c[n][4] of the same 16 rows:
// the values are rounded to the operand type here (P, P' and dS enter
// their products in the operands' dtype, as on the TPU).
template <int N>
__device__ __forceinline__ void a_from_acc(FragA32& a, const float (&c)[N][4],
                                           int step) {
  split(c[step][0], a.hi[0], a.lo[0]);  // row g,     k slot t
  split(c[step][2], a.hi[1], a.lo[1]);  // row g + 8, k slot t
  split(c[step][1], a.hi[2], a.lo[2]);  // row g,     k slot t + 4
  split(c[step][3], a.hi[3], a.lo[3]);  // row g + 8, k slot t + 4
}
template <int N>
__device__ __forceinline__ void a_from_acc(FragA16& a, const float (&c)[N][4],
                                           int step) {
  a.x[0] = pack(c[2 * step][0], c[2 * step][1]);
  a.x[1] = pack(c[2 * step][2], c[2 * step][3]);
  a.x[2] = pack(c[2 * step + 1][0], c[2 * step + 1][1]);
  a.x[3] = pack(c[2 * step + 1][2], c[2 * step + 1][3]);
}

// ---- products ---------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in split TF32: the two small terms first, then hi*hi
__device__ __forceinline__ void mma(float (&d)[4], const FragA32& a,
                                    const FragB32& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ void mma(float (&d)[4], const FragA16& a,
                                    const FragB16& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

// ---- stores -----------------------------------------------------------------

// two adjacent output columns (an accumulator's c[2h], c[2h + 1])
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 16-byte alignment of the operands that cp.async reads
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace tc
}  // namespace paddle_fa
