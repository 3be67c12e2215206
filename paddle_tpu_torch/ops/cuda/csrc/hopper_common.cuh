// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels on
// wgmma and TMA: the whole-block ones, the fused backward
// (flash_attention_bwd_fused.cu) and the whole-block forward
// (flash_attention_fwd_whole.cu), and the streamed ones for S or Sk above
// 128 (flash_attention_fwd_streamed.cu, flash_attention_bwd_streamed.cu):
// TMA copies between device memory and 128-byte-swizzled shared memory
// reported to mbarriers, plain bulk copies, the wgmma matrix descriptors
// and products (bf16 operands, f32 accumulators, m64n64k16), a row's dot
// product of bf16 chunks, and, on the host, the tensor maps of
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that no library links against libcuda. The f32 kernels
// (flash_attention_fwd_f32.cu, flash_attention_bwd_dkdv_f32.cu) take the
// TF32 products, the f32 tensor maps and the split-TF32 passes over
// shared memory from here too.
//
// Layout. A tile is [128 rows][64 bf16 columns] a region (16 KB, one TMA
// box), rows 128 bytes apart, the 16-byte chunk j of row r stored at chunk
// j ^ (r % 8): the 128-byte swizzle that TMA writes and wgmma reads. A
// head dim of 128 is two such regions side by side.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace paddle_fa {
namespace hopper {

constexpr int ROWS = 128;  // rows of a region: query rows or keys
constexpr int COLS = 64;   // bf16 columns of one 128-byte swizzled row
constexpr int REGION = ROWS * COLS * 2;  // one [128][64] bf16 box: 16 KB

// the C entry points' return code when no tensor map can be made (besides
// flash_common.cuh's codes)
constexpr int kErrTensorMap = -3;

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

// arrive once on `bar` (a consumer releasing a stage of a ring)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one box of a 3-D tensor map at (column c0, row c1, head c2)
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

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, reported to `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// one box from shared memory to a 3-D tensor map at (c0, c1, c2); what
// lies past the tensor's extent is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// close this thread's group of TMA stores and wait until their reads of
// shared memory are done (the block may then exit or reuse it)
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy stores to shared memory made visible to wgmma's reads and
// to TMA stores
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `threads` threads (a multiple of 32) under id `id` (1..15;
// 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// wait until at most N committed groups of products are in flight (the
// N youngest): an older group's accumulators may then be read
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving an accumulator across the asynchronous
// product that writes it (read before the commit, after the wait)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// ---- wgmma in TF32 (the f32 kernels' split-TF32 products) ------------------
//
// The .tf32 forms take no transpose: both shared-memory operands are read
// K-major (rows of 32 f32 along K, 128-byte swizzle, 8-row groups 1024 B
// apart: desc_k above, a k step of 8 adds 32 B to the start). A from
// registers is the mma.sync m16n8k8 .tf32 A layout per warp: a0 (row g,
// k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4).
// Each operand is a TF32 bit pattern (cvt.rna.tf32.f32).

#define PADDLE_ACC16(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define PADDLE_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d = A B + (accumulate ? d : 0), m64nNk8 TF32 (N = 32 or 64: N / 2
// accumulators a thread), both operands from shared memory. A chain that
// starts with accumulate = 0 needs no instruction to zero d: one would
// make ptxas serialize the products in flight beside it (C7515).
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t da,
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " PADDLE_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : PADDLE_ACC16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t da,
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PADDLE_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : PADDLE_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B + (accumulate ? d : 0), m64nNk8 TF32, A from registers (a0 ..
// a3 as above), B from shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db,
                                              int accumulate);
template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16], uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " PADDLE_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : PADDLE_ACC16(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PADDLE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : PADDLE_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

#undef PADDLE_ACC16
#undef PADDLE_D16
#undef PADDLE_ACC32
#undef PADDLE_D32

// d = A [64 rows][K] x B [N rows][K]^T in split TF32, uncommitted: the
// three products lo*hi + hi*lo + hi*hi of each k step of 8, all operands
// K-major in shared memory, 32-column regions `a_region` and `b_region`
// bytes apart (ah/al and bh/bl the addresses of the hi and lo copies'
// first rows). d's old values are not read.
template <int N, int K>
__device__ __forceinline__ void wgmma_tf32_split_ss(float (&d)[N / 2],
                                                    uint32_t ah, uint32_t al,
                                                    int a_region, uint32_t bh,
                                                    uint32_t bl,
                                                    int b_region) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const int oa = (kk / 4) * a_region + (kk % 4) * 32;
    const int ob = (kk / 4) * b_region + (kk % 4) * 32;
    wgmma_tf32_ss<N>(d, desc_k(al + oa), desc_k(bh + ob), kk > 0);
    wgmma_tf32_ss<N>(d, desc_k(ah + oa), desc_k(bl + ob), 1);
    wgmma_tf32_ss<N>(d, desc_k(ah + oa), desc_k(bh + ob), 1);
  }
}

// acc (+)= A B in split TF32, uncommitted: A [64][K] from registers, k
// step j's fragment hi[4 j .. 4 j + 3] / lo[...] in the accumulator's
// order (a0, a2, a1, a3: an accumulator read as A, see tf32_slot), B [N
// rows][K] K-major from shared memory, 32-column regions `b_region` bytes
// apart. With ZERO acc's old values are not read.
template <int N, int K, bool ZERO = false>
__device__ __forceinline__ void wgmma_tf32_split_rs(
    float (&acc)[N / 2], const uint32_t (&hi)[K / 2],
    const uint32_t (&lo)[K / 2], uint32_t bh, uint32_t bl, int b_region) {
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    const int ob = (j / 4) * b_region + (j % 4) * 32;
    wgmma_tf32_rs<N>(acc, lo[4 * j], lo[4 * j + 2], lo[4 * j + 1],
                     lo[4 * j + 3], desc_k(bh + ob), !(ZERO && j == 0));
    wgmma_tf32_rs<N>(acc, hi[4 * j], hi[4 * j + 2], hi[4 * j + 1],
                     hi[4 * j + 3], desc_k(bl + ob), 1);
    wgmma_tf32_rs<N>(acc, hi[4 * j], hi[4 * j + 2], hi[4 * j + 1],
                     hi[4 * j + 3], desc_k(bh + ob), 1);
  }
}

// ---- split TF32 in shared memory -------------------------------------------
//
// An f32 tile lands by TMA as 32-column regions of 128-byte rows with the
// 128-byte swizzle; its hi and lo copies keep that layout, so the split
// that keeps the layout is a pass over 16-byte chunks, hi written in place.
// A transposed copy puts element (row r, column c) at (c, tf32_slot(r)):
// within each 8-group of K the accumulator's column 2 t + e (the A
// fragment's k slot t + 4 e, tc_common.cuh's relabelling) sits where B's
// k slot t + 4 e is read.

constexpr int F32_COLS = 32;  // f32 columns of a 128-byte swizzled row

__device__ __forceinline__ int tf32_slot(int x) {
  return (x & ~7) | ((x & 7) >> 1) | ((x & 1) << 2);
}

// the byte offset of f32 element (row, col) in a region of 128-byte rows
// with the 128-byte swizzle (col < 32)
__device__ __forceinline__ int swz_f32(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// tf32(x) as cvt.rna.tf32.f32 rounds it (to nearest, ties away from zero,
// the low 13 bits cleared), bit for bit for every finite x, in two integer
// operations: the conversion unit runs cvt at a quarter of the integer
// rate, and a kernel that splits every operand and every probability spends
// more time there than on its products (an Inf or NaN x gives an Inf or
// NaN hi and a NaN lo, which carry through the product as cvt's would)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each a TF32 value: tc::split's result, without cvt
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// `bytes` of f32 at `src` split into hi (at `hi`, which may be `src`:
// in place) and lo (at `lo`), all three in one layout, spread over
// NTHREADS threads
template <int NTHREADS>
__device__ __forceinline__ void split_rows(const unsigned char* src,
                                           unsigned char* hi,
                                           unsigned char* lo, int bytes) {
  for (int c = threadIdx.x; c < bytes / 16; c += NTHREADS) {
    float4 l;
    const float4 h = split4(reinterpret_cast<const float4*>(src)[c], l);
    reinterpret_cast<float4*>(hi)[c] = h;
    reinterpret_cast<float4*>(lo)[c] = l;
  }
}

// d = A B^T as one committed group of products: A [64 rows][DP] and B [64
// rows][DP] both K-major in 64-column regions of shared memory (a and b
// the addresses of their first rows); d is zeroed first
template <int DP>
__device__ __forceinline__ void wgmma_abt(float (&d)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_acc(d);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * REGION + (kk % 4) * 32;
    wgmma_ss<0, 0>(d, desc_k(a + off), desc_k(b + off));
  }
  wg_commit();
}

// acc += A B, uncommitted: A [64][64] from registers (a[4 kk .. 4 kk + 3]
// at k step kk, the accumulator layout packed to bf16), B [64 rows][DP]
// read MN-major from 64-column regions (b the address of its first row)
template <int NC>
__device__ __forceinline__ void wgmma_rab(float (&acc)[NC][32],
                                          const uint32_t (&a)[16],
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs<1>(acc[c], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                  a[4 * kk + 3], desc_mn(b + c * REGION + 16 * kk * 128));
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x by the special-function unit (ex2.approx, what __expf runs on after
// its multiply by log2 e): the streamed kernels fold the softmax scale and
// log2 e into one multiply-add before it
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the byte offset of (row, column pair starting at 8 j + 2 t) in a
// [128][64] bf16 region with the 128-byte swizzle TMA and wgmma use: the
// 16-byte chunk j of a row is stored at chunk j ^ (row % 8)
__device__ __forceinline__ int swz(int row, int j, int t) {
  return row * 128 + ((j ^ (row & 7)) << 4) + 4 * t;
}

// the sum of the elementwise products of eight bf16 pairs, in f32 (two
// 16-byte chunks of a row: delta = rowsum(dO * O) chunk by chunk)
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

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
inline EncodeTiled encode_tiled() {
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
// columns x `box_rows` rows x 1 head, 128-byte swizzle; a load zero-fills
// what lies past D or past `rows`, a store leaves it unwritten.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int rows,
                       int D, int box_rows = ROWS) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a contiguous f32 [BH, rows, D] tensor in boxes of 32
// columns (128 bytes) x `box_rows` rows x 1 head, 128-byte swizzle; a load
// zero-fills what lies past D or past `rows`.
inline bool tensor_map_f32(CUtensorMap* map, const void* ptr, int BH,
                           int rows, int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4,
                                 (cuuint64_t)rows * D * 4};
  const cuuint32_t box[3] = {F32_COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace paddle_fa
