// Shared pieces of the port's attention kernels for Hopper (sm_90a):
// the tensor-core helpers (cp.async, ldmatrix, mma.sync m16n8k16 and
// wgmma, bf16 with fp32 accumulation) and the forward attention core,
// which kernel B2 (attn_block.cu) runs as its third step and kernel B3
// (attn.cu) runs on its own: one core, launched by launch_attn_any.
//
// The core computes exactly the TPU kernels' attention
// (pallas_attn.py::_attn_kernel, pallas_block.py:69-81): logits in fp32
// scaled by hd^-0.5 * log2(e), the exact row max, p = exp2(logit - max)
// in fp32 with its fp32 row sum, the unnormalised p cast to bf16 for the
// PV product (fp32 accumulation), and the division by the row sum after
// PV. An online-softmax rescale would round p at other values, so the
// max must be known before any p is formed. No N x N tensor reaches
// device memory.
//
// What bounds it on the H100: 4*B*N^2*C FLOP of QK^T and PV against q,
// k, v in and the output out, about as many microseconds of each at the
// model's shapes (PERF.md). Neither bounded the core it replaces
// (attn_onchip_kernel), which ran 5-10x over that bound: it
// parked a 64-query tile's fp32 logits in shared memory (144 KB at
// N = 576), which held each SM to one block, and each 64-query item read
// its head's K and V again (9 times per head at N = 576).
//
// What the design does about it:
//   attn_resident_kernel (N <= attn_resident_max_n<HD>(): 832 keys at
//     hd 64, 1728 at hd 32, 3520 at hd 16, 640 at hd 80, whose 160-byte
//     rows come as two swizzled parts, head_part): a block brings its head's
//     whole K and V into shared memory once, by TMA (a 3-D map over
//     [B, N, 3C] that zero-fills rows past N), a 64-key chunk per
//     mbarrier so the first chunk's products start before the last
//     arrives. Consumer warpgroups (2 or 4 a block, no producer warp)
//     each take their own 64-query tiles and keep no logits: sweep 1
//     runs QK^T chunk by chunk (SS wgmma) for the exact row max alone,
//     merged over a row's four threads; sweep 2 runs QK^T again, forms
//     p, its row sums and bf16(p) in registers and feeds them to PV as
//     the A operand of an RS wgmma (V read MN-major), issued together
//     with the next chunk's QK^T. That is 1.5x the products of computing
//     QK^T once, and it frees the shared memory that held the logits:
//     blocks run 2 to an SM where K, V and the Q tiles fit in half of it
//     (hd 32 at N = 576, hd 64 at N = 288), else 1 block of 4
//     warpgroups. Blocks are persistent, one per resident slot: block i
//     takes the i-th equal share of the (batch, head, 64-query tile)
//     sequence, so every SM gets the same number of tiles to within one,
//     and loads K and V once per head its share touches (a block-wide
//     barrier before the next head's K and V overwrite the last). Each
//     warpgroup's next Q tile comes by TMA into a second buffer while it
//     works on this one (into the same buffer, once its last QK^T is
//     done, where shared memory has no room for two).
//   attn_twopass_kernel (any N): the route for N past the resident
//     limit. mma.sync, 4 warps of 16 query rows, everything in
//     registers, two passes over the keys streamed from device memory:
//     the exact row max, then QK^T again for p and PV.
// Both keep Q, the logits and p out of device memory; only the order of
// the fp32 sums differs between them.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (cuTensorMapEncodeTiled is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int AQ = 64;  // queries per attention block
constexpr int AK = 64;  // keys per chunk
constexpr int ATTN_THREADS = 128;
constexpr int ATTN_MAX_WGS = 4;  // consumer warpgroups of a resident block, at most

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// 16 bytes global -> shared, zero-filled when !pred (src is not read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a . b for one m16n8k16 tile: a row-major 16x16, b "col" 16x8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma (warpgroup MMA, sm_90a) building blocks, inline PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulator registers at this point of the program, so the
// compiler moves no read or write of them across an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A operands of an RS wgmma: kept live and
// unchanged until this point, so the compiler reuses none of them while
// the wgmma may still read them.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[i][x])::"memory");
}
// 2^x on the special function unit (ex2.approx, relative error about
// 2^-22; results below 2^-126 flush to 0, exp2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Writes by this thread's generic proxy (st.shared, cp.async) become
// visible to the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = A . B^T + (scale_d ? d : 0), m64n64k16, A and B from shared
// memory (K-major).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B, m64n64k16, A (16 rows per warp, bf16 pairs in the mma
// A-fragment layout) from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n32k16, A (16 rows per warp, bf16 pairs in the mma
// A-fragment layout) from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n16k16, A (16 rows per warp, bf16 pairs in the mma
// A-fragment layout) from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- mbarrier and TMA (inline PTX) ----

// Barrier `id` (1..15) over `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box of `map` at (c0 = inner/K, c1 = row) into shared memory at
// `dst`, completing `bar`'s transaction count. Out-of-range elements are
// written as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}


// The same for a 3-D map at (c0, c1, c2).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime already
// loaded, looked up once per process; null where it has none.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The wgmma descriptor of a 64-row bf16 tile with rows of HD * 2 bytes
// (128, 64 or 32) in TMA's matching 128/64/32-byte swizzle (the 16-byte
// chunk c of row r sits at chunk c ^ ((r * rowbytes >> 7) % (HD / 8))),
// 1024-byte aligned: start address >> 4, both byte offsets one 8-row
// swizzle atom (K-major reads ignore the leading one; MN-major reads of V
// take the whole row as the one atom along N), layout type 1/2/3 for the
// 128/64/32-byte swizzle. A k16 step along a K-major row adds 32 bytes
// (2 in the address field).
template <int HD>
__device__ __forceinline__ uint64_t swz_desc(uint32_t addr) {
  static_assert(HD == 16 || HD == 32 || HD == 64, "one swizzled part is 16, 32 or 64 wide");
  constexpr uint64_t atom = (8 * HD * 2) >> 4;
  constexpr uint64_t layout = HD == 64 ? 1 : HD == 32 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (atom << 16) | (atom << 32) | (layout << 62);
}

// A head's 64-row tile in shared memory. At head dim 16, 32 or 64 it is
// one part, rows of HD * 2 bytes in the matching swizzle. A 160-byte row
// (head dim 80) fits no swizzle, so an hd-80 tile is two parts, one after
// the other: columns 0-63 (8 KB, 128-byte swizzle), then 64-79 (2 KB,
// 32-byte swizzle); both stay 1024-byte aligned, and the tile is still
// 64 * HD * 2 bytes. head_part<HD>() is the first part's width.
template <int HD>
__host__ __device__ constexpr int head_part() {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 80, "head dim 16, 32, 64 or 80");
  return HD == 80 ? 64 : HD;
}

// The descriptor of k16 step kk along the head dim of a K-major tile
// (QK^T's operands, kk < HD / 16; unrolled, so the branch is resolved at
// compile time).
template <int HD>
__device__ __forceinline__ uint64_t head_k_desc(uint32_t tile, int kk) {
  constexpr int A = head_part<HD>();
  if constexpr (A == HD) {
    return swz_desc<HD>(tile) + 2 * kk;
  } else {
    return kk < A / 16 ? swz_desc<A>(tile) + 2 * kk
                       : swz_desc<HD - A>(tile + 64 * A * 2) + 2 * (kk - A / 16);
  }
}

template <int HD>
__device__ __forceinline__ void wgmma_rs_part(float (&d)[HD / 2], const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_m64n64(d, a, db);
  else if constexpr (HD == 32)
    wgmma_rs_m64n32(d, a, db);
  else
    wgmma_rs_m64n16(d, a, db);
}

// d += A . B for rows 16kk .. 16kk + 15 of `tile` (the products' k16 step)
// read MN-major, the head dim along N (PV and its kind). An hd-80 tile
// takes an n64 and an n16 product, into d[0..31] and d[32..39]: together
// the n80 accumulator layout.
template <int HD>
__device__ __forceinline__ void wgmma_rs_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                            uint32_t tile, int kk) {
  constexpr int A = head_part<HD>();
  if constexpr (A == HD) {
    wgmma_rs_part<HD>(d, a, swz_desc<HD>(tile + kk * 16 * HD * 2));
  } else {
    wgmma_rs_part<A>(*reinterpret_cast<float(*)[A / 2]>(&d[0]), a,
                     swz_desc<A>(tile + kk * 16 * A * 2));
    wgmma_rs_part<HD - A>(*reinterpret_cast<float(*)[(HD - A) / 2]>(&d[A / 2]), a,
                          swz_desc<HD - A>(tile + 64 * A * 2 + kk * 16 * (HD - A) * 2));
  }
}

template <int HD>
__host__ __device__ constexpr size_t attn_smem_bytes() {
  return (size_t)(AQ + 4 * AK) * (HD + 8) * sizeof(bf16);  // Q, 2 x (K, V)
}

// Shared memory of a resident block (attn_resident_kernel) for nch
// 64-key chunks and wgs warpgroups with qbuf Q buffers each: 1 KB of
// alignment slack, the Q tiles, K and V of the head, and the mbarriers
// (one per K chunk, one per V chunk, two per warpgroup's Q).
template <int HD>
__host__ __device__ constexpr size_t attn_resident_smem_bytes(int nch, int wgs, int qbuf) {
  return 1024 + (size_t)(wgs * qbuf + 2 * nch) * AK * HD * sizeof(bf16) +
         (size_t)(2 * nch + 2 * wgs) * 8;
}

// x [B, N, width] bf16 as a 3-D tensor map read in boxes of 1 x 64 rows x
// W columns in the W*2-byte swizzle that swz_desc describes; rows past N
// of a batch element read as 0.
template <int W>
cudaError_t encode_rows_map(CUtensorMap* map, const bf16* x, int B, int N, int width) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * sizeof(bf16),
                                 (cuuint64_t)N * width * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)AK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = W == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor maps that bring a head's 64-row tile (one head of 64 tokens)
// in its parts (head_part): one map, or two at head dim 80. A kernel takes
// them as one __grid_constant__ parameter.
template <int HD>
struct HeadMaps {
  CUtensorMap part[HD == head_part<HD>() ? 1 : 2];
};

template <int HD>
cudaError_t make_rows_map(HeadMaps<HD>* maps, const bf16* x, int B, int N, int width) {
  constexpr int A = head_part<HD>();
  const cudaError_t err = encode_rows_map<A>(&maps->part[0], x, B, N, width);
  if constexpr (A == HD) {
    return err;
  } else {
    if (err != cudaSuccess) return err;
    return encode_rows_map<HD - A>(&maps->part[1], x, B, N, width);
  }
}

// qkv [B, N, 3C] in boxes of one head's q, k or v for 64 tokens.
template <int HD>
cudaError_t make_qkv_map(HeadMaps<HD>* maps, const bf16* qkv, int B, int N, int C) {
  return make_rows_map<HD>(maps, qkv, B, N, 3 * C);
}

// The tile of a head's 64 tokens from row `row` of batch element `b`, its
// columns from `col`, into `dst` (1024-byte aligned), in its parts:
// 64 * HD * 2 bytes in all on `bar`.
template <int HD>
__device__ __forceinline__ void tma_load_head(uint32_t dst, const HeadMaps<HD>& maps,
                                              uint32_t bar, int col, int row, int b) {
  constexpr int A = head_part<HD>();
  tma_load_3d(dst, &maps.part[0], bar, col, row, b);
  if constexpr (A != HD) tma_load_3d(dst + 64 * A * 2, &maps.part[1], bar, col + A, row, b);
}

// An attribute of the current device, read once per process per
// attribute.
template <cudaDeviceAttr A>
inline int device_attr() {
  static const int n = []() {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, A, dev);
    return v;
  }();
  return n;
}

// The current device's SM count.
inline int sm_count() {
  const int n = device_attr<cudaDevAttrMultiProcessorCount>();
  return n > 0 ? n : 1;
}

// qkv [B*N, 3C] (q | k | v, head h at columns h*HD of each) ->
// att [B*N, C] with N <= attn_resident_max_n<HD>(). Persistent: block i
// of G takes tiles [i*tiles/G, (i+1)*tiles/G) of the sequence of `tiles`
// (batch, head, 64-query tile) items, tile t being query tile t % nq of
// head t / nq (= b * H + h); warpgroup w of the block takes its tiles
// t_begin + w, t_begin + w + wgs, ... (wgs = blockDim.x / 128). Warp w
// of a warpgroup holds query rows 16w + lane/4 (+ 8), at columns
// 2*(lane%4) + {0, 1} of every 8-wide tile (the wgmma accumulator
// layout). `map` is qkv as [B][N][3C] in boxes of 1 x 64 x HD with the
// HD*2-byte swizzle, so rows past N come in as zeros. qbuf (1 or 2) is
// the number of Q buffers of each warpgroup.
template <int HD>
__global__ void __launch_bounds__(128 * ATTN_MAX_WGS, 1) attn_resident_kernel(
    const __grid_constant__ HeadMaps<HD> map, bf16* __restrict__ att, int N, int C, int H,
    int tiles, float scale, int qbuf) {
  constexpr uint32_t TILE = AK * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-aligned, as the swizzle needs
  const int wgs = blockDim.x >> 7;
  const int nch = (N + AK - 1) / AK, nq = (N + AQ - 1) / AQ;
  const uint32_t q_s = base;                      // [wgs][qbuf] Q tiles
  const uint32_t k_s = q_s + wgs * qbuf * TILE;   // [nch] K chunks
  const uint32_t v_s = k_s + nch * TILE;          // [nch] V chunks
  const uint32_t kbar = v_s + nch * TILE;         // [nch]
  const uint32_t vbar = kbar + 8 * nch;           // [nch]
  const uint32_t qbar = vbar + 8 * nch;           // [wgs][2]

  // The warp index through a shuffle, so the compiler sees it (and the
  // warpgroup index) uniform across the warp: wgmma on a path it cannot
  // prove uniform is serialized.
  const int tid = threadIdx.x, lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, qw = warp & 3, t4 = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int t_begin = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  const bool ragged = N % AK != 0;  // the last chunk holds keys past N

  if (tid == 0) {
    for (int c = 0; c < nch; ++c) {
      mbar_init(kbar + 8 * c, 1);
      mbar_init(vbar + 8 * c, 1);
    }
    for (int i = 0; i < 2 * wgs; ++i) mbar_init(qbar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t's Q into the buffer of this warpgroup's j-th tile.
  auto load_q = [&](int t, int j) {
    const int bh = t / nq, buf = j % qbuf;
    const uint32_t bar = qbar + 8 * (wg * 2 + buf);
    mbar_expect_tx(bar, TILE);
    tma_load_head<HD>(q_s + (wg * qbuf + buf) * TILE, map, bar, (bh % H) * HD, (t % nq) * AQ,
                      bh / H);
  };
  // Head bh's K and V, a chunk per mbarrier, K first.
  auto load_kv = [&](int bh) {
    const int h = bh % H, b = bh / H;
    for (int c = 0; c < nch; ++c) {
      mbar_expect_tx(kbar + 8 * c, TILE);
      tma_load_head<HD>(k_s + c * TILE, map, kbar + 8 * c, C + h * HD, c * AK, b);
    }
    for (int c = 0; c < nch; ++c) {
      mbar_expect_tx(vbar + 8 * c, TILE);
      tma_load_head<HD>(v_s + c * TILE, map, vbar + 8 * c, 2 * C + h * HD, c * AK, b);
    }
  };
  if (leader && t_begin + wg < t_end) load_q(t_begin + wg, 0);
  if (tid == 0) load_kv(t_begin / nq);

  int j = 0;  // tiles of this warpgroup so far
  for (int bh = t_begin / nq, seg = 0; bh * nq < t_end; ++bh, ++seg) {
    if (seg > 0) {
      __syncthreads();  // every warpgroup is done with the last head's K and V
      if (tid == 0) load_kv(bh);
    }
    const uint32_t par = seg & 1;
    const int lo = max(t_begin, bh * nq), hi = min(t_end, (bh + 1) * nq);
    int t = lo + ((t_begin + wg - lo) % wgs + wgs) % wgs;  // this warpgroup's first tile >= lo
    for (; t < hi; t += wgs, ++j) {
      const int buf = j % qbuf;
      const bool next = t + wgs < t_end;
      if (qbuf == 2 && next) {
        // The other buffer was last read by this warpgroup's previous
        // tile; the barrier makes sure all four of its warps are past it.
        named_bar_sync(1 + wg, 128);
        if (leader) load_q(t + wgs, j + 1);
      }
      mbar_wait(qbar + 8 * (wg * 2 + buf), (j / qbuf) & 1);
      const uint32_t qt = q_s + (wg * qbuf + buf) * TILE;

      // S = Q K_c^T for chunk c into d (issued and committed, not waited).
      auto s_issue = [&](float (&d)[32], int c) {
        mbar_wait(kbar + 8 * c, par);
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_m64n64(d, head_k_desc<HD>(qt, kk), head_k_desc<HD>(k_s + c * TILE, kk),
                          kk > 0);
        wgmma_commit();
      };
      // Sweep 1: the exact row max of the raw products (scale > 0 keeps
      // their order, so max(s) * scale is the max of the scaled logits),
      // -inf past N. One chunk's product per wait: reading one product
      // while the next is in flight makes ptxas serialize every wgmma of
      // the kernel, and two products per wait spill at hd 64.
      float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float sa[32];
      for (int c = 0; c < nch; ++c) {
        s_issue(sa, c);
        wgmma_wait<0>();
        fence_regs(sa);
        const bool mask = ragged && c == nch - 1;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = c * AK + (i >> 2) * 8 + t4 * 2 + (i & 1);
          const float v = mask && key >= N ? -CUDART_INF_F : sa[i];
          mrow[(i >> 1) & 1] = fmaxf(mrow[(i >> 1) & 1], v);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 1));
        mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 2));
        mrow[hh] *= scale;
      }

      // Sweep 2: S again; p = exp2(s * scale - max) in fp32, s += p,
      // acc += bf16(p) . V_c, with chunk c + 1's S issued behind the PV.
      float srow[2] = {0.f, 0.f};
      float o[HD / 2];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
      s_issue(sa, 0);
      wgmma_wait<0>();
      for (int c = 0; c < nch; ++c) {
        fence_regs(sa);
        const bool mask = ragged && c == nch - 1;
        uint32_t pa[AK / 16][4];
#pragma unroll
        for (int kk = 0; kk < AK / 16; ++kk) {
          float p[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = kk * 8 + e, key = c * AK + (i >> 2) * 8 + t4 * 2 + (i & 1);
            const float l = mask && key >= N ? -CUDART_INF_F : sa[i] * scale;
            p[e] = ex2(l - mrow[(e >> 1) & 1]);
            srow[(e >> 1) & 1] += p[e];
          }
          pa[kk][0] = pack_bf16x2(p[0], p[1]);
          pa[kk][1] = pack_bf16x2(p[2], p[3]);
          pa[kk][2] = pack_bf16x2(p[4], p[5]);
          pa[kk][3] = pack_bf16x2(p[6], p[7]);
        }
        if (qbuf == 1 && next && c == nch - 1) {
          // Q's last product is done in all four warps: the next tile's Q
          // may take its buffer.
          named_bar_sync(1 + wg, 128);
          if (leader) load_q(t + wgs, j + 1);
        }
        mbar_wait(vbar + 8 * c, par);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < AK / 16; ++kk)
          wgmma_rs_pv<HD>(o, pa[kk], v_s + c * TILE, kk);
        if (c + 1 < nch)
          s_issue(sa, c + 1);  // commits the PV with it
        else
          wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
      }

#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        srow[hh] += __shfl_xor_sync(0xffffffffu, srow[hh], 1);
        srow[hh] += __shfl_xor_sync(0xffffffffu, srow[hh], 2);
      }
      const int q0 = (t % nq) * AQ, b = bh / H, h = bh % H;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int n = q0 + qw * 16 + (lane >> 2) + hh * 8;
        if (n >= N) continue;
        bf16* out = att + ((size_t)b * N + n) * C + h * HD;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          __nv_bfloat162 v;
          v.x = f2bf(o[4 * d + 2 * hh] / srow[hh]);
          v.y = f2bf(o[4 * d + 2 * hh + 1] / srow[hh]);
          *reinterpret_cast<__nv_bfloat162*>(out + d * 8 + t4 * 2) = v;
        }
      }
    }
  }
}

// The two-pass route for any N: grid (ceil(N/64), H, B); 4 warps, 16
// query rows each, in the same accumulator layout.
template <int HD>
__global__ void __launch_bounds__(ATTN_THREADS) attn_twopass_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ att, int N, int C,
    float scale) {
  constexpr int LDH = HD + 8;
  constexpr int HV = HD / 8;  // 16-byte vectors per head row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + AQ * LDH;   // [2][AK][LDH]
  bf16* Vs = Ks + 2 * AK * LDH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * row_stride;
  const int qcol = h * HD, kcol = C + h * HD, vcol = 2 * C + h * HD;
  const int nchunks = (N + AK - 1) / AK;
  const int steps = 2 * nchunks;  // pass 1 (K only), then pass 2 (K, V)

  for (int i = tid; i < AQ * HV; i += ATTN_THREADS) {
    const int r = i / HV, c = (i % HV) * 8, n = q0 + r;
    const bool p = n < N;
    cp_async16(Qs + r * LDH + c, p ? base + (size_t)n * row_stride + qcol + c : qkv, p);
  }
  auto load = [&](int t) {
    const bool with_v = t >= nchunks;
    const int k0 = (with_v ? t - nchunks : t) * AK;
    bf16* ks = Ks + (t & 1) * AK * LDH;
    bf16* vs = Vs + (t & 1) * AK * LDH;
    for (int i = tid; i < AK * HV; i += ATTN_THREADS) {
      const int r = i / HV, c = (i % HV) * 8, n = k0 + r;
      const bool p = n < N;
      const bf16* row = base + (size_t)n * row_stride;
      cp_async16(ks + r * LDH + c, p ? row + kcol + c : qkv, p);
      if (with_v) cp_async16(vs + r * LDH + c, p ? row + vcol + c : qkv, p);
    }
  };
  load(0);
  cp_async_commit();

  const int t4 = lane & 3;
  uint32_t qf[HD / 16][4];
  float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float srow[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  for (int t = 0; t < steps; ++t) {
    // Step t + 1's buffer was last read in step t - 1, which every warp
    // has finished (barrier at the end of the loop).
    if (t + 1 < steps) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LDH + kk * 16 + (lane >> 4) * 8);
    }
    const bool second = t >= nchunks;
    const int k0 = (second ? t - nchunks : t) * AK;
    const bf16* ks = Ks + (t & 1) * AK * LDH;
    const bf16* vs = Vs + (t & 1) * AK * LDH;

    // Scaled fp32 logits of this warp's 16 rows x 64 keys; -inf past N.
    float sc[AK / 8][4];
#pragma unroll
    for (int j = 0; j < AK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < AK / 16; ++j2) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma16816(sc[2 * j2], qf[kk], r[0], r[1]);
        mma16816(sc[2 * j2 + 1], qf[kk], r[2], r[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < AK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t4 * 2 + (e & 1);
        sc[j][e] = key < N ? sc[j][e] * scale : -CUDART_INF_F;
      }

    if (!second) {
      // Pass 1: running row max; the 4 threads of a row agree at the end.
#pragma unroll
      for (int j = 0; j < AK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mrow[e >> 1] = fmaxf(mrow[e >> 1], sc[j][e]);
      if (t == nchunks - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 1));
          mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 2));
        }
      }
    } else {
      // Pass 2: p = exp2(l - max) in fp32, s += p, acc += bf16(p) . V.
#pragma unroll
      for (int j = 0; j < AK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[j][e] - mrow[e >> 1]);
          srow[e >> 1] += p;
          sc[j][e] = p;
        }
#pragma unroll
      for (int kk = 0; kk < AK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
        };
#pragma unroll
        for (int d2 = 0; d2 < HD / 16; ++d2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                                   d2 * 16 + (lane >> 4) * 8);
          mma16816(o[2 * d2], pa, r[0], r[1]);
          mma16816(o[2 * d2 + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    srow[hh] += __shfl_xor_sync(0xffffffffu, srow[hh], 1);
    srow[hh] += __shfl_xor_sync(0xffffffffu, srow[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = q0 + warp * 16 + (lane >> 2) + hh * 8;
    if (n >= N) continue;
    bf16* out = att + ((size_t)b * N + n) * C + h * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      __nv_bfloat162 v;
      v.x = f2bf(o[d][2 * hh] / srow[hh]);
      v.y = f2bf(o[d][2 * hh + 1] / srow[hh]);
      *reinterpret_cast<__nv_bfloat162*>(out + d * 8 + t4 * 2) = v;
    }
  }
}

// How launch_attn runs the core for one call: the resident kernel with
// `wgs` warpgroups and `qbuf` Q buffers each, `blocks` persistent blocks
// (`per_sm` of them resident on an SM, by shared memory), `smem` bytes a
// block; or the two-pass kernel (resident 0) past the resident limit.
struct AttnPlan {
  int resident, wgs, qbuf, per_sm, blocks;
  size_t smem;
};

// The first of these that fits the card's shared memory: 2 warpgroups
// with 2 (else 1) Q buffers at 2 blocks an SM, then 4 warpgroups with 2
// (else 1) at 1 block an SM, then 2 warpgroups with 1.
template <int HD>
AttnPlan attn_plan(int B, int N, int H) {
  static constexpr int kConfigs[5][3] = {{2, 2, 2}, {2, 1, 2}, {4, 2, 1}, {4, 1, 1}, {2, 1, 1}};
  const size_t sm_smem = device_attr<cudaDevAttrMaxSharedMemoryPerMultiprocessor>();
  const size_t block_smem = device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>();
  const size_t reserved = device_attr<cudaDevAttrReservedSharedMemoryPerBlock>();
  const int nch = (N + AK - 1) / AK, nq = (N + AQ - 1) / AQ;
  const long long tiles = (long long)nq * H * B;
  for (const auto& k : kConfigs) {
    const size_t smem = attn_resident_smem_bytes<HD>(nch, k[0], k[1]);
    if (smem > block_smem || k[2] * (smem + reserved) > sm_smem) continue;
    const long long slots = (long long)sm_count() * k[2];
    return {1, k[0], k[1], k[2], (int)(tiles < slots ? tiles : slots), smem};
  }
  return {0, 1, 0, 0, (int)tiles, attn_smem_bytes<HD>()};
}

// The largest N the resident kernel takes on an H100 (228 KB of shared
// memory an SM, 227 KB a block, 1 KB reserved a block): 832 at hd 64, 640
// at hd 80.
template <int HD>
constexpr int attn_resident_max_n() {
  int nch = 1;
  while (attn_resident_smem_bytes<HD>(nch + 1, 2, 1) <= 232448) ++nch;
  return nch * AK;
}

template <int HD>
cudaError_t launch_attn(const bf16* qkv, bf16* att, int B, int N, int C, int H,
                        float scale, cudaStream_t stream) {
  if (N <= 0) return cudaErrorInvalidValue;
  const AttnPlan p = attn_plan<HD>(B, N, H);
  if (p.resident) {
    static const cudaError_t attr = [] {
      const cudaError_t e = cudaFuncSetAttribute(
          attn_resident_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>());
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(attn_resident_kernel<HD>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared);
    }();
    if (attr != cudaSuccess) return attr;
    HeadMaps<HD> map;
    const cudaError_t err = make_qkv_map<HD>(&map, qkv, B, N, C);
    if (err != cudaSuccess) return err;
    const int nq = (N + AQ - 1) / AQ;
    attn_resident_kernel<HD><<<p.blocks, 128 * p.wgs, p.smem, stream>>>(
        map, att, N, C, H, nq * H * B, scale, p.qbuf);
    return cudaGetLastError();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_twopass_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_smem_bytes<HD>());
  if (attr != cudaSuccess) return attr;
  attn_twopass_kernel<HD><<<dim3((N + AQ - 1) / AQ, H, B), ATTN_THREADS, attn_smem_bytes<HD>(),
                            stream>>>(qkv, att, N, C, scale);
  return cudaGetLastError();
}

// The attention core for a head dim of 16, 32, 64 or 80: K and V resident in
// shared memory up to attn_resident_max_n<HD>() keys, two passes past it.
inline cudaError_t launch_attn_any(const bf16* qkv, bf16* att, int B, int N, int C,
                                   int H, float scale, cudaStream_t stream) {
  switch (C / H) {
    case 16: return launch_attn<16>(qkv, att, B, N, C, H, scale, stream);
    case 32: return launch_attn<32>(qkv, att, B, N, C, H, scale, stream);
    case 64: return launch_attn<64>(qkv, att, B, N, C, H, scale, stream);
    case 80: return launch_attn<80>(qkv, att, B, N, C, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The plan launch_attn_any follows for these sizes (resident 0 and the
// two-pass kernel's grid size in `blocks` past the limit; wgs 0 for a
// head dim it does not take).
inline AttnPlan attn_plan_any(int B, int N, int C, int H) {
  switch (C / H) {
    case 16: return attn_plan<16>(B, N, H);
    case 32: return attn_plan<32>(B, N, H);
    case 64: return attn_plan<64>(B, N, H);
    case 80: return attn_plan<80>(B, N, H);
    default: return {0, 0, 0, 0, 0, 0};
  }
}

inline int attn_resident_max_n_any(int hd) {
  switch (hd) {
    case 16: return attn_resident_max_n<16>();
    case 32: return attn_resident_max_n<32>();
    case 64: return attn_resident_max_n<64>();
    case 80: return attn_resident_max_n<80>();
    default: return 0;
  }
}

}  // namespace
