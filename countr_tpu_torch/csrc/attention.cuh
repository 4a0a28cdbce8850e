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
// What bounds it on the H100: tensor-core operations, 4*B*N^2*C FLOP
// (QK^T and PV), against q, k, v in and the output out. The product
// count and the tensor-core instruction are what the design can change:
//   attn_onchip_kernel (N <= ATTN_ONCHIP_MAX_N = 576): QK^T once per key
//     block. Persistent blocks, one per SM, walk the (batch, head,
//     64-query tile) items: three consumer warpgroups, one per third of
//     the 64-key chunks, and a producer warp. Pass 1 computes each
//     chunk's logits with one wgmma per 16 of the head dim (Q and K from
//     swizzled shared memory), keeps the running row max in registers and
//     parks the scaled fp32 logits in shared memory, each thread its own
//     fragment (conflict-free, no barrier to read them back); 64 x 576
//     fp32 logits are 144 KB of the 227. The parts' maxima meet in shared
//     memory. Pass 2 reads the parked logits, forms p and the row sums,
//     and runs bf16(p) . V as wgmmas with p from registers; the parts' PV
//     partials and row sums are added in fp32, in part order, and the
//     first part stores bf16(acc / s). The producer brings each item's Q
//     (once the previous item's pass 1 is over), then its K and V chunks
//     by TMA (a 3-D map over [B, N, 3C] that zero-fills rows past N) into
//     a 3-buffer ring on mbarriers, without a break between items; each
//     consumer warp frees a buffer as soon as its wgmma has read it, so no
//     step waits on a block-wide barrier.
//     Why this shape: the parked logits hold the SM to one block, so no
//     other block hides its latencies. Fed by a cp.async ring behind a
//     barrier per step, it ran about as fast with its products taken out
//     as with them: the K/V stream, not the tensor cores, set its pace.
//     mma.sync in place of wgmma, or two parts (10 steps at N = 576)
//     instead of three (6), were slower still. The tensor cores do not
//     bound it now either: with its arithmetic taken out, the TMA-fed
//     kernel (before it became persistent) kept most of its time, and a
//     deeper ring at hd 32 changed nothing. Each 64-query item reads its
//     head's K and V again, the traffic a larger query tile would cut if
//     the logits of more rows fitted on chip.
//   attn_twopass_kernel (any N): the earlier route for N past the limit.
//     mma.sync, 4 warps of 16 query rows, everything in registers, two
//     passes over the keys: the exact row max, then QK^T again for p and
//     PV, so 1.5x the products.
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
constexpr int ATTN_PARTS = 3;  // warpgroups of the on-chip kernel, one per third of the keys
constexpr int ATTN_ONCHIP_THREADS = 128 * ATTN_PARTS + 32;  // + one producer warp
constexpr int ATTN_ONCHIP_MAX_N = 576;  // 9 chunks, 3 per warpgroup: 144 KB of logits

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
// Writes by this thread's generic proxy (st.shared, cp.async) become
// visible to the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A . B^T, m64n64k16, A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
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
  constexpr uint64_t atom = (8 * HD * 2) >> 4;
  constexpr uint64_t layout = HD == 64 ? 1 : HD == 32 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (atom << 16) | (atom << 32) | (layout << 62);
}

template <int HD>
__device__ __forceinline__ void wgmma_rs_pv(float (&d)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_m64n64(d, a, db);
  else if constexpr (HD == 32)
    wgmma_rs_m64n32(d, a, db);
  else
    wgmma_rs_m64n16(d, a, db);
}

template <int HD>
__host__ __device__ constexpr size_t attn_smem_bytes() {
  return (size_t)(AQ + 4 * AK) * (HD + 8) * sizeof(bf16);  // Q, 2 x (K, V)
}

constexpr int ATTN_RING = 3;  // buffers of the on-chip kernel's K/V ring

// 1 KB of alignment slack, the Q tile, the ring of 3 buffers x 3 parts
// of 64-row tiles, 3 x 64 row maxima, 2 x 64 row sums, 12 warps x hc
// chunks x 32 lanes x 32 fp32 logits, and 2 x 3 + 2 mbarriers: 231,744
// bytes at HD = 64 and hc = 3.
template <int HD>
__host__ __device__ constexpr size_t attn_onchip_smem_bytes(int hc) {
  return 1024 + (size_t)(1 + ATTN_PARTS * ATTN_RING) * AK * HD * sizeof(bf16) +
         (2 * ATTN_PARTS - 1) * AQ * sizeof(float) +
         (size_t)4 * ATTN_PARTS * hc * 32 * 32 * sizeof(float) + (2 * ATTN_RING + 2) * 8;
}

// x [B, N, width] bf16 as a 3-D tensor map read in boxes of 1 x 64 rows x
// HD columns (one head of 64 tokens) in the HD*2-byte swizzle that
// swz_desc describes; rows past N of a batch element read as 0.
template <int HD>
cudaError_t make_rows_map(CUtensorMap* map, const bf16* x, int B, int N, int width) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * sizeof(bf16),
                                 (cuuint64_t)N * width * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)HD, (cuuint32_t)AK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = HD == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// qkv [B, N, 3C] in boxes of one head's q, k or v for 64 tokens.
template <int HD>
cudaError_t make_qkv_map(CUtensorMap* map, const bf16* qkv, int B, int N, int C) {
  return make_rows_map<HD>(map, qkv, B, N, 3 * C);
}

// The current device's SM count, read once per process.
inline int sm_count() {
  static const int n = []() {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// qkv [B*N, 3C] (q | k | v, head h at columns h*HD of each) ->
// att [B*N, C] with N <= ATTN_ONCHIP_MAX_N. Persistent: block b takes the
// (64-query tile, head, batch) items b, b + gridDim.x, ..., and its
// producer warp streams them without a break, so no item starts cold.
// ATTN_PARTS consumer warpgroups, one per part of the key chunks; chunk i
// of part f is key chunk f*hc + i (hc = ceil(chunks / ATTN_PARTS)). Warp
// w of a warpgroup holds query rows 16w + lane/4 (+ 8), at columns
// 2*(lane%4) + {0, 1} of every 8-wide tile (the wgmma and mma accumulator
// layout). `map` is qkv as [B][N][3C] in boxes of 1 x 64 x HD with the
// HD*2-byte swizzle, so rows past N come in as zeros. QK^T is an SS wgmma
// (Q and the K chunk from shared memory), PV an RS wgmma (bf16 p from
// registers, V from shared memory read MN-major).
template <int HD>
__global__ void __launch_bounds__(ATTN_ONCHIP_THREADS, 1) attn_onchip_kernel(
    const __grid_constant__ CUtensorMap map, bf16* __restrict__ att, int B, int N, int C, int H,
    float scale) {
  constexpr uint32_t RB = HD * 2, TILE = AK * RB;
  constexpr int CONSUMERS = 128 * ATTN_PARTS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // 1024-aligned
  const uint32_t q_s = smem_u32(sm);
  unsigned char* ring = sm + TILE;  // [ATTN_RING buffers][ATTN_PARTS] tiles
  float* Mx = reinterpret_cast<float*>(sm + (1 + ATTN_PARTS * ATTN_RING) * TILE);  // [parts][AQ]
  float* Ms = Mx + ATTN_PARTS * AQ;  // [parts - 1][AQ] row sums handed to the first part
  float* Sp = Ms + (ATTN_PARTS - 1) * AQ;  // [warps][hc][32 registers][32 lanes]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qw = warp & 3, part = warp >> 2, t4 = lane & 3;
  const int nchunks = (N + AK - 1) / AK, hc = (nchunks + ATTN_PARTS - 1) / ATTN_PARTS;
  const int steps = 2 * hc;  // per item: pass 1 (K), then pass 2 (V)
  const int nq = (N + AQ - 1) / AQ, items = nq * H * B;
  const int mine_items = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // [ATTN_RING] full, [ATTN_RING] empty; Q's full and empty
  const uint32_t full_bar = smem_u32(Sp + (size_t)4 * ATTN_PARTS * hc * 32 * 32);
  const uint32_t empty_bar = full_bar + 8 * ATTN_RING, qfull_bar = empty_bar + 8 * ATTN_RING;
  const uint32_t qempty_bar = qfull_bar + 8;
  // Item k of this block: its first query, head and batch element.
  auto item = [&](int k, int& q0, int& h, int& b) {
    const int it = blockIdx.x + k * gridDim.x;
    q0 = (it % nq) * AQ;
    h = (it / nq) % H;
    b = it / (nq * H);
  };

  if (tid == 0) {
    for (int r = 0; r < ATTN_RING; ++r) {
      mbar_init(full_bar + 8 * r, 1);
      mbar_init(empty_bar + 8 * r, ATTN_PARTS * 4);  // every consumer warp
    }
    mbar_init(qfull_bar, 1);
    mbar_init(qempty_bar, ATTN_PARTS * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == ATTN_PARTS * 4) {
    // Producer warp: one thread streams each item's Q (once the previous
    // item's pass 1 is over), then its K and V chunks of every part, a
    // ring buffer per step, as soon as the buffer is free.
    if (lane == 0) {
      for (int k = 0; k < mine_items; ++k) {
        int q0, h, b;
        item(k, q0, h, b);
        mbar_wait(qempty_bar, (k & 1) ^ 1);
        mbar_expect_tx(qfull_bar, TILE);
        tma_load_3d(q_s, &map, qfull_bar, h * HD, q0, b);
        for (int t = 0; t < steps; ++t) {
          const int g = k * steps + t, r = g % ATTN_RING;
          mbar_wait(empty_bar + 8 * r, ((g / ATTN_RING) & 1) ^ 1);
          const bool v = t >= hc;
          const int i = v ? t - hc : t, col = (v ? 2 * C : C) + h * HD;
          int parts = 0;  // parts whose chunk holds keys; the others load nothing
          while (parts < ATTN_PARTS && (parts * hc + i) * AK < N) ++parts;
          mbar_expect_tx(full_bar + 8 * r, parts * TILE);
          for (int f = 0; f < parts; ++f)
            tma_load_3d(smem_u32(ring + (r * ATTN_PARTS + f) * TILE), &map, full_bar + 8 * r, col,
                        (f * hc + i) * AK, b);
        }
      }
    }
    return;
  }

  float* mine = Sp + (size_t)warp * hc * 32 * 32 + lane;  // [hc][32] x stride 32
  for (int k = 0; k < mine_items; ++k) {
    float mrow[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float srow[2] = {0.f, 0.f};
    float o[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
    mbar_wait(qfull_bar, k & 1);

    for (int t = 0; t < steps; ++t) {
      const int g = k * steps + t, r = g % ATTN_RING;
      mbar_wait(full_bar + 8 * r, (g / ATTN_RING) & 1);
      const bool second = t >= hc;
      const int i = second ? t - hc : t;
      const int k0 = (part * hc + i) * AK;
      const uint32_t tile = smem_u32(ring + (r * ATTN_PARTS + part) * TILE);
      float* park = mine + (size_t)i * 32 * 32;
      if (k0 < N) {  // uniform across the warpgroup
        if (!second) {
          // Pass 1: the chunk's scaled fp32 logits, once; -inf past N.
          float sc[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) sc[e] = 0.f;
          fence_regs(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_m64n64(sc, swz_desc<HD>(q_s) + 2 * kk, swz_desc<HD>(tile) + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          if (lane == 0) mbar_arrive(empty_bar + 8 * r);  // this warp is done with the buffer
#pragma unroll
          for (int j = 0; j < AK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + j * 8 + t4 * 2 + (e & 1);
              const float l = key < N ? sc[4 * j + e] * scale : -CUDART_INF_F;
              mrow[e >> 1] = fmaxf(mrow[e >> 1], l);
              park[(j * 4 + e) * 32] = l;
            }
        } else {
          // Pass 2: p = exp2(l - max) in fp32, s += p, acc += bf16(p) . V.
          uint32_t pa[AK / 16][4];
#pragma unroll
          for (int kk = 0; kk < AK / 16; ++kk) {
            float p[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              p[e] = exp2f(park[(kk * 8 + e) * 32] - mrow[(e >> 1) & 1]);
              srow[(e >> 1) & 1] += p[e];
            }
            pa[kk][0] = pack_bf16x2(p[0], p[1]);
            pa[kk][1] = pack_bf16x2(p[2], p[3]);
            pa[kk][2] = pack_bf16x2(p[4], p[5]);
            pa[kk][3] = pack_bf16x2(p[6], p[7]);
          }
          fence_regs(o);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < AK / 16; ++kk)
            wgmma_rs_pv<HD>(o, pa[kk], swz_desc<HD>(tile + kk * 16 * RB));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) mbar_arrive(empty_bar + 8 * r);
        }
      } else if (lane == 0) {
        mbar_arrive(empty_bar + 8 * r);  // a chunk past the last: nothing to read
      }
      if (t == hc - 1) {
        // End of pass 1: Q may make way for the next item's, and the
        // parts' row maxima meet in shared memory.
        if (lane == 0) mbar_arrive(qempty_bar);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 1));
          mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 2));
          if (t4 == 0) Mx[part * AQ + qw * 16 + (lane >> 2) + hh * 8] = mrow[hh];
        }
        named_bar_sync(1, CONSUMERS);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rr = qw * 16 + (lane >> 2) + hh * 8;
          float m = Mx[rr];
#pragma unroll
          for (int f = 1; f < ATTN_PARTS; ++f) m = fmaxf(m, Mx[f * AQ + rr]);
          mrow[hh] = m;
        }
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      srow[hh] += __shfl_xor_sync(0xffffffffu, srow[hh], 1);
      srow[hh] += __shfl_xor_sync(0xffffffffu, srow[hh], 2);
    }
    // The other parts hand their PV partials (through their own first
    // parking slot, read in full) and row sums to the first part, which
    // adds them in part order and stores bf16(acc / s); the second
    // barrier keeps the slots until it has read them.
    if (part > 0) {
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) mine[e * 32] = o[e];
      if (t4 == 0) {
        Ms[(part - 1) * AQ + qw * 16 + (lane >> 2)] = srow[0];
        Ms[(part - 1) * AQ + qw * 16 + (lane >> 2) + 8] = srow[1];
      }
    }
    named_bar_sync(1, CONSUMERS);
    if (part == 0) {
#pragma unroll
      for (int f = 1; f < ATTN_PARTS; ++f) {
        const float* xf = Sp + (size_t)(f * 4 + qw) * hc * 32 * 32 + lane;
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) o[e] += xf[e * 32];
        srow[0] += Ms[(f - 1) * AQ + qw * 16 + (lane >> 2)];
        srow[1] += Ms[(f - 1) * AQ + qw * 16 + (lane >> 2) + 8];
      }
      int q0, h, b;
      item(k, q0, h, b);
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
    named_bar_sync(1, CONSUMERS);
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

template <int HD>
cudaError_t launch_attn(const bf16* qkv, bf16* att, int B, int N, int C, int H,
                        float scale, cudaStream_t stream) {
  if (N <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + AQ - 1) / AQ, H, B);
  if (N <= ATTN_ONCHIP_MAX_N) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        attn_onchip_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)attn_onchip_smem_bytes<HD>(ATTN_ONCHIP_MAX_N / AK / ATTN_PARTS));
    if (attr != cudaSuccess) return attr;
    const int hc = ((N + AK - 1) / AK + ATTN_PARTS - 1) / ATTN_PARTS;
    CUtensorMap map;
    const cudaError_t err = make_qkv_map<HD>(&map, qkv, B, N, C);
    if (err != cudaSuccess) return err;
    const long long items = (long long)grid.x * H * B;
    const int blocks = (int)(items < sm_count() ? items : sm_count());
    attn_onchip_kernel<HD><<<blocks, ATTN_ONCHIP_THREADS, attn_onchip_smem_bytes<HD>(hc),
                             stream>>>(map, att, B, N, C, H, scale);
    return cudaGetLastError();
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_twopass_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)attn_smem_bytes<HD>());
  if (attr != cudaSuccess) return attr;
  attn_twopass_kernel<HD><<<grid, ATTN_THREADS, attn_smem_bytes<HD>(), stream>>>(
      qkv, att, N, C, scale);
  return cudaGetLastError();
}

// The attention core for a head dim of 16, 32 or 64: on chip up to
// ATTN_ONCHIP_MAX_N keys, two passes past it.
inline cudaError_t launch_attn_any(const bf16* qkv, bf16* att, int B, int N, int C,
                                   int H, float scale, cudaStream_t stream) {
  switch (C / H) {
    case 16: return launch_attn<16>(qkv, att, B, N, C, H, scale, stream);
    case 32: return launch_attn<32>(qkv, att, B, N, C, H, scale, stream);
    case 64: return launch_attn<64>(qkv, att, B, N, C, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
