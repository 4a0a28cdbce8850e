// Shared row LayerNorm and tensor-core GEMM of the port's block kernels
// for Hopper (sm_90a): kernels B2 (attn_block.cu), B5 (mlp_block.cu) and
// B6 (cross_block.cu) each run ln_rows_kernel, then gemm_nt_kernel with
// the epilogue their step needs.
//
// ln_rows_kernel: y = bf16(LayerNorm(x)) per row, one warp per row, fp32
// mean, fp32 variance of (x - mean), rsqrt, fp32 affine
// (pallas_block.py:54-59). It is bound by bytes (a row in, a row out) and
// reads each row once into registers.
//
// gemm_nt_kernel<BN, EPI>: Out = epilogue(A . W^T) with A [M, K] and
// W [N, K] (torch's [out, in] weight layout, both operands K-contiguous),
// bf16 operands, fp32 accumulation. What bounds it: tensor-core
// operations (2*M*N*K FLOP). At M = 9216 the paths' products do 400-1400
// FLOP per byte they must move, above the card's 295; the decoder's
// 512 x 512 products (~250) sit just below it. What the design does
// about it:
//   - wgmma.mma_async m64nBNk16, both operands read from shared memory
//     (K-major, 128-byte swizzle): the only instruction that reaches the
//     card's full tensor-core rate. Output tiles of 128 x BN, BN = 256 or
//     128; two consumer warpgroups own 64 rows each.
//   - TMA (cp.async.bulk.tensor) loads A and W tiles of 64-deep K slices
//     into a ring of stages (3 at BN = 256, 5 at 128, beside the output
//     tile's buffer); completion is
//     signalled on an mbarrier per stage ("full"), and the consumers free
//     a stage on a second one ("empty") when the wgmma that read it has
//     retired. One producer warp issues every load; setmaxnreg moves
//     registers from its warpgroup (40) to the consumers (232), which hold
//     a 64 x 256 fp32 accumulator in 128 registers.
//   - The epilogue is the tensor cores' idle time in this design (both
//     consumer warpgroups share one tile), so it is kept short. The
//     consumers round their fragments in bf16 pairs (cvt.rn.bf16x2, then
//     add.rn.bf16x2, which rounds the exact sum of two bf16 values once,
//     as an fp32 add and one rounding do) into a 128-byte-swizzled tile
//     buffer (conflict-free), and one thread per warpgroup hands it to
//     TMA stores (cp.async.bulk.tensor, shared to global), which run
//     while the next tile's products start. Written straight from the
//     registers, 4 bytes per thread and row, the same tile took about as
//     long as its products. The residual of EPI_BIAS_RESID comes into
//     the same buffer by TMA, requested by the producer once the ring
//     holds the tile's first slices, so it lands during the products.
//   - Ragged M, N and K: TMA zero-fills what lies past the tensor's edge
//     on loads and clips it on stores, so the contract is K % 8 == 0 and
//     N % 8 == 0 (16-byte row pitches).
//   - Persistent tiles: min(tiles, SMs) blocks walk the output tiles in
//     row-major order, so the producer fills the next tile's stages while
//     the consumers run this tile's epilogue. The host picks BN per
//     product to keep the last wave full (gemm_tile_n): rounds x (BN + 32)
//     is the proxy for time, so N = 768 takes 256 and N = 512 takes 128.
//   - Host cost: the tensor maps are encoded per call
//     (cuTensorMapEncodeTiled, fetched once through
//     the runtime's entry-point lookup, so the build needs no -lcuda);
//     cudaFuncSetAttribute runs once per instantiation.
// The epilogues round where the TPU kernels do: t = bf16(acc), then
// t = bf16(t + bias) (the bias added in bf16), then one of
//   EPI_BIAS            nothing more (B2's qkv, B6's q);
//   EPI_BIAS_RESID      t = bf16(R + t), the residual in bf16 (every proj
//                       and fc2);
//   EPI_BIAS_GELU_TANH  t = bf16(gelu_tanh(fp32 t)): fp32 from the bf16
//                       sum, rounded once, as torch's F.gelu(approximate=
//                       "tanh") computes a bf16 tensor (B5, tanh);
//   EPI_BIAS_GELU_ERF   t = bf16(gelu_erf(fp32 t)) (B5, erf;
//                       pallas_block.py:234-235).
// Only the order of the fp32 accumulation differs from the plain version.

#pragma once

#include "attention.cuh"  // bf16, cp.async and wgmma helpers

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_MAX_VEC = 8;  // 16-byte vectors per lane: rows up to 32 * 8 * 8 = 2048

constexpr int GBM = 128;  // GEMM output rows per tile: two consumer warpgroups of 64
constexpr int GBK = 64;   // K slice per stage: 128 bytes of bf16, one swizzle row
constexpr int GEMM_THREADS = 384;  // producer warpgroup, then two consumer warpgroups
constexpr int GEMM_SMEM_BUDGET = 210 * 1024;  // stages + tile buffer, of the 227 KB

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_RESID = 1, EPI_BIAS_GELU_TANH = 2, EPI_BIAS_GELU_ERF = 3 };

// K-slice stages that fit beside the 128 x BN bf16 tile buffer: 3 at
// BN = 256, 5 at 128.
template <int BN>
__host__ __device__ constexpr int gemm_stages() {
  return (GEMM_SMEM_BUDGET - GBM * BN * 2) / ((GBM + BN) * GBK * 2);
}

// Stages, the tile buffer, 2 x stages + 2 mbarriers, and 1 KB of slack
// to align the stages to 1024 bytes (the 128-byte swizzle's period).
template <int BN>
__host__ __device__ constexpr size_t gemm_smem_bytes() {
  return (size_t)gemm_stages<BN>() * (GBM + BN) * GBK * 2 + (size_t)GBM * BN * 2 +
         (2 * gemm_stages<BN>() + 2) * 8 + 1024;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), torch's formula.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// 0.5 x (1 + erf(x / sqrt(2))).
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// y[m, :] = bf16(LayerNorm(x[m, :])): one warp per row, C % 8 == 0,
// C <= 32 * 8 * VEC. fp32 mean, fp32 variance of (x - mean), rsqrt. VEC
// (16-byte vectors per lane) is sized to C, so a row takes the registers
// it needs and more rows fit on an SM.
template <int VEC>
__global__ void __launch_bounds__(LN_THREADS) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ lns,
    const float* __restrict__ lnb, float eps, bf16* __restrict__ y, int M, int C) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const bf16* xr = x + (size_t)row * C;
  float v[VEC][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < C) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = bf2f(e[j]);
        s += v[i][j];
      }
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if ((i * 32 + lane) * 8 < C) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
  bf16* yr = y + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < C) {
      uint4 u;
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xn = (v[i][j] - mean) * rstd;
        e[j] = f2bf(xn * lns[k + j] + lnb[k + j]);
      }
      *reinterpret_cast<uint4*>(yr + k) = u;
    }
  }
}

inline cudaError_t launch_ln(const bf16* x, const float* lns, const float* lnb, float eps,
                             bf16* y, int M, int C, cudaStream_t stream) {
  const int blocks = (M + LN_THREADS / 32 - 1) / (LN_THREADS / 32);
  switch ((C + 255) / 256) {
#define LN_CASE(V)                                                                \
  case V:                                                                         \
    ln_rows_kernel<V><<<blocks, LN_THREADS, 0, stream>>>(x, lns, lnb, eps, y, M, C); \
    break;
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4) LN_CASE(5) LN_CASE(6) LN_CASE(7) LN_CASE(8)
#undef LN_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- GEMM building blocks (inline PTX) ----

// wgmma descriptor of a K-major bf16 tile with 128-byte rows in TMA's
// 128-byte swizzle, 1024-byte aligned: start address >> 4, leading offset
// 16 B (unused in this layout), stride 1024 B between 8-row groups,
// layout type 1 (128B swizzle). A k16 step inside the 64-wide row adds
// 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d += A . B^T for a 64 x N x 16 step: A (64 x 16) and B (N x 16) from
// shared memory by descriptor, both K-major; d in the accumulator layout
// (warp w of the warpgroup holds rows 16w + lane/4 (+ 8), register
// 4j + 2h + e at column 8j + 2*(lane % 4) + e of row half h).
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256(d, da, db, 1);
  else
    wgmma_m64n128(d, da, db, 1);
}

// TMA store: the box of `map` at (c0, c1) from shared memory at `src`,
// in the issuing thread's bulk group. Out-of-range elements are skipped.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

constexpr int EPI_GROUP = 16;  // column chunks whose bias loads go together

// Out[m, n] = epilogue(sum_k A[m, k] * W[n, k]) over every 128 x BN tile,
// tiles walked persistently: block b takes tiles b, b + gridDim.x, ...
// map_o (and map_r, the residual, read by EPI_BIAS_RESID only) are
// [M, N] maps with 64 x 64 boxes in the 128-byte swizzle.
template <int BN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1) gemm_nt_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_o, const __grid_constant__ CUtensorMap map_r,
    const bf16* __restrict__ bias, int M, int N, int K) {
  constexpr int STAGES = gemm_stages<BN>();
  constexpr uint32_t A_BYTES = GBM * GBK * 2, B_BYTES = BN * GBK * 2;
  constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  constexpr uint32_t BOX_BYTES = 64 * 128;  // a 64 x 64 bf16 box
  constexpr int BOXES = BN / 64;            // boxes per 64-row half of the tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t cbuf = base + STAGES * STAGE_BYTES;  // [2 halves][BOXES][64 rows][128 B]
  const uint32_t full_bar = cbuf + GBM * BN * 2;      // [STAGES] x 8 bytes
  const uint32_t empty_bar = full_bar + STAGES * 8;   // [STAGES] x 8 bytes
  const uint32_t rfull_bar = empty_bar + STAGES * 8;  // the residual tile has landed
  const uint32_t rfree_bar = rfull_bar + 8;           // the tile buffer may be refilled

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + GBM - 1) / GBM) * n_tiles;
  const int KT = (K + GBK - 1) / GBK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2 * 4);  // every consumer warp
    }
    mbar_init(rfull_bar, 1);
    mbar_init(rfree_bar, 2);  // one thread per consumer warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        const int m0 = (tile / n_tiles) * GBM, n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t fb = full_bar + 8 * stage, dst = base + stage * STAGE_BYTES;
          mbar_expect_tx(fb, STAGE_BYTES);
          tma_load_2d(dst, &map_a, fb, kt * GBK, m0);
          tma_load_2d(dst + A_BYTES, &map_w, fb, kt * GBK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
          if (EPI == EPI_BIAS_RESID && kt == (KT < STAGES ? KT : STAGES) - 1) {
            // The residual tile, once the ring holds this tile's first
            // slices and the previous tile's output has left the buffer
            // (the consumers say so in this tile's first slice); it lands
            // while this tile's products run.
            mbar_wait(rfree_bar, (it & 1) ^ 1);
            mbar_expect_tx(rfull_bar, GBM * BN * 2);
            for (int h = 0; h < 2; ++h)
              for (int bx = 0; bx < BOXES; ++bx)
                tma_load_2d(cbuf + (h * BOXES + bx) * BOX_BYTES, &map_r, rfull_bar, n0 + bx * 64,
                            m0 + h * 64);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: rows cw*64 .. cw*64 + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const uint32_t my_buf = cbuf + cw * BOXES * BOX_BYTES;
    int stage = 0;
    uint32_t phase = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int m0 = (tile / n_tiles) * GBM, n0 = (tile % n_tiles) * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t a_tile = base + stage * STAGE_BYTES + cw * 64 * 128;
        const uint64_t da = sw128_desc(a_tile);
        const uint64_t db = sw128_desc(base + stage * STAGE_BYTES + A_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < GBK / 16; ++k) wgmma_step<BN>(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        if (kt == 0 && t == 0 && it > 0) {
          // The previous tile's stores have read the tile buffer by now;
          // the residual of this tile may come in.
          bulk_wait_read();
          if (EPI == EPI_BIAS_RESID) mbar_arrive(rfree_bar);
        }
        // The previous slice's products have retired: free its stage.
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0 && lane == 0) mbar_arrive(empty_bar + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

      // Epilogue: round into the swizzled tile buffer (row r's 16-byte
      // chunk c of a box sits at chunk c ^ (r % 8)), then TMA-store it.
      // The buffer's previous contents have left: thread 0 waited for its
      // stores in this tile's first slice, and the barrier orders that
      // wait before every thread's writes.
      named_bar_sync(1 + cw, 128);
      if (EPI == EPI_BIAS_RESID) mbar_wait(rfull_bar, it & 1);
      const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
      for (int g = 0; g < BN / 8; g += EPI_GROUP) {
        __nv_bfloat162 bv[EPI_GROUP];
#pragma unroll
        for (int jj = 0; jj < EPI_GROUP; ++jj) {
          const int n = n0 + (g + jj) * 8 + (lane & 3) * 2;
          bv[jj] = n < N ? *reinterpret_cast<const __nv_bfloat162*>(bias + n)
                         : __floats2bfloat162_rn(0.f, 0.f);
        }
#pragma unroll
        for (int jj = 0; jj < EPI_GROUP; ++jj) {
          const int j = g + jj;
          const uint32_t box = my_buf + (j / 8) * BOX_BYTES;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + hh * 8;
            const uint32_t addr = box + r * 128 + (((j % 8) ^ (lane >> 2)) << 4) + (lane & 3) * 4;
            // bf16(acc), then bf16(t + bias): a bf16x2 add rounds the exact
            // sum once, as fp32 does for two bf16 values before one rounding.
            __nv_bfloat162 t2 =
                __hadd2(__floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]),
                        bv[jj]);
            if constexpr (EPI == EPI_BIAS_RESID) {
              uint32_t rw;
              asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rw) : "r"(addr));
              t2 = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&rw), t2);
            } else if constexpr (EPI == EPI_BIAS_GELU_TANH) {
              const float2 f = __bfloat1622float2(t2);
              t2 = __floats2bfloat162_rn(gelu_tanh(f.x), gelu_tanh(f.y));
            } else if constexpr (EPI == EPI_BIAS_GELU_ERF) {
              const float2 f = __bfloat1622float2(t2);
              t2 = __floats2bfloat162_rn(gelu_erf(f.x), gelu_erf(f.y));
            }
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                         "r"(*reinterpret_cast<uint32_t*>(&t2))
                         : "memory");
          }
        }
      }
      fence_async_shared();
      named_bar_sync(1 + cw, 128);
      if (t == 0) {
        if (m0 + cw * 64 < M)
          for (int bx = 0; bx < BOXES && n0 + bx * 64 < N; ++bx)
            tma_store_2d(&map_o, my_buf + bx * BOX_BYTES, n0 + bx * 64, m0 + cw * 64);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait_all();
  }
}

// ---- host side ----

// The tensor map of a row-major bf16 [rows, cols] matrix, in boxes of
// box_rows x box_cols (box_cols * 2 <= 128 bytes) with the 128-byte
// swizzle.
inline cudaError_t make_map(CUtensorMap* map, const bf16* ptr, int rows, int cols,
                            int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// BN for an M x N product: the one whose rounds of tiles over the SMs,
// times BN + 32 (the tile's fixed cost: pipeline fill and epilogue),
// is smaller; 256 on a tie.
inline int gemm_tile_n(int M, int N, int sms) {
  auto cost = [&](int bn) {
    const long long tiles = (long long)((M + GBM - 1) / GBM) * ((N + bn - 1) / bn);
    return ((tiles + sms - 1) / sms) * (bn + 32);
  };
  return cost(128) < cost(256) ? 128 : 256;
}

template <int BN, int EPI>
cudaError_t launch_gemm_tiles(const bf16* A, const bf16* W, const bf16* bias, const bf16* R,
                              bf16* Out, int M, int N, int K, int sms, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(gemm_nt_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)gemm_smem_bytes<BN>());
  if (attr != cudaSuccess) return attr;
  CUtensorMap ma, mw, mo, mr;
  cudaError_t err;
  if ((err = make_map(&ma, A, M, K, GBM, GBK)) != cudaSuccess ||
      (err = make_map(&mw, W, N, K, BN, GBK)) != cudaSuccess ||
      (err = make_map(&mo, Out, M, N, 64, 64)) != cudaSuccess)
    return err;
  if (EPI == EPI_BIAS_RESID) {
    if ((err = make_map(&mr, R, M, N, 64, 64)) != cudaSuccess) return err;
  } else {
    mr = mo;  // not read
  }
  const long long tiles = (long long)((M + GBM - 1) / GBM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_nt_kernel<BN, EPI><<<grid, GEMM_THREADS, gemm_smem_bytes<BN>(), stream>>>(
      ma, mw, mo, mr, bias, M, N, K);
  return cudaGetLastError();
}

// Out = epilogue(A . W^T); requires M, N, K > 0, K % 8 == 0, N % 8 == 0
// and 16-byte aligned A, W, R and Out.
template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const bf16* bias, const bf16* R,
                        bf16* Out, int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (gemm_tile_n(M, N, sms) == 256)
    return launch_gemm_tiles<256, EPI>(A, W, bias, R, Out, M, N, K, sms, stream);
  return launch_gemm_tiles<128, EPI>(A, W, bias, R, Out, M, N, K, sms, stream);
}

}  // namespace
