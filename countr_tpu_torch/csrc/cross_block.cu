// Kernel B6: the cross-attention half-block y = x + proj(attn(q(LN(x)),
// k, v)) of the interaction decoder, over precomputed k, v [B, ny <= 8, C]
// (the exemplar tokens), forward, bf16 activations, for Hopper (sm_90a),
// in ONE kernel launch at every C <= 2048: LN(x), q and the attention
// output stay on chip; only x, the weights, k, v and y touch device
// memory. Two plans: LN(x) of the tile resident in shared memory
// (cross_block_kernel, C <= 768), or streamed by K-chunks
// (cross_block_kernel_streamed, C <= 2048; below the first plan's notes).
//
// Replaces countr_tpu/ops/pallas_block.py::_cross_block_kernel (launched
// by _fused_cross, public entry fused_cross_attention_block), whose point
// is the avoided device-memory round trips of LN(x), q and att. As in the
// JAX package it is wired into no model; its entry is driven by the A/B
// measurements.
//
// What bounds it on the H100: tensor-core operations, barely. At 16
// windows of the decoder ([16, 576, 512], 16 heads, ny 3) the q and proj
// products are 9.7 GFLOP, 9.8 us at 989 TFLOP/s; the attention is 0.06
// GFLOP; device-memory traffic (x in, y out, the two weights, k, v) is
// ~20 MB, 6 us at 3.35 TB/s. The four-launch design before this one (LN,
// the q GEMM, the small-k attention, the proj GEMM) also wrote and read
// back LN(x), q and att (~57 MB more).
//
// What holds a fused design back on this card: each block streams both
// weights (2 C^2 bf16, 1 MB at C = 512) from L2 through its ring for
// every tile, ~17 us a product at the decoder's shape (a phase-timed
// development build, PERF.md section 6), whatever the tile's rows. 64-row
// tiles give 144 tiles for 132 SMs at M = 9216, and the 12 left over
// would cost a second full tile time. So:
//   - Tiles: 64 rows while every tile fits on the SMs at once; past that
//     one tile an SM of ceil(M / SMs) <= 72 rows (132 tiles of 69-70 rows
//     at M = 9216): consumer warpgroup 1 takes rows 0-63 by wgmma,
//     warpgroup 2 the rest (at most 8) by mma.sync m16n8k16 on the same
//     weight stages, so the weights stream once for 72 rows.
//   - Warps: warp 0 the producer (one thread: every TMA load), warps 1-3
//     and warpgroup 3 attention, warpgroups 1-2 the consumers. 512
//     threads, 128 registers each (the 64 x 128 fp32 fragment is 64).
//   - x in: the producer TMA-loads the tile's x (64 x 64 boxes, and 8 x 64
//     boxes for rows 64-71; 128-byte swizzle; rows past M read as zeros)
//     into the att buffer, free until step 3.
//   - 1-2. LN, the prologue: the 15 warps past the producer's take two
//     rows at a time, one warp a row as gemm.cuh's ln_rows_kernel (fp32
//     mean, fp32 variance of x - mean, rsqrt, fp32 affine, bf16), into
//     the xn buffer in the K-major 128-byte-swizzled layout that wgmma
//     reads as A (padding columns up to a multiple of 64 as zeros).
//   - 3. q product in N-slices of 128 columns: Wq's 128 x 64 K-slices
//     come through a ring of stages by TMA, each stage read by both
//     consumer warpgroups. A slice's fragment is rounded as t = bf16(acc),
//     q = bf16(t + bq) and written into the att buffer (same layout);
//     then the slice's q is handed to the attention (an mbarrier).
//   - The attention (the small-k softmax over ny <= 8 keys), in place,
//     in chunks of 32 lanes' work: a lane takes min(hd, 32) columns of a
//     row (a head of 64 or more spans neighbouring lanes, which exchange
//     partial logits by shuffles), k and v read from L1/L2 per row's
//     batch element (a tile may straddle several). The attention warps
//     take chunks from a shared counter while the consumers run the next
//     slices' products; the consumers join once their q products are
//     done. Per key: logit = fp32(q . k_j) * hd^-0.5 * log2(e); then the
//     exact max, p = exp2(logit - max), s += p (fp32), acc += bf16(p) * v_j
//     (fp32), att = bf16(acc / s): the TPU kernel's rounding points
//     (pallas_block.py:405-436), the division after PV, done as one
//     correctly rounded reciprocal and an FMA step per column (div_rn).
//   - 4. proj product: A = att, each 128-column slice of it once its
//     attention is done; Wproj through the ring. Once the q products have
//     retired the producer TMA-loads x again (the residual, mostly from
//     L2) into the xn buffer. Epilogue as gemm.cuh's EPI_BIAS_RESID: t =
//     bf16(acc), t = bf16(t + bproj), y = bf16(x + t) (bf16x2 adds: each
//     the exact sum rounded once); warpgroup 1 writes y over the residual
//     and TMA-stores 64 x 64 boxes (columns past C, rows past M clipped),
//     warpgroup 2 stores its few rows straight to device memory.
// Only the order of the fp32 sums differs from cross_block_plain.
//
// Shared memory (227 KB a block), at C = 512 with 72-row tiles:
//   xn   64 + 8 rows x 512 bf16    72 KB  (LN(x); then the residual and y)
//   att  64 + 8 rows x 512 bf16    72 KB  (x; then q; then att)
//   ring 5 stages x 128 x 64 bf16  80 KB
//   mbarriers, row offsets, work counter 1.3 KB; alignment slack 1 KB
// = 226 KB. The 64-row tiles take 256 * C bytes for the two buffers, so
// this plan (LN(x) resident) takes C <= 768 (192 KB, 2 stages); 72-row
// tiles need C <= 512.
//
// The streamed plan (cross_block_kernel_streamed) takes every C <= 2048
// in one launch: LN(x) is never stored whole.
//   - 1-2. LN statistics: the 15 warps past the producer's read the
//     tile's rows from device memory once (ln_tile's sums, in its order)
//     and keep each row's fp32 mean and rstd, 8 bytes a row.
//   - 3. q product: each ring stage holds W_q's 128 x 64 K-slice and the
//     tile's x in that 64-column K-chunk (64 + 8 rows, both by TMA); the
//     helper warps (1-3, warpgroup 3, and warpgroup 2 where it has no
//     rows) normalise the chunk in place (ln_tile's affine and rounding,
//     so LN(x) is the resident plan's to the bit) and hand the stage to
//     the consumers on its A-ready mbarrier. The tile's x is re-read from
//     L2 once per 128-column N-slice.
//   - The attention as above, on the helpers and, after their q
//     products, the consumers; att of the block's columns stays resident.
//   - 4. proj product as above; the residual comes by TMA per output
//     slice into a 128-column staging buffer, where y is made and from
//     which it is TMA-stored.
//   - Past C 1280 (att of 64 rows, 128 * C bytes, no longer fits beside
//     two ring stages) a cluster of 2 blocks shares each tile: rank 0
//     takes the columns of the first ceil(H / 2) heads (whole heads and
//     whole 64-column chunks, split_col), rank 1 the rest; each computes
//     q, the attention and att for its heads and proj's output columns
//     for the same span, with K = C: its own att K-chunks from its shared
//     memory, the peer's copied into the stage's A part by the helpers
//     through distributed shared memory (ld.shared::cluster) once the
//     peer's attention arrives (a remote mbarrier arrival) on that
//     slice. A cluster barrier keeps each block alive while its peer may
//     read it.
// Every plan rounds at the same points and sums each output in the same
// order, so they agree to the bit where a shape fits several.
//
// Shared memory of the streamed plan, at 64 (72) rows: att 128 (144) x
// own columns bytes, ring stages of 24 (25) KB, the staging buffer 16
// (18) KB, mbarriers, row statistics and offsets 2.7 KB, alignment 1 KB:
//   C 768, one block, 72 rows: att 108 KB + 3 stages 75 KB = 203.6 KB
//   C 1024, one block, 64 rows: att 128 KB + 3 stages = 218.6 KB; 72
//     rows: 2 stages
//   C 1280, one block, 64 rows: att 160 KB + 2 stages = 226.6 KB (the
//     widest one block takes); a cluster, 768 of them a block: 5 (64
//     rows) or 3 (72 rows) stages
//   C 2048, a cluster, 1024 columns a block: 64 rows 3 stages (218.6
//     KB), 72 rows 2 stages (214.6 KB)
// cross_plan chooses: the resident plan where it runs every tile in one
// wave (the decoder's C 512 at 72 rows; any C <= 768 at M <= 64 x SMs);
// else one block a tile where that keeps 3 ring stages (C <= 768 at 72
// rows, C <= 1024 at 64), else the cluster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface, bound
//        with ctypes; the entry returns cudaGetLastError().

#include "gemm.cuh"

namespace {

constexpr int XR = 64;       // rows of a tile's first warpgroup: one wgmma M
constexpr int XR1 = 8;       // rows of its second, in the 72-row tiles
constexpr int XRT = XR + XR1;
constexpr int XK_MAX = 8;    // the most key tokens
constexpr int XC_MAX = 2048;  // the widest rows: the streamed plan's
constexpr int XC_RES = 768;   // the resident plan's: LN(x) and att of a tile resident
constexpr int XLN_VEC = XC_RES / 256;  // 16-byte vectors per lane of a row (resident plan)
constexpr int XST_VEC = XC_MAX / 256;  // the same for the streamed plan's row statistics
constexpr int XLN_ROWS = 2;            // rows a warp normalises at once
constexpr int XSMEM_MAX = 227 * 1024;
constexpr int XSTAGES_MAX = 6;
constexpr int XSLICES_MAX = XC_RES / 64;  // slices of the attention's work, at most (resident)
constexpr uint32_t XCHUNK = XR * 128;     // 64 rows x 64 bf16 columns: one TMA box, 8 KB
constexpr uint32_t XCHUNK1 = XR1 * 128;   // 8 rows x 64 columns, 1 KB

constexpr int XBW = 128;  // the products' N-slices: output columns per pass of a warpgroup
constexpr int XSL = XC_MAX / XBW;        // attention slices of the streamed plan, at most
constexpr uint32_t XWST = XBW * 128;     // a ring stage's weight part: 128 x 64 bf16, 16 KB
// Threads of a block: warp 0 the producer, warps 1-3 attention, two
// consumer warpgroups, a fourth warpgroup of attention warps.
constexpr int XTHREADS = 512;

__host__ __device__ constexpr int x_chunks(int C) { return (C + 63) / 64; }

// xn and att (64-row chunks, then, in the 72-row tiles, 8-row chunks),
// nst ring stages of 128 x 64 bf16, the mbarriers (full and empty per
// stage; q ready and att ready per slice; x in, q retired, residual in),
// the rows' k/v offsets and the work counter, and 1 KB to align the base
// to the swizzle's 1024-byte period.
inline size_t cross_smem_bytes(int C, int nst, bool ext) {
  return (size_t)2 * x_chunks(C) * (XCHUNK + (ext ? XCHUNK1 : 0)) + (size_t)nst * XBW * 128 +
         (2 * nst + 2 * XSLICES_MAX + 3) * 8 + XRT * 8 + 16 + 1024;
}

// Ring stages that fit (at least 2), or 0.
inline int cross_stages(int C, bool ext) {
  int nst = XSTAGES_MAX;
  while (nst >= 2 && cross_smem_bytes(C, nst, ext) > (size_t)XSMEM_MAX) --nst;
  return nst >= 2 ? nst : 0;
}

// The streamed plan's ring stage: the weight's 128 x 64 K-slice, then
// the A operand's 64-column K-chunk of the tile (64 rows, and 8 more in
// the 72-row tiles).
__host__ __device__ constexpr uint32_t stream_stage_bytes(bool ext) {
  return XWST + XCHUNK + (ext ? XCHUNK1 : 0);
}

// The streamed plan's shared memory: att (KCA 64-column chunks), nst
// ring stages, the 128-column staging buffer of the residual and y, the
// mbarriers (full, empty and A-ready per stage; q ready, att ready and
// peer att ready per slice; residual in, staging free), the rows' mean
// and rstd, their k/v offsets, the work counter and 1 KB of alignment.
inline size_t stream_smem_bytes(int KCA, int nst, bool ext) {
  const size_t rows = XCHUNK + (ext ? XCHUNK1 : 0);
  return (size_t)KCA * rows + (size_t)nst * stream_stage_bytes(ext) + 2 * rows +
         (3 * nst + 3 * XSL + 2) * 8 + XRT * 8 * 2 + 16 + 1024;
}

inline int stream_stages(int KCA, bool ext) {
  int nst = XSTAGES_MAX;
  while (nst >= 2 && stream_smem_bytes(KCA, nst, ext) > (size_t)XSMEM_MAX) --nst;
  return nst >= 2 ? nst : 0;
}

// The first column of cluster rank 1's share of the columns: whole heads
// and whole 64-column chunks, rank 0 taking the larger half (C 1280 in 5
// heads of 256: 768 and 512).
__host__ __device__ inline int split_col(int C, int hd) {
  const int u = hd > 64 ? hd : 64;
  const int cs = u * (((C + u - 1) / u + 1) / 2);
  return cs < C ? cs : C;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 u;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "r"(addr));
  return u;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 u) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(u.x), "r"(u.y),
               "r"(u.z), "r"(u.w)
               : "memory");
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t w;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w) : "r"(addr));
  return w;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t w) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(w) : "memory");
}
__device__ __forceinline__ void sts_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// ---- thread block clusters (the streamed plan's 2-block cluster) ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of both blocks: what each wrote before is visible to the
// other's threads after (release, acquire at cluster scope).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The shared::cluster address of this block's shared address `addr` in
// the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t map_peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ uint4 ld_cluster128(uint32_t addr) {
  uint4 u;
  asm volatile("ld.shared::cluster.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "r"(addr)
               : "memory");
  return u;
}
// One arrival, with release at cluster scope, on a peer's mbarrier.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote_bar)
               : "memory");
}
// mbar_wait with acquire at cluster scope: for a phase that a peer's
// arrivals complete.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONEC;\n"
      "bra LAB_WAITC;\n"
      "DONEC:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&out)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = bf2f(e[j]);
}

// a / b in fp32, correctly rounded, given rb = __frcp_rn(b): q = a * rb,
// then one FMA step on the exact remainder a - b * q (Markstein's
// theorem: with rb the correctly rounded reciprocal, the result is a / b
// rounded to nearest, barring overflow and underflow, which s >= 1 and
// |a| <= s * max|v| rule out). One reciprocal per row and head instead
// of a division per column.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// A tile buffer: rows 0-63 in 64 x 64 chunks of 8 KB at `main`, rows
// 64-71 in 8 x 64 chunks of 1 KB at `ext`, both in the 128-byte swizzle
// (the 16-byte unit u of a row's chunk at u ^ (row % 8)). The byte
// address of the unit holding column `col` (a multiple of 8) of row r.
struct TileBuf {
  uint32_t main, ext;
  __device__ __forceinline__ uint32_t unit(int r, int col) const {
    const uint32_t sw = (((col & 63) >> 3) ^ (r & 7)) << 4;
    return r < XR ? main + (col >> 6) * XCHUNK + r * 128 + sw
                  : ext + (col >> 6) * XCHUNK1 + (r - XR) * 128 + sw;
  }
};

// LN of the tile's rows 0 .. rows - 1, from x at `in` to LN(x) at `out`
// (`out` may be `in`: a row is read whole before it is written), by the
// WARPS warps past the producer's: warp g takes rows g, g + WARPS, ...,
// two at a time. Lane l holds the row's 16-byte units l, l + 32, l + 64
// and their LN scale and shift. As gemm.cuh's ln_rows_kernel: fp32 mean,
// fp32 variance of x - mean, rsqrt, fp32 affine, bf16; padding columns up
// to a multiple of 64 written as zeros.
template <int WARPS>
__device__ __forceinline__ void ln_tile(TileBuf in, TileBuf out, int rows,
                                        const float* __restrict__ lns,
                                        const float* __restrict__ lnb, int C, int KC, float eps,
                                        uint32_t xin_bar, int lane) {
  float ga[XLN_VEC][8], be[XLN_VEC][8];
#pragma unroll
  for (int i = 0; i < XLN_VEC; ++i) {
    const int c0 = (i * 32 + lane) * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 g4 = c0 < C ? __ldg(reinterpret_cast<const float4*>(lns + c0) + h)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b4 = c0 < C ? __ldg(reinterpret_cast<const float4*>(lnb + c0) + h)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      ga[i][4 * h] = g4.x, ga[i][4 * h + 1] = g4.y, ga[i][4 * h + 2] = g4.z, ga[i][4 * h + 3] = g4.w;
      be[i][4 * h] = b4.x, be[i][4 * h + 1] = b4.y, be[i][4 * h + 2] = b4.z, be[i][4 * h + 3] = b4.w;
    }
  }
  mbar_wait(xin_bar, 0);
  for (int r1 = (threadIdx.x >> 5) - 1; r1 < rows; r1 += XLN_ROWS * WARPS) {
    float e[XLN_ROWS][XLN_VEC][8], mean[XLN_ROWS], rstd[XLN_ROWS];
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) {
      const int r = min(r1 + q * WARPS, rows - 1);  // a row past the tile repeats the last
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < XLN_VEC; ++i) {
        const int c0 = (i * 32 + lane) * 8;
        if (c0 < C) {
          unpack8(lds128(in.unit(r, c0)), e[q][i]);
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += e[q][i][j];
        }
      }
      mean[q] = sum;
    }
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) mean[q] = warp_sum(mean[q]) / (float)C;
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < XLN_VEC; ++i) {
        if ((i * 32 + lane) * 8 < C) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = e[q][i][j] - mean[q];
            sq += d * d;
          }
        }
      }
      rstd[q] = sq;
    }
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) rstd[q] = rsqrtf(warp_sum(rstd[q]) / (float)C + eps);
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) {
      const int r = r1 + q * WARPS;
      if (r < rows) {
#pragma unroll
        for (int i = 0; i < XLN_VEC; ++i) {
          const int c0 = (i * 32 + lane) * 8;
          if (c0 < KC * 64) {
            uint4 o = make_uint4(0u, 0u, 0u, 0u);  // padding columns: zeros
            if (c0 < C) {
              bf16* ho = reinterpret_cast<bf16*>(&o);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                ho[j] = f2bf((e[q][i][j] - mean[q]) * rstd[q] * ga[i][j] + be[i][j]);
            }
            sts128(out.unit(r, c0), o);
          }
        }
      }
    }
  }
}

// The attention, in place in the att buffer, over the tile's rows 0 ..
// rows - 1 and columns c0 .. c1 - 1 (the buffer's column 0 is c0), in
// chunks of 32 units (a unit: CPL = min(hd, 32) columns of a row, one
// lane's); chunk c is units 32 (c % cps) .. + 31 of slice c / cps (SW
// columns), taken once the slice's q is in (qready). Warps take chunks
// one at a time from the shared counter `work`, so the attention warps
// and, after their q products, the consumer warps share the work; each
// finished chunk arrives on its slice's attready mbarrier (cps arrivals)
// and, where peer_bar is not 0, on the cluster peer's mbarrier of the
// same slice at that shared::cluster address. A head of more than 32
// columns spans LPH neighbouring lanes, which exchange partial logits by
// shuffles. For each key j < ny: logit = fp32(q . k_j) * hd^-0.5 *
// log2(e); then the exact max, p = exp2(logit - max), s += p (fp32), acc
// += bf16(p) * v_j (fp32), att = bf16(acc / s).
template <int SW, int HD>
__device__ __forceinline__ void attention_chunks(TileBuf att, int rows, uint32_t qready_bar,
                                                 uint32_t attready_bar,
                                                 const unsigned long long* kv_rows, int* work,
                                                 const bf16* __restrict__ k,
                                                 const bf16* __restrict__ v, int S, int C,
                                                 int ny, float scale, int lane, int c0, int c1,
                                                 uint32_t peer_bar) {
  constexpr int CPL = HD < 32 ? HD : 32;  // columns per lane
  constexpr int LPH = HD / CPL;           // lanes per head
  constexpr int G = CPL / 8;              // 16-byte groups per lane
  constexpr int UPR = SW / CPL;           // units per row of a slice
  const int cps = (rows * UPR + 31) / 32;  // chunks per slice
  const int total = S * cps;
  while (true) {
    int c = 0;
    if (lane == 0) c = atomicAdd(work, 1);
    c = __shfl_sync(0xffffffffu, c, 0);
    if (c >= total) break;
    const int i = c / cps;
    mbar_wait(qready_bar + 8 * i, 0);
    const int u = (c % cps) * 32 + lane;
    const int r = min(u / UPR, rows - 1);  // units past the tile's rows repeat its last
    const int col = c0 + i * SW + (u % UPR) * CPL;
    const bool valid = u < rows * UPR && col < c1;
    const int cv = col < c1 ? col : c0 + i * SW;  // a head past c1 reads the slice's first
    const bf16* kr = k + kv_rows[r] + cv;
    const bf16* vr = v + kv_rows[r] + cv;
    float q[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) unpack8(lds128(att.unit(r, cv - c0 + 8 * g)), q[g]);
    float lg[XK_MAX];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < XK_MAX; ++j) {
      if (j < ny) {  // ny is the same for the whole grid
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float kj[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(kr + (size_t)j * C + 8 * g)), kj);
          part[g] = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) part[g] += q[g][e] * kj[e];
        }
#pragma unroll
        for (int w = 1; w < G; w *= 2)
#pragma unroll
          for (int g = 0; g + w < G; g += 2 * w) part[g] += part[g + w];
        float d = part[0];
#pragma unroll
        for (int o = LPH / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        lg[j] = d * scale;
        mx = fmaxf(mx, lg[j]);
      }
    }
    float s = 0.f, acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
#pragma unroll
    for (int j = 0; j < XK_MAX; ++j) {
      if (j < ny) {
        const float p = exp2f(lg[j] - mx);
        s += p;
        const float pb = bf2f(f2bf(p));
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float vj[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(vr + (size_t)j * C + 8 * g)), vj);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += pb * vj[e];
        }
      }
    }
    if (valid) {
      const float rs = __frcp_rn(s);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint4 o;
        bf16* h = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = f2bf(div_rn(acc[g][e], s, rs));
        sts128(att.unit(r, cv - c0 + 8 * g), o);
      }
    }
    // The chunk's att, visible to the proj products (the async proxy),
    // and to the cluster peer's reads (and the release of its arrival).
    fence_async_shared();
    if (peer_bar) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(attready_bar + 8 * i);
      if (peer_bar) mbar_arrive_cluster(peer_bar + 8 * i);
    }
  }
}

// ldmatrix.x4 from a shared-memory address: lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc = A . W_slice^T over K = 64 * KC: W's K-slices from the ring, stage
// seq in slot seq % nst (stage_bytes apart, the weight first), read by
// every consumer warpgroup, each freeing it once the products that read
// it have retired (one K-slice late). A's K-chunk kc is the resident
// 64-row chunk kc - lo at loc + (kc - lo) * XCHUNK where lo <= kc < hi
// (where loc_ready is not 0, each SW-column slice of it once its
// mbarrier there has completed), else the stage's A part, which the
// streamed plan's helper warps fill. With staged_wait every stage waits
// for the helpers' A-ready mbarrier too, the resident chunks' as well:
// the helpers then see every phase of the stage's full mbarrier, which a
// parity wait needs. With `release`, the thread lets the producer refill
// the staging buffer once its TMA stores have read it (after the first
// K-slice's products are issued).
template <int SW>
__device__ __forceinline__ void slice_product(float (&acc)[XBW / 2], uint32_t ring,
                                               uint32_t stage_bytes, uint32_t full_bar,
                                               uint32_t empty_bar, uint32_t aready_bar, int nst,
                                               int KC, int lo, int hi, uint32_t loc,
                                               uint32_t loc_ready, bool staged_wait, int& seq,
                                               int lane, bool release, uint32_t res_bar) {
#pragma unroll
  for (int i = 0; i < XBW / 2; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int kc = 0; kc < KC; ++kc, ++seq) {
    const int slot = seq % nst;
    const uint32_t par = (seq / nst) & 1;
    const bool local = kc >= lo && kc < hi;
    if (local && loc_ready && (kc - lo) * 64 % SW == 0)
      mbar_wait(loc_ready + 8 * ((kc - lo) * 64 / SW), 0);
    mbar_wait(full_bar + 8 * slot, par);
    if (staged_wait) mbar_wait(aready_bar + 8 * slot, par);
    const uint32_t stage = ring + slot * stage_bytes;
    const uint64_t da = sw128_desc(local ? loc + (kc - lo) * XCHUNK : stage + XWST);
    const uint64_t db = sw128_desc(stage);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_m64n128(acc, da + 2 * k, db + 2 * k, 1);
    wgmma_commit();
    if (kc == 0 && release) {
      bulk_wait_read();
      mbar_arrive(res_bar);
    }
    // The previous K-slice's products have retired: free its stage.
    wgmma_wait<1>();
    fence_regs(acc);
    if (kc > 0 && lane == 0) mbar_arrive(empty_bar + 8 * prev);
    prev = slot;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
}

// The same product for the tile's rows 64-71 by mma.sync m16n8k16 whose
// rows 8-15 repeat rows 0-7, A's K-chunk kc at loc1 + (kc - lo) * XCHUNK1
// (8 rows) where lo <= kc < hi, else the stage's 8-row A part: warp wq of
// warpgroup 2 takes the slice's columns 32 wq .. 32 wq + 31, acc1[nt] the
// C fragment of its n8-tile nt (elements 0-1: row lane / 4, columns 2
// (lane % 4) + {0, 1}; 2-3 the repeat). Each warp frees a stage once its
// fragments are in registers.
template <int SW>
__device__ __forceinline__ void slice_product8(float (&acc1)[4][4], uint32_t ring,
                                                uint32_t stage_bytes, uint32_t full_bar,
                                                uint32_t empty_bar, uint32_t aready_bar, int nst,
                                                int KC, int lo, int hi, uint32_t loc1,
                                                uint32_t loc_ready, bool staged_wait, int& seq,
                                                int wq, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[nt][e] = 0.f;
  const int lr = lane & 7, mi = lane >> 3;  // row and matrix this lane addresses
  for (int kc = 0; kc < KC; ++kc, ++seq) {
    const int slot = seq % nst;
    const uint32_t par = (seq / nst) & 1;
    const bool local = kc >= lo && kc < hi;
    if (local && loc_ready && (kc - lo) * 64 % SW == 0)
      mbar_wait(loc_ready + 8 * ((kc - lo) * 64 / SW), 0);
    mbar_wait(full_bar + 8 * slot, par);
    if (staged_wait) mbar_wait(aready_bar + 8 * slot, par);
    __syncwarp();  // the lanes leave the waits one by one; ldmatrix and mma.sync need them all
    const uint32_t stage = ring + slot * stage_bytes;
    const uint32_t a1 = local ? loc1 + (kc - lo) * XCHUNK1 : stage + XWST + XCHUNK;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // A: (rows 0-7, k 0-7), the same again, (rows 0-7, k 8-15), again.
      uint32_t a[4];
      ldsm_x4(a, a1 + lr * 128 + (((2 * ks + (mi >> 1)) ^ lr) << 4));
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        // B: n8-tiles 2 pr and 2 pr + 1, k 0-7 and 8-15 of each.
        uint32_t b[4];
        const int n = 32 * wq + 8 * (2 * pr + (mi >> 1)) + lr;
        ldsm_x4(b, stage + n * 128 + (((2 * ks + (mi & 1)) ^ (n & 7)) << 4));
        mma16816(acc1[2 * pr], a, b[0], b[1]);
        mma16816(acc1[2 * pr + 1], a, b[2], b[3]);
      }
    }
    // The stage's reads (generic proxy) ordered before the TMA that
    // refills it (async proxy); without this fence the refill raced them.
    __syncwarp();
    fence_async_shared();
    if (lane == 0) mbar_arrive(empty_bar + 8 * slot);
  }
}

// y = x + proj(attn(q(LN(x)), k, v)) for the tile of block blockIdx.x:
// with ext 0, rows 64 b .. 64 b + 63; with ext 1, rows M b / G .. M (b +
// 1) / G (64 to 72 of them), the first 64 taken by consumer warpgroup 1
// (wgmma), the rest by warpgroup 2 (mma.sync). map_x and map_y: [M, C] in
// 64 x 64 boxes, map_x8 in 8 x 64 boxes; map_wq and map_wp: [C, C] in
// 128 x 64 boxes; all 128-byte swizzle.
template <int HD>
__global__ void __launch_bounds__(XTHREADS, 1) cross_block_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_x8,
    const __grid_constant__ CUtensorMap map_wq, const __grid_constant__ CUtensorMap map_wp,
    const __grid_constant__ CUtensorMap map_y, bf16* __restrict__ y,
    const float* __restrict__ lns, const float* __restrict__ lnb, const bf16* __restrict__ bq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ bproj,
    int M, int N, int C, int ny, int nst, int G, int ext, float eps, float scale) {
  constexpr uint32_t STAGE = XBW * 128;
  constexpr int SW = HD > XBW ? HD : XBW;  // attention slices: whole heads
  constexpr int UPR = SW / (HD < 32 ? HD : 32);  // attention units per row of a slice
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int KC = x_chunks(C);         // 64-column chunks of K and of the buffers
  const int S = (C + XBW - 1) / XBW;  // N-slices of each product
  const int SA = (C + SW - 1) / SW;   // attention slices
  const int m0 = ext ? (int)((long long)M * blockIdx.x / G) : blockIdx.x * XR;
  const int rows = ext ? (int)((long long)M * (blockIdx.x + 1) / G) - m0 : min(XR, M - m0);
  const bool two = rows > XR;  // the second consumer warpgroup has rows
  const uint32_t ext_bytes = ext ? KC * XCHUNK1 : 0;
  const TileBuf xn = {base, base + KC * XCHUNK};  // LN(x); then the residual x, then y
  const TileBuf att = {xn.ext + ext_bytes, xn.ext + ext_bytes + KC * XCHUNK};  // x; q; att
  const uint32_t ring = att.ext + ext_bytes;
  const uint32_t full_bar = ring + nst * STAGE;      // [nst]: a stage has landed
  const uint32_t empty_bar = full_bar + nst * 8;      // [nst]: a stage is free
  const uint32_t qready_bar = empty_bar + nst * 8;    // [XSLICES_MAX]: a slice's q is in att
  const uint32_t attready_bar = qready_bar + XSLICES_MAX * 8;  // [..]: a slice's att is in
  const uint32_t xin_bar = attready_bar + XSLICES_MAX * 8;     // x has landed in att
  const uint32_t qdone_bar = xin_bar + 8;  // the q products have retired
  const uint32_t res_bar = qdone_bar + 8;  // the residual has landed in xn
  // Each tile row's first k (and v) element, and the attention's next
  // chunk of work.
  unsigned long long* kv_rows =
      reinterpret_cast<unsigned long long*>(smem_raw + (res_bar + 8 - smem_u32(smem_raw)));
  int* work = reinterpret_cast<int*>(kv_rows + XRT);
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int cw = two ? 8 : 4;  // consumer warps with rows
  const uint32_t x_bytes = KC * XCHUNK + (two ? ext_bytes : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, cw);
    }
    for (int i = 0; i < XSLICES_MAX; ++i) {
      mbar_init(qready_bar + 8 * i, cw * (SW / XBW));  // each product slice's warps
      mbar_init(attready_bar + 8 * i, (rows * UPR + 31) / 32);  // the slice's chunks
    }
    mbar_init(xin_bar, 1);
    mbar_init(qdone_bar, cw);
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *work = 0;
  }
  if (threadIdx.x < XRT)  // a row past M reads row M - 1's keys and stores nothing
    kv_rows[threadIdx.x] = (unsigned long long)(min(m0 + (int)threadIdx.x, M - 1) / N) * ny * C;
  __syncthreads();

  if (threadIdx.x == 0) {
    // Producer: x, then the W stages of both products in sequence, and
    // the residual once no q product reads xn.
    mbar_expect_tx(xin_bar, x_bytes);
    for (int kc = 0; kc < KC; ++kc) {
      tma_load_2d(att.main + kc * XCHUNK, &map_x, xin_bar, kc * 64, m0);
      if (two) tma_load_2d(att.ext + kc * XCHUNK1, &map_x8, xin_bar, kc * 64, m0 + XR);
    }
    int seq = 0;
    for (int prod = 0; prod < 2; ++prod) {
      const CUtensorMap* map = prod ? &map_wp : &map_wq;
      for (int i = 0; i < S; ++i) {
        for (int kc = 0; kc < KC; ++kc, ++seq) {
          const int slot = seq % nst;
          mbar_wait(empty_bar + 8 * slot, ((seq / nst) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * slot, STAGE);
          tma_load_2d(ring + slot * STAGE, map, full_bar + 8 * slot, kc * 64, i * XBW);
          if (prod == 1 && i == 0 && kc == (KC < nst ? KC : nst) - 1) {
            // The residual, once the ring holds the first proj slices
            // and no q product reads xn any more; it lands while the
            // proj products run.
            mbar_wait(qdone_bar, 0);
            mbar_expect_tx(res_bar, x_bytes);
            for (int c = 0; c < KC; ++c) {
              tma_load_2d(xn.main + c * XCHUNK, &map_x, res_bar, c * 64, m0);
              if (two) tma_load_2d(xn.ext + c * XCHUNK1, &map_x8, res_bar, c * 64, m0 + XR);
            }
          }
        }
      }
    }
  } else if (threadIdx.x >= 32) {
    // 1-2. LN of the tile's rows, from the att buffer into xn.
    ln_tile<XTHREADS / 32 - 1>(att, xn, two ? XRT : XR, lns, lnb, C, KC, eps, xin_bar, lane);
    // LN(x) visible to the wgmma (async) proxy; every row written and
    // every read of x done before q overwrites it.
    fence_async_shared();
    named_bar_sync(1, XTHREADS - 32);
  }
  const bool consumer = wg == 1 || (wg == 2 && two);
  if (!consumer && threadIdx.x >= 32) {
    attention_chunks<SW, HD>(att, rows, qready_bar, attready_bar, kv_rows, work, k, v, SA, C,
                             ny, scale, lane, 0, C, 0);
  } else if (consumer) {
    // Consumer warpgroups: 1 takes rows 0-63 by wgmma (the thread's rows
    // r0 and r0 + 8 at columns 8j + 2 q4 + {0, 1} of every 8-wide group
    // j), 2 rows 64 .. rows - 1 by mma.sync (its warp wq's columns
    // 32 wq + 8 nt + 2 q4 + {0, 1}, row 64 + r0 % 8).
    const int t = threadIdx.x & 127, warp = t >> 5;
    const bool first = wg == 1;
    const int r0 = warp * 16 + (lane >> 2), q4 = lane & 3;
    const int r1 = XR + (lane >> 2);
    int seq = 0;

    // 3. q product, slice by slice: q = bf16(bf16(acc) + bq) into the
    // att buffer, handed to the attention.
    for (int i = 0; i < S; ++i) {
      const int n0 = i * XBW;
      if (first) {
        float acc[XBW / 2];
        slice_product<SW>(acc, ring, STAGE, full_bar, empty_bar, 0, nst, KC, 0, KC, xn.main, 0,
                          false, seq, lane, false, 0);
#pragma unroll
        for (int j = 0; j < XBW / 8; ++j) {
          if (n0 + 8 * j < C) {
            const __nv_bfloat162 b2 =
                *reinterpret_cast<const __nv_bfloat162*>(bq + n0 + 8 * j + 2 * q4);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              __nv_bfloat162 t2 = __hadd2(
                  __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), b2);
              sts32(att.unit(r0 + 8 * h, n0 + 8 * j) + q4 * 4, *reinterpret_cast<uint32_t*>(&t2));
            }
          }
        }
      } else {
        float acc1[4][4];
        slice_product8<SW>(acc1, ring, STAGE, full_bar, empty_bar, 0, nst, KC, 0, KC, xn.ext, 0,
                           false, seq, warp, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c8 = n0 + 32 * warp + 8 * nt;
          if (c8 < C && r1 < rows) {
            const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bq + c8 + 2 * q4);
            __nv_bfloat162 t2 = __hadd2(__floats2bfloat162_rn(acc1[nt][0], acc1[nt][1]), b2);
            sts32(att.unit(r1, c8) + q4 * 4, *reinterpret_cast<uint32_t*>(&t2));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(qready_bar + 8 * (n0 / SW));
    }
    // This warpgroup's q products have retired (and warpgroup 2's reads of
    // xn are ordered before the residual's TMA): xn may take the residual.
    __syncwarp();
    fence_async_shared();
    if (lane == 0) mbar_arrive(qdone_bar);
    // Until the products need att, help the attention warps with it.
    attention_chunks<SW, HD>(att, rows, qready_bar, attready_bar, kv_rows, work, k, v, SA, C,
                             ny, scale, lane, 0, C, 0);

    // 4. proj product, each K-slice once its att is in; bias, residual, y
    // (over the residual in xn, stored by TMA; warpgroup 2's few rows
    // straight to device memory).
    for (int i = 0; i < S; ++i) {
      const int n0 = i * XBW;
      if (first) {
        float acc[XBW / 2];
        slice_product<SW>(acc, ring, STAGE, full_bar, empty_bar, 0, nst, KC, 0, KC, att.main,
                          attready_bar, false, seq, lane, false, 0);
        if (i == 0) mbar_wait(res_bar, 0);
#pragma unroll
        for (int g = 0; g < XBW / 8; g += EPI_GROUP) {
          __nv_bfloat162 bv[EPI_GROUP];
#pragma unroll
          for (int jj = 0; jj < EPI_GROUP; ++jj) {
            const int n = n0 + (g + jj) * 8 + 2 * q4;
            bv[jj] = n < C ? *reinterpret_cast<const __nv_bfloat162*>(bproj + n)
                           : __floats2bfloat162_rn(0.f, 0.f);
          }
#pragma unroll
          for (int jj = 0; jj < EPI_GROUP; ++jj) {
            const int j = g + jj, col = n0 + 8 * j;
            if (col < C) {  // columns past C belong to no buffer column
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t addr = xn.unit(r0 + 8 * h, col) + q4 * 4;
                // bf16(acc), then bf16(t + bias), then bf16(x + t).
                __nv_bfloat162 t2 = __hadd2(
                    __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), bv[jj]);
                const uint32_t rw = lds32(addr);
                t2 = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&rw), t2);
                sts32(addr, *reinterpret_cast<uint32_t*>(&t2));
              }
            }
          }
        }
        fence_async_shared();
        named_bar_sync(2, 128);
        if (t == 0) {
          for (int bx = 0; bx < XBW / 64 && n0 + bx * 64 < C; ++bx)
            tma_store_2d(&map_y, xn.main + ((n0 >> 6) + bx) * XCHUNK, n0 + bx * 64, m0);
          bulk_commit();
        }
      } else {
        float acc1[4][4];
        slice_product8<SW>(acc1, ring, STAGE, full_bar, empty_bar, 0, nst, KC, 0, KC, att.ext,
                           attready_bar, false, seq, warp, lane);
        if (i == 0) mbar_wait(res_bar, 0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c8 = n0 + 32 * warp + 8 * nt, col = c8 + 2 * q4;
          if (c8 < C && r1 < rows) {
            const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bproj + col);
            __nv_bfloat162 t2 = __hadd2(__floats2bfloat162_rn(acc1[nt][0], acc1[nt][1]), b2);
            const uint32_t rw = lds32(xn.unit(r1, c8) + q4 * 4);
            t2 = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&rw), t2);
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r1) * C + col) = t2;
          }
        }
      }
    }
    if (first && t == 0) bulk_wait_all();
  }
}

template <int HD>
cudaError_t launch_cross(const CUtensorMap& mx, const CUtensorMap& mx8, const CUtensorMap& mwq,
                         const CUtensorMap& mwp, const CUtensorMap& my, bf16* y,
                         const float* lns, const float* lnb, const bf16* bq, const bf16* k,
                         const bf16* v, const bf16* bproj, int M, int N, int C, int ny, int nst,
                         int G, int ext, float eps, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      cross_block_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, XSMEM_MAX);
  if (attr != cudaSuccess) return attr;
  cross_block_kernel<HD><<<G, XTHREADS, cross_smem_bytes(C, nst, ext), stream>>>(
      mx, mx8, mwq, mwp, my, y, lns, lnb, bq, k, v, bproj, M, N, C, ny, nst, G, ext, eps, scale);
  return cudaGetLastError();
}

// ---- The streamed plan ----

// The rows' LayerNorm statistics, fp32 mean and rstd, into `stats`
// (float2 a row) for the tile's rows 0 .. nrows - 1 from x in device
// memory, by the 15 warps past the producer's, two rows a warp at a time,
// lane l reading the row's 16-byte units l, l + 32, ...: ln_tile's sums
// (and gemm.cuh's ln_rows_kernel's) in the same order, so LN(x) is the
// resident plan's to the bit. A row past M is a row of zeros there
// (TMA's fill): mean 0, rstd rsqrt(eps).
__device__ __forceinline__ void ln_stats(const bf16* __restrict__ x, int m0, int M, int C,
                                         int nrows, float eps, uint32_t stats, int lane) {
  constexpr int WARPS = XTHREADS / 32 - 1;
  for (int r1 = (threadIdx.x >> 5) - 1; r1 < nrows; r1 += XLN_ROWS * WARPS) {
    uint4 raw[XLN_ROWS][XST_VEC];
    float mean[XLN_ROWS], rstd[XLN_ROWS];
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) {
      const int m = m0 + r1 + q * WARPS;
      const bool in = r1 + q * WARPS < nrows && m < M;
      const bf16* xr = x + (size_t)(in ? m : 0) * C;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < XST_VEC; ++i) {
        const int c0 = (i * 32 + lane) * 8;
        raw[q][i] = make_uint4(0u, 0u, 0u, 0u);
        if (c0 < C) {
          if (in) raw[q][i] = __ldg(reinterpret_cast<const uint4*>(xr + c0));
          float e[8];
          unpack8(raw[q][i], e);
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += e[j];
        }
      }
      mean[q] = sum;
    }
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) mean[q] = warp_sum(mean[q]) / (float)C;
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < XST_VEC; ++i) {
        if ((i * 32 + lane) * 8 < C) {
          float e[8];
          unpack8(raw[q][i], e);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = e[j] - mean[q];
            sq += d * d;
          }
        }
      }
      rstd[q] = sq;
    }
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) rstd[q] = rsqrtf(warp_sum(rstd[q]) / (float)C + eps);
#pragma unroll
    for (int q = 0; q < XLN_ROWS; ++q) {
      const int r = r1 + q * WARPS;
      if (lane == 0 && r < nrows) sts_f2(stats + r * 8, mean[q], rstd[q]);
    }
  }
}

// LN(x) of K-chunk kc (columns 64 kc .. 64 kc + 63), in place in a ring
// stage's A part: rows 0-63 at `a`, 64-71 at `a1` where `two`; the rows'
// mean and rstd from `stats`. Helper warp hw of nw takes the 16-byte
// units hw * 32 + lane, + nw * 32, ...; each lane keeps one 8-column group
// (lane % 8), so it loads its LN scale and shift once. As ln_tile: fp32
// affine, bf16; columns past C written as zeros.
__device__ __forceinline__ void ln_chunk(uint32_t a, uint32_t a1, bool two, int kc,
                                         uint32_t stats, const float* __restrict__ lns,
                                         const float* __restrict__ lnb, int C, int hw, int nw,
                                         int lane) {
  const int c8 = lane & 7, col = kc * 64 + c8 * 8;
  float ga[8], be[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 g4 = col < C ? __ldg(reinterpret_cast<const float4*>(lns + col) + h)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b4 = col < C ? __ldg(reinterpret_cast<const float4*>(lnb + col) + h)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    ga[4 * h] = g4.x, ga[4 * h + 1] = g4.y, ga[4 * h + 2] = g4.z, ga[4 * h + 3] = g4.w;
    be[4 * h] = b4.x, be[4 * h + 1] = b4.y, be[4 * h + 2] = b4.z, be[4 * h + 3] = b4.w;
  }
  const int units = (two ? XRT : XR) * 8;
  for (int u = hw * 32 + lane; u < units; u += nw * 32) {
    const int r = u >> 3;
    const uint32_t addr = (r < XR ? a + r * 128 : a1 + (r - XR) * 128) + ((c8 ^ (r & 7)) << 4);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);  // padding columns: zeros
    if (col < C) {
      float e[8];
      unpack8(lds128(addr), e);
      const float2 st = lds_f2(stats + r * 8);
      bf16* ho = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int j = 0; j < 8; ++j) ho[j] = f2bf((e[j] - st.x) * st.y * ga[j] + be[j]);
    }
    sts128(addr, o);
  }
}

// y = x + proj(attn(q(LN(x)), k, v)) with LN(x) streamed: block b takes
// tile b / cl (rows as in cross_block_kernel, GT tiles) and, in a cluster
// of cl = 2, the columns of its rank's heads (split_col); with cl = 1 all
// of them. Both products run over the block's own 128-column N-slices
// with K = C. The q product's A operand comes K-chunk by K-chunk with the
// weight's stage: x by TMA, normalised in place by the helper warps. att
// of the own columns stays in shared memory; the proj product reads the
// peer's K-chunks through distributed shared memory, copied into the
// stage by the helpers. The residual comes by TMA per output slice into
// the staging buffer, where y is made and TMA-stored.
template <int HD>
__global__ void __launch_bounds__(XTHREADS, 1) cross_block_kernel_streamed(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_x8,
    const __grid_constant__ CUtensorMap map_wq, const __grid_constant__ CUtensorMap map_wp,
    const __grid_constant__ CUtensorMap map_y, bf16* __restrict__ y, const bf16* __restrict__ x,
    const float* __restrict__ lns, const float* __restrict__ lnb, const bf16* __restrict__ bq,
    const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ bproj,
    int M, int N, int C, int ny, int nst, int GT, int ext, int cl, float eps, float scale) {
  constexpr int SW = HD > XBW ? HD : XBW;  // attention slices: whole heads
  constexpr int UPR = SW / (HD < 32 ? HD : 32);  // attention units per row of a slice
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t rank = cl == 2 ? cluster_rank() : 0;
  const int tile = blockIdx.x / cl;
  const int cs = cl == 2 ? split_col(C, HD) : C;
  const int c0 = rank ? cs : 0, c1 = rank ? C : cs;  // this block's columns
  const int KC = x_chunks(C);                        // K-chunks of both products
  const int KCA = x_chunks(cs);                      // att's chunks: rank 0's share, the larger
  const int lo = c0 / 64, hi = lo + x_chunks(c1 - c0);  // this block's K-chunks of att
  const int plo = rank ? 0 : cs / 64;                // the peer's first K-chunk
  const int S = (c1 - c0 + XBW - 1) / XBW;           // own N-slices of each product
  const int SA = (c1 - c0 + SW - 1) / SW;            // own attention slices
  const int m0 = ext ? (int)((long long)M * tile / GT) : tile * XR;
  const int rows = ext ? (int)((long long)M * (tile + 1) / GT) - m0 : min(XR, M - m0);
  const bool two = rows > XR;  // the second consumer warpgroup has rows
  const uint32_t stage_bytes = stream_stage_bytes(ext);
  const TileBuf att = {base, base + KCA * XCHUNK};  // q; then att
  const uint32_t ring = att.ext + (ext ? KCA * XCHUNK1 : 0);
  const TileBuf stg = {ring + nst * stage_bytes, ring + nst * stage_bytes + 2 * XCHUNK};
  const uint32_t full_bar = stg.ext + (ext ? 2 * XCHUNK1 : 0);  // [nst]: a stage has landed
  const uint32_t empty_bar = full_bar + nst * 8;        // [nst]: a stage is free
  const uint32_t aready_bar = empty_bar + nst * 8;      // [nst]: the helpers filled its A part
  const uint32_t qready_bar = aready_bar + nst * 8;     // [XSL]: a slice's q is in att
  const uint32_t attready_bar = qready_bar + XSL * 8;   // [XSL]: a slice's att is in
  const uint32_t peer_bar = attready_bar + XSL * 8;     // [XSL]: the peer's slice's att is in
  const uint32_t resfull_bar = peer_bar + XSL * 8;      // the residual has landed in staging
  const uint32_t resempty_bar = resfull_bar + 8;        // staging may take the next residual
  const uint32_t stats = resempty_bar + 8;              // [XRT] float2: mean, rstd
  unsigned long long* kv_rows =
      reinterpret_cast<unsigned long long*>(smem_raw + (stats + XRT * 8 - smem_u32(smem_raw)));
  int* work = reinterpret_cast<int*>(kv_rows + XRT);
  const int wg = threadIdx.x >> 7, warp_id = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cw = two ? 8 : 4;   // consumer warps with rows
  const int nw = two ? 7 : 11;  // helper warps: 1-3, warpgroup 3 and, without rows, 2
  const int hw = warp_id >= 12 ? warp_id - 9 : warp_id - 1;  // 0-2, then 3-6, then 7-10
  const int cps = (rows * UPR + 31) / 32;  // attention chunks per slice (the peer's too)
  const uint32_t peer_arrive = cl == 2 ? map_peer(peer_bar, rank ^ 1) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, cw);
      mbar_init(aready_bar + 8 * s, nw);
    }
    for (int i = 0; i < XSL; ++i) {
      mbar_init(qready_bar + 8 * i, cw * (SW / XBW));  // each product slice's warps
      mbar_init(attready_bar + 8 * i, cps);
      mbar_init(peer_bar + 8 * i, cps);
    }
    mbar_init(resfull_bar, 1);
    mbar_init(resempty_bar, two ? 5 : 1);  // warpgroup 1's storing thread, warpgroup 2's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *work = 0;
  }
  if (threadIdx.x < XRT)  // a row past M reads row M - 1's keys and stores nothing
    kv_rows[threadIdx.x] = (unsigned long long)(min(m0 + (int)threadIdx.x, M - 1) / N) * ny * C;
  // The peer's mbarriers are initialised before any arrival on them.
  if (cl == 2)
    cluster_sync();
  else
    __syncthreads();

  const bool consumer = wg == 1 || (wg == 2 && two);
  if (threadIdx.x == 0) {
    // Producer: the q product's stages (W_q's K-slice and the x chunk),
    // then proj's (W_proj's), and each proj slice's residual.
    const uint32_t xbytes = XCHUNK + (two ? XCHUNK1 : 0);
    int seq = 0;
    for (int i = 0; i < S; ++i) {
      const int n0 = c0 + i * XBW;
      for (int kc = 0; kc < KC; ++kc, ++seq) {
        const int slot = seq % nst;
        const uint32_t st = ring + slot * stage_bytes, fb = full_bar + 8 * slot;
        mbar_wait(empty_bar + 8 * slot, ((seq / nst) & 1) ^ 1);
        mbar_expect_tx(fb, XWST + xbytes);
        tma_load_2d(st, &map_wq, fb, kc * 64, n0);
        tma_load_2d(st + XWST, &map_x, fb, kc * 64, m0);
        if (two) tma_load_2d(st + XWST + XCHUNK, &map_x8, fb, kc * 64, m0 + XR);
      }
    }
    for (int i = 0; i < S; ++i) {
      const int n0 = c0 + i * XBW;
      for (int kc = 0; kc < KC; ++kc, ++seq) {
        const int slot = seq % nst;
        const uint32_t fb = full_bar + 8 * slot;
        mbar_wait(empty_bar + 8 * slot, ((seq / nst) & 1) ^ 1);
        mbar_expect_tx(fb, XWST);
        tma_load_2d(ring + slot * stage_bytes, &map_wp, fb, kc * 64, n0);
        if (kc == (KC < nst ? KC : nst) - 1) {
          // The slice's residual, once the ring holds its first stages
          // and the previous slice's y has left the staging buffer.
          const int boxes = n0 + 64 < c1 ? 2 : 1;
          mbar_wait(resempty_bar, (i & 1) ^ 1);
          mbar_expect_tx(resfull_bar, boxes * xbytes);
          for (int bx = 0; bx < boxes; ++bx) {
            tma_load_2d(stg.main + bx * XCHUNK, &map_x, resfull_bar, n0 + bx * 64, m0);
            if (two)
              tma_load_2d(stg.ext + bx * XCHUNK1, &map_x8, resfull_bar, n0 + bx * 64, m0 + XR);
          }
        }
      }
    }
  } else if (threadIdx.x >= 32) {
    // The rows' statistics, before any stage is normalised.
    ln_stats(x, m0, M, C, two ? XRT : XR, eps, stats, lane);
    named_bar_sync(1, XTHREADS - 32);
  }
  if (!consumer && threadIdx.x >= 32) {
    // Helpers: LN(x) of every q stage, then the attention, then (cl 2)
    // the peer's att K-chunks into the proj stages.
    int seq = 0;
    for (int i = 0; i < S; ++i) {
      for (int kc = 0; kc < KC; ++kc, ++seq) {
        const int slot = seq % nst;
        const uint32_t st = ring + slot * stage_bytes;
        mbar_wait(full_bar + 8 * slot, (seq / nst) & 1);
        ln_chunk(st + XWST, st + XWST + XCHUNK, two, kc, stats, lns, lnb, C, hw, nw, lane);
        fence_async_shared();  // LN(x) visible to the wgmma (async) proxy
        __syncwarp();
        if (lane == 0) mbar_arrive(aready_bar + 8 * slot);
      }
    }
    attention_chunks<SW, HD>(att, rows, qready_bar, attready_bar, kv_rows, work, k, v, SA, C, ny,
                             scale, lane, c0, c1, peer_arrive);
    if (cl == 2) {
      const uint32_t pmain = map_peer(att.main, rank ^ 1), pext = map_peer(att.ext, rank ^ 1);
      const int units = (two ? XRT : XR) * 8;
      for (int i = 0; i < S; ++i) {
        for (int kc = 0; kc < KC; ++kc, ++seq) {
          const int slot = seq % nst;
          const uint32_t st = ring + slot * stage_bytes + XWST;
          mbar_wait(full_bar + 8 * slot, (seq / nst) & 1);
          if (kc < lo || kc >= hi) {
            // The peer's K-chunk pk, once its attention slice is done,
            // 16 bytes a lane (the same swizzled layout on both sides).
            const int pk = kc - plo;
            mbar_wait_cluster(peer_bar + 8 * (pk * 64 / SW), 0);
            for (int u = hw * 32 + lane; u < units; u += nw * 32) {
              if (u < XR * 8)
                sts128(st + u * 16, ld_cluster128(pmain + pk * XCHUNK + u * 16));
              else
                sts128(st + XCHUNK + (u - XR * 8) * 16,
                       ld_cluster128(pext + pk * XCHUNK1 + (u - XR * 8) * 16));
            }
          }
          fence_async_shared();
          __syncwarp();
          if (lane == 0) mbar_arrive(aready_bar + 8 * slot);
        }
      }
    }
  } else if (consumer) {
    // Consumer warpgroups, as in cross_block_kernel: 1 takes rows 0-63 by
    // wgmma, 2 rows 64 .. rows - 1 by mma.sync.
    const int t = threadIdx.x & 127, warp = t >> 5;
    const bool first = wg == 1;
    const int r0 = warp * 16 + (lane >> 2), q4 = lane & 3;
    const int r1 = XR + (lane >> 2);
    const int pad = (hi - lo) * 64;  // att's columns, padding included
    int seq = 0;

    // 3. q product, slice by slice: q = bf16(bf16(acc) + bq) into att,
    // handed to the attention.
    for (int i = 0; i < S; ++i) {
      const int n0 = c0 + i * XBW;
      if (first) {
        float acc[XBW / 2];
        slice_product<SW>(acc, ring, stage_bytes, full_bar, empty_bar, aready_bar, nst, KC, 0, 0,
                           0, 0, true, seq, lane, false, 0);
#pragma unroll
        for (int j = 0; j < XBW / 8; ++j) {
          if (n0 + 8 * j < c1) {
            const __nv_bfloat162 b2 =
                *reinterpret_cast<const __nv_bfloat162*>(bq + n0 + 8 * j + 2 * q4);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              __nv_bfloat162 t2 = __hadd2(
                  __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), b2);
              sts32(att.unit(r0 + 8 * h, n0 - c0 + 8 * j) + q4 * 4,
                    *reinterpret_cast<uint32_t*>(&t2));
            }
          } else if (n0 - c0 + 8 * j < pad) {
            // att's columns past c1 in its last chunk: zeros, which the
            // proj product multiplies by W_proj's zero-filled columns
#pragma unroll
            for (int h = 0; h < 2; ++h) sts32(att.unit(r0 + 8 * h, n0 - c0 + 8 * j) + q4 * 4, 0u);
          }
        }
      } else {
        float acc1[4][4];
        slice_product8<SW>(acc1, ring, stage_bytes, full_bar, empty_bar, aready_bar, nst, KC, 0,
                            0, 0, 0, true, seq, warp, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c8 = n0 + 32 * warp + 8 * nt;
          if (c8 < c1 && r1 < rows) {
            const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bq + c8 + 2 * q4);
            __nv_bfloat162 t2 = __hadd2(__floats2bfloat162_rn(acc1[nt][0], acc1[nt][1]), b2);
            sts32(att.unit(r1, c8 - c0) + q4 * 4, *reinterpret_cast<uint32_t*>(&t2));
          } else if (c8 - c0 < pad) {
            sts32(att.unit(r1, c8 - c0) + q4 * 4, 0u);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(qready_bar + 8 * ((n0 - c0) / SW));
    }
    // Until the products need att, help the helpers with it.
    attention_chunks<SW, HD>(att, rows, qready_bar, attready_bar, kv_rows, work, k, v, SA, C, ny,
                             scale, lane, c0, c1, peer_arrive);

    // 4. proj product over the own output slices: the own att chunks from
    // shared memory once their attention is done, the peer's from the
    // stage; bias, residual (from staging), y (TMA-stored from staging;
    // warpgroup 2's few rows straight to device memory).
    for (int i = 0; i < S; ++i) {
      const int n0 = c0 + i * XBW;
      if (first) {
        float acc[XBW / 2];
        slice_product<SW>(acc, ring, stage_bytes, full_bar, empty_bar, aready_bar, nst, KC, lo,
                           hi, att.main, attready_bar, cl == 2, seq, lane, i > 0 && t == 0,
                           resempty_bar);
        mbar_wait(resfull_bar, i & 1);
#pragma unroll
        for (int g = 0; g < XBW / 8; g += EPI_GROUP) {
          __nv_bfloat162 bv[EPI_GROUP];
#pragma unroll
          for (int jj = 0; jj < EPI_GROUP; ++jj) {
            const int n = n0 + (g + jj) * 8 + 2 * q4;
            bv[jj] = n < c1 ? *reinterpret_cast<const __nv_bfloat162*>(bproj + n)
                            : __floats2bfloat162_rn(0.f, 0.f);
          }
#pragma unroll
          for (int jj = 0; jj < EPI_GROUP; ++jj) {
            const int j = g + jj;
            if (n0 + 8 * j < c1) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t addr = stg.unit(r0 + 8 * h, 8 * j) + q4 * 4;
                // bf16(acc), then bf16(t + bias), then bf16(x + t).
                __nv_bfloat162 t2 = __hadd2(
                    __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), bv[jj]);
                const uint32_t rw = lds32(addr);
                t2 = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&rw), t2);
                sts32(addr, *reinterpret_cast<uint32_t*>(&t2));
              }
            }
          }
        }
        fence_async_shared();
        named_bar_sync(2, 128);
        if (t == 0) {
          for (int bx = 0; bx < XBW / 64 && n0 + bx * 64 < c1; ++bx)
            tma_store_2d(&map_y, stg.main + bx * XCHUNK, n0 + bx * 64, m0);
          bulk_commit();
        }
      } else {
        float acc1[4][4];
        slice_product8<SW>(acc1, ring, stage_bytes, full_bar, empty_bar, aready_bar, nst, KC, lo,
                            hi, att.ext, attready_bar, cl == 2, seq, warp, lane);
        mbar_wait(resfull_bar, i & 1);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c8 = n0 + 32 * warp + 8 * nt, col = c8 + 2 * q4;
          if (c8 < c1 && r1 < rows) {
            const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bproj + col);
            __nv_bfloat162 t2 = __hadd2(__floats2bfloat162_rn(acc1[nt][0], acc1[nt][1]), b2);
            const uint32_t rw = lds32(stg.unit(r1, c8 - n0) + q4 * 4);
            t2 = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&rw), t2);
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r1) * C + col) = t2;
          }
        }
        // The staging reads (generic proxy) ordered before the next
        // residual's TMA (async proxy).
        __syncwarp();
        fence_async_shared();
        if (lane == 0) mbar_arrive(resempty_bar);
      }
    }
    if (first && t == 0) bulk_wait_all();
  }
  // No block leaves while its peer may still read its att or arrive on
  // its mbarriers.
  if (cl == 2) cluster_sync();
}

template <int HD>
cudaError_t launch_cross_streamed(const CUtensorMap& mx, const CUtensorMap& mx8,
                                  const CUtensorMap& mwq, const CUtensorMap& mwp,
                                  const CUtensorMap& my, bf16* y, const bf16* x, const float* lns,
                                  const float* lnb, const bf16* bq, const bf16* k, const bf16* v,
                                  const bf16* bproj, int M, int N, int C, int ny, int nst, int G,
                                  int ext, int cl, float eps, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      cross_block_kernel_streamed<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, XSMEM_MAX);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(XTHREADS);
  cfg.dynamicSmemBytes = stream_smem_bytes(x_chunks(cl == 2 ? split_col(C, HD) : C), nst, ext);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cross_block_kernel_streamed<HD>, mx, mx8, mwq,
                                             mwp, my, y, x, lns, lnb, bq, k, v, bproj, M, N, C,
                                             ny, nst, G / cl, ext, cl, eps, scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The launch plans. Resident (cross_block_kernel, C <= 768): tiles of
// 64 rows while they all fit on the SMs at once; past that, where shared
// memory has room for the 8-row chunks, one tile an SM (up to 72 rows,
// the last 8 on the second consumer warpgroup, so no SM waits for a
// second wave of tiles); else 64-row tiles. Streamed
// (cross_block_kernel_streamed, C <= 2048): one block a tile (cl 1)
// where att of all C columns fits beside two ring stages (C <= 1280),
// else a cluster of two a tile, each block with the att of its half of
// the heads; tiles of 64 rows, or one tile per SM (per cluster) of up to
// 72 where more tiles than that would be needed and two stages fit.
// mode 0 chooses: the resident plan where it runs every tile in one wave
// (C <= 512 at the decoder's M, any C <= 768 at M <= 64 x SMs), else the
// streamed one; 1 the resident plan, 2 the streamed one, 3 the streamed
// one over 2-block clusters. False where the kernel does not take the
// shape under that mode.
struct CrossPlan {
  int streamed, nst, G, ext, cl, cs;
};

inline bool resident_plan(int M, int C, int sms, CrossPlan* p) {
  if (C > XC_RES) return false;
  const int tiles = (M + XR - 1) / XR;
  const int nst_ext = cross_stages(C, true);
  p->streamed = 0;
  p->cl = 1;
  p->cs = C;
  if (tiles > sms && nst_ext > 0) {
    p->ext = 1;
    p->nst = nst_ext;
    p->G = (M + XRT - 1) / XRT > sms ? (M + XRT - 1) / XRT : sms;
  } else {
    p->ext = 0;
    p->nst = cross_stages(C, false);
    p->G = tiles;
  }
  return p->nst > 0;
}

inline bool streamed_plan(int M, int C, int hd, int sms, int cl, CrossPlan* p) {
  const int cs = cl == 2 ? split_col(C, hd) : C;
  if (cs >= C && cl == 2) return false;  // nothing for rank 1
  const int kca = x_chunks(cs);
  const int nst64 = stream_stages(kca, false), nst72 = stream_stages(kca, true);
  if (nst64 == 0) return false;
  const int slots = sms / cl, tiles = (M + XR - 1) / XR;
  p->streamed = 1;
  p->cl = cl;
  p->cs = cs;
  if (tiles > slots && nst72 > 0) {
    p->ext = 1;
    p->nst = nst72;
    p->G = cl * ((M + XRT - 1) / XRT > slots ? (M + XRT - 1) / XRT : slots);
  } else {
    p->ext = 0;
    p->nst = nst64;
    p->G = cl * tiles;
  }
  return true;
}

inline bool cross_plan(int M, int C, int H, int mode, CrossPlan* p) {
  const int hd = H > 0 ? C / H : 0;
  if (C % 8 != 0 || C <= 0 || C > XC_MAX || hd * H != C || M <= 0) return false;
  const int sms = sm_count();
  switch (mode) {
    case 0: {
      const int tiles = (M + XR - 1) / XR;
      if (C <= XC_RES && (tiles <= sms || cross_stages(C, true) > 0))
        return resident_plan(M, C, sms, p);
      // one block a tile where it has 3 ring stages; past that the
      // cluster's deeper ring is faster (C 1024 and 1280 at M 9216)
      if (streamed_plan(M, C, hd, sms, 1, p) && p->nst >= 3) return true;
      return streamed_plan(M, C, hd, sms, 2, p) || streamed_plan(M, C, hd, sms, 1, p);
    }
    case 1:
      return resident_plan(M, C, sms, p);
    case 2:
      return streamed_plan(M, C, hd, sms, 1, p) || streamed_plan(M, C, hd, sms, 2, p);
    case 3:
      return streamed_plan(M, C, hd, sms, 2, p);
    default:
      return false;
  }
}

}  // namespace

extern "C" {

// y = x + proj(attn(q(LN(x)), k, v)) for x [B, N, C] bf16 and k, v
// [B, ny, C] bf16, all pointers device pointers, 16-byte aligned: lns, lnb
// fp32 [C]; wq, wproj bf16 [C, C] ([out, in]); bq, bproj bf16 [C]; y bf16
// [B, N, C]. Requires C % 8 == 0, C <= 2048, 1 <= ny <= 8 and C / H in
// {8, 16, 32, 64, 128, 256}; `mode` as cross_plan's (0: by shape). One
// kernel launch. Returns cudaGetLastError() (0 on success).
int cross_block_forward(const void* x, const void* lns, const void* lnb, const void* wq,
                        const void* bq, const void* k, const void* v, const void* wproj,
                        const void* bproj, void* y, int B, int N, int C, int H, int ny,
                        float eps, float scale, int mode, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * N;
  CrossPlan p;
  if (ny < 1 || ny > XK_MAX || !cross_plan(M, C, H, mode, &p)) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mx8, mwq, mwp, my;
  cudaError_t err;
  if ((err = make_map(&mx, (const bf16*)x, M, C, XR, 64)) != cudaSuccess ||
      (err = make_map(&mx8, (const bf16*)x, M, C, XR1, 64)) != cudaSuccess ||
      (err = make_map(&mwq, (const bf16*)wq, C, C, XBW, 64)) != cudaSuccess ||
      (err = make_map(&mwp, (const bf16*)wproj, C, C, XBW, 64)) != cudaSuccess ||
      (err = make_map(&my, (const bf16*)y, M, C, XR, 64)) != cudaSuccess)
    return (int)err;
  const float *sc = (const float*)lns, *sh = (const float*)lnb;
  const bf16 *xp = (const bf16*)x, *b1 = (const bf16*)bq, *kp = (const bf16*)k,
             *vp = (const bf16*)v, *b2 = (const bf16*)bproj;
  bf16* yp = (bf16*)y;
#define CROSS_CASE(HDV)                                                                       \
  case HDV:                                                                                     \
    err = p.streamed                                                                            \
              ? launch_cross_streamed<HDV>(mx, mx8, mwq, mwp, my, yp, xp, sc, sh, b1, kp, vp, b2, \
                                           M, N, C, ny, p.nst, p.G, p.ext, p.cl, eps, scale, s) \
              : launch_cross<HDV>(mx, mx8, mwq, mwp, my, yp, sc, sh, b1, kp, vp, b2, M, N, C, ny,  \
                                  p.nst, p.G, p.ext, eps, scale, s);                            \
    break;
  switch (C / H) {
    CROSS_CASE(8)
    CROSS_CASE(16)
    CROSS_CASE(32)
    CROSS_CASE(64)
    CROSS_CASE(128)
    CROSS_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CROSS_CASE
  return (int)err;
}

// The launch plan for M rows of width C over H heads under `mode`: out[0]
// the N-slice width, out[1] ring stages, out[2] dynamic shared bytes per
// block, out[3] blocks, out[4] rows per block at most (64, or up to 72),
// out[5] 1 where LN(x) is streamed (0: resident), out[6] blocks per
// cluster (1 or 2), out[7] the first column of rank 1's heads (C where
// out[6] is 1). Returns 0, or cudaErrorInvalidValue where the kernel does
// not take the shape.
int cross_block_plan(int M, int C, int H, int mode, int* out) {
  CrossPlan p;
  if (!cross_plan(M, C, H, mode, &p)) return (int)cudaErrorInvalidValue;
  out[0] = XBW;
  out[1] = p.nst;
  out[2] = (int)(p.streamed ? stream_smem_bytes(x_chunks(p.cs), p.nst, p.ext)
                            : cross_smem_bytes(C, p.nst, p.ext));
  out[3] = p.G;
  out[4] = p.ext ? (M + p.G / p.cl - 1) / (p.G / p.cl) : XR;
  out[5] = p.streamed;
  out[6] = p.cl;
  out[7] = p.cs;
  return 0;
}

const char* cross_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
