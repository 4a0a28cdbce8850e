// Kernels B3 and B4: self-attention over projected q/k/v [B, N, C]
// (packed as qkv [B*N, 3C]), forward and backward, bf16, for Hopper
// (sm_90a).
//
// B3 (attn_forward) replaces countr_tpu/ops/pallas_attn.py::_attn_kernel
// (launched by _fused). It runs the attention core of attention.cuh
// (launch_attn_any), which kernel B2 runs too and which computes exactly
// B3's function: each head's K and V resident in shared memory up to
// attn_resident_max_n<HD>() keys (832 at hd 64), two passes over keys
// streamed from device memory past it. That header says what bounds the
// core and what its design does about it.
//
// B4 (attn_backward) replaces pallas_attn.py::_attn_bwd_kernel (launched
// by _fused_bwd), B3's VJP: for each (batch, head), with s = q k^T * hd^-0.5
// in fp32 (natural exp, not exp2),
//   P  = exp(s - rowmax) / rowsum, fp32
//   dV = bf16(P)^T dO            (fp32 accumulation)
//   dP = dO V^T                  (fp32)
//   D  = rowsum(dP * P)          (fp32 P and dP)
//   dS = bf16(((dP - D) * P) * hd^-0.5)
//   dQ = dS K,  dK = dS^T Q      (fp32 accumulation)
// and dq | dk | dv are written into one [B*N, 3C] buffer, the gradient of
// the packed qkv. P is formed as one exp2 per (query, key) pair, of
// fma(s_raw, hd^-0.5 * log2(e), -(m2 + log2 l)) with m2 the row max in that
// unit and l the row sum: exp(s - m) / l without a division.
//
// What bounds B4 on the H100: its own work is 10 * B * N^2 * C FLOP (five
// N x N x hd products per head), 13.6 GFLOP at the decoder's [8, 576, 512]
// (13.7 us at 989 TFLOP/s), against 33 MB of q, k, v, dO read and dq, dk,
// dv written (9.9 us at 3.35 TB/s). The design makes 7 products per pair
// (2 in the statistics, 5 in the main pass) and runs at about 7x the
// bound (scripts/profile_torch_attn.py, PERF.md). The special-function unit does
// not bound it (taking the exp2 out saves 2%). The main pass is bound by
// the latency of each warpgroup's chain per step (products, then P and
// dS, then products, then dQ for one query block in three), which three
// warpgroups per SM overlap; the statistics kernel is a third of the time.
//
// What the design does about it: two kernels on the caller's stream.
//   1. bwd_stats_kernel: one block per (b, h, 64 queries), mma.sync; one
//      sweep over 64-key chunks (QK^T and dO V^T) keeps, per thread and
//      row, an online max m2, sum l and unnormalised D' = sum p * dP,
//      rescaled by exp2(m_old - m_new) when the max grows; the four
//      threads of a row merge theirs at the end. It writes (m2 + log2 l,
//      D'/l) per query row to fp32 scratch, (+inf, 0) for the rows past N
//      of the last block, so P is 0 there.
//   2. bwd_main_kernel: one block per (b, h), so it owns every output of
//      the head and needs no atomics: the result is the same bits on every
//      run. Three consumer warpgroups each hold a 64-key block (K and V in
//      shared memory, double-buffered across rounds of three blocks) and
//      walk every 64-query block: S^T = K Q^T and dP^T = V dO^T (wgmma SS),
//      P^T formed once in registers, dV += bf16(P^T) dO and dK += bf16(dS^T)
//      Q (wgmma RS, P and dS from registers). Each stages its bf16 dS^T in
//      shared memory and signals an mbarrier; the warpgroup that owns the
//      query block (qb % 3) waits for the round's tiles and adds
//      dQ += dS K over the round's key blocks in one wgmma chain (A read
//      transposed from the staged dS^T), on an fp32 accumulator that it
//      keeps between rounds in scratch that only it reads and writes, in
//      round order, and stores bf16 dQ in the last round; the others go
//      on to the next step meanwhile. A producer warp streams Q, dO (TMA,
//      zero-filled past N) and the row statistics (bulk copy) through a
//      3-stage mbarrier ring, and the next round's K and V ahead of it.
//      At head dim 80 (ViT-H/14) the tiles come in two swizzled parts
//      (attention.cuh head_part) and two warpgroups hold a key block each
//      (bwd_wg): three would not fit shared memory or the register file.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface, bound
//        with ctypes; each entry returns cudaGetLastError().

#include "attention.cuh"

namespace {

constexpr int BT = 64;          // rows of a block tile and of a chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BWD_STAGES = 3;   // Q / dO / statistics ring
constexpr int STAT_FLOATS = 2 * BT;  // m2 + log2 l, D of one query block

// Consumer warpgroups of the main pass, a key block each: 3, or 2 at head
// dim 80, where three would need 236 KB of shared memory (over the 227 KB
// a block may take) and hold 144 accumulator registers a thread (dK, dV,
// S^T, dP^T) under the 152 that 416 threads may have.
template <int HD>
__host__ __device__ constexpr int bwd_wg() {
  return HD == 80 ? 2 : 3;
}
template <int HD>
__host__ __device__ constexpr int bwd_threads() {
  return 128 * bwd_wg<HD>() + 32;  // + one producer warp
}

// ---- pass 1: row statistics (mma.sync) ----

// cp.async a [64, HD] tile: rows r0.. of a row-major matrix (row stride
// `stride` elements, `src` already at the head's first column) into
// dst [64][HD + 8]; rows past N are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride,
                                          int r0, int N, int tid) {
  constexpr int HV = HD / 8, LDH = HD + 8;
  for (int i = tid; i < BT * HV; i += ATTN_THREADS) {
    const int r = i / HV, c = (i % HV) * 8, n = r0 + r;
    const bool p = n < N;
    cp_async16(dst + r * LDH + c, p ? src + (size_t)n * stride + c : src, p);
  }
}

// A operand fragments (16 rows x HD) of rows row0.. of a [64][HD + 8] tile.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&f)[HD / 16][4], const bf16* s, int row0,
                                       int lane) {
  constexpr int LDH = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(f[kk], s + (row0 + (lane & 15)) * LDH + kk * 16 + (lane >> 4) * 8);
}

// acc[16 x 64] += A[16 x HD] . B^T, B a [64][HD + 8] tile (rows = the
// output's columns).
template <int HD>
__device__ __forceinline__ void mma_abt(float (&acc)[BT / 8][4],
                                        const uint32_t (&a)[HD / 16][4], const bf16* bs,
                                        int lane) {
  constexpr int LDH = HD + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j2 = 0; j2 < BT / 16; ++j2) {
      uint32_t r[4];
      ldmatrix_x4(r, bs + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDH + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * j2], a[kk], r[0], r[1]);
      mma16816(acc[2 * j2 + 1], a[kk], r[2], r[3]);
    }
  }
}

template <int N_>
__device__ __forceinline__ void zero(float (&a)[N_][4]) {
#pragma unroll
  for (int i = 0; i < N_; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD>
__host__ __device__ constexpr size_t stats_smem_bytes() {
  return (size_t)6 * BT * (HD + 8) * sizeof(bf16);  // Q, dO, 2 x (K, V)
}

// stats [B*H][nq][2][64] = (m2 + log2 l, D) per query row, m2 the row
// max of s * scale2 (scale2 = hd^-0.5 * log2 e), l = sum exp2(s * scale2 -
// m2), D = sum exp2(s * scale2 - m2) / l * dP; (+inf, 0) for rows past N,
// so that P = exp2(s * scale2 - (m2 + log2 l)) is 0 there.
template <int HD>
__global__ void __launch_bounds__(ATTN_THREADS) bwd_stats_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout, float* __restrict__ stats,
    int N, int C, int H, float scale2) {
  constexpr int LDH = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + BT * LDH;
  bf16* Ks = Gs + BT * LDH;      // [2][BT][LDH]
  bf16* Vs = Ks + 2 * BT * LDH;  // [2][BT][LDH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t4 = lane & 3;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * rs;
  const int nchunks = (N + BT - 1) / BT;

  load_tile<HD>(Qs, base + h * HD, rs, q0, N, tid);
  load_tile<HD>(Gs, dout + (size_t)b * N * C + h * HD, C, q0, N, tid);
  auto load = [&](int t) {
    load_tile<HD>(Ks + (t & 1) * BT * LDH, base + C + h * HD, rs, t * BT, N, tid);
    load_tile<HD>(Vs + (t & 1) * BT * LDH, base + 2 * C + h * HD, rs, t * BT, N, tid);
  };
  load(0);
  cp_async_commit();

  uint32_t qf[HD / 16][4], gf[HD / 16][4];
  // This thread's share of its two rows: running max, sum and D'.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  for (int t = 0; t < nchunks; ++t) {
    if (t + 1 < nchunks) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_a<HD>(qf, Qs, warp * 16, lane);
      load_a<HD>(gf, Gs, warp * 16, lane);
    }
    float sc[BT / 8][4], dp[BT / 8][4];
    zero(sc);
    zero(dp);
    mma_abt<HD>(sc, qf, Ks + (t & 1) * BT * LDH, lane);  // s = Q K^T
    mma_abt<HD>(dp, gf, Vs + (t & 1) * BT * LDH, lane);  // dP = dO V^T
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // The chunk's max of the raw logits (scale2 > 0 keeps the order).
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * BT + j * 8 + t4 * 2 + e;
          const float sv = key < N ? sc[j][2 * hh + e] : -CUDART_INF_F;
          sc[j][2 * hh + e] = sv;
          mc = fmaxf(mc, sv);
        }
      const float m2 = fmaxf(m[hh], __fmul_rn(mc, scale2));
      // A thread may have seen only keys past N so far: its max is -inf,
      // and exp2 against 0 keeps its terms 0 instead of NaN.
      const float mu = m2 == -CUDART_INF_F ? 0.f : m2;
      const float alpha = ex2(m[hh] - mu);
      l[hh] = __fmul_rn(l[hh], alpha);
      dsum[hh] = __fmul_rn(dsum[hh], alpha);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(sc[j][2 * hh + e], scale2, -mu));
          l[hh] += p;
          dsum[hh] = fmaf(p, dp[j][2 * hh + e], dsum[hh]);
        }
      m[hh] = m2;
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  float* st = stats + ((size_t)(b * H + h) * gridDim.x + blockIdx.x) * STAT_FLOATS;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float mx = quad_max(m[hh]);  // finite: key 0 is in every row
    const float f = ex2(m[hh] - mx);
    const float lt = quad_sum(__fmul_rn(l[hh], f)), dt = quad_sum(__fmul_rn(dsum[hh], f));
    const int r = warp * 16 + (lane >> 2) + hh * 8;
    if (t4 == 0) {
      const bool ok = q0 + r < N;
      st[r] = ok ? mx + log2f(lt) : CUDART_INF_F;
      st[BT + r] = ok ? __fdiv_rn(dt, lt) : 0.f;
    }
  }
}

// ---- pass 2: P, dV, dP, dS, dK and dQ, each once per pair (wgmma + TMA) ----

// d += A . B with A and B both read MN-major from shared memory (A's rows
// contiguous: dS^T staged as [keys][queries]; B: K as [keys][hd]),
// m64 x n(HD) x k16 for a one-part tile.
__device__ __forceinline__ void wgmma_ss_tt_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_tt_m64n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_tt_m64n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <int HD>
__device__ __forceinline__ void wgmma_ss_tt_part(float (&d)[HD / 2], uint64_t da, uint64_t db) {
  if constexpr (HD == 64)
    wgmma_ss_tt_m64n64(d, da, db);
  else if constexpr (HD == 32)
    wgmma_ss_tt_m64n32(d, da, db);
  else
    wgmma_ss_tt_m64n16(d, da, db);
}
// The same with B rows 16kk .. 16kk + 15 of a head tile (head_part): at
// head dim 80 an n64 and an n16 product into d[0..31] and d[32..39].
template <int HD>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[HD / 2], uint64_t da, uint32_t tile,
                                            int kk) {
  constexpr int A = head_part<HD>();
  if constexpr (A == HD) {
    wgmma_ss_tt_part<HD>(d, da, swz_desc<HD>(tile + kk * 16 * HD * 2));
  } else {
    wgmma_ss_tt_part<A>(*reinterpret_cast<float(*)[A / 2]>(&d[0]), da,
                        swz_desc<A>(tile + kk * 16 * A * 2));
    wgmma_ss_tt_part<HD - A>(*reinterpret_cast<float(*)[(HD - A) / 2]>(&d[A / 2]), da,
                             swz_desc<HD - A>(tile + 64 * A * 2 + kk * 16 * (HD - A) * 2));
  }
}

// Bulk copy of `bytes` (a multiple of 16) global -> shared, completing
// `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int N_>
__device__ __forceinline__ void zero_acc(float (&a)[N_]) {
#pragma unroll
  for (int i = 0; i < N_; ++i) a[i] = 0.f;
}

// bf16 rows of a 64 x HD accumulator (rows row0 + 16*(warp%4) + lane/4
// (+8), the wgmma layout) into `out` (row stride `stride` elements,
// already at the head's first column); rows at or past N are skipped.
template <int HD>
__device__ __forceinline__ void store_acc(bf16* out, size_t stride, const float (&acc)[HD / 2],
                                          int row0, int N, int qw, int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = row0 + qw * 16 + (lane >> 2) + hh * 8;
    if (n >= N) continue;
    bf16* o = out + (size_t)n * stride + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      __nv_bfloat162 v;
      v.x = f2bf(acc[4 * j + 2 * hh]);
      v.y = f2bf(acc[4 * j + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = v;
    }
  }
}

constexpr uint32_t DS_TILE = BT * BT * sizeof(bf16);  // a staged 64 x 64 bf16 dS^T

// 1 KB alignment slack; K and V of 2 rounds x bwd_wg key blocks; the ring
// of Q and dO tiles; 2 x bwd_wg staged dS^T tiles; the ring's statistics; the
// barriers: 199,280 bytes at HD = 64, 178,800 at HD = 80 (2 warpgroups).
template <int HD>
__host__ __device__ constexpr size_t main_smem_bytes() {
  return 1024 + (size_t)(4 * bwd_wg<HD>() + 2 * BWD_STAGES) * BT * HD * sizeof(bf16) +
         2 * bwd_wg<HD>() * DS_TILE + BWD_STAGES * STAT_FLOATS * sizeof(float) +
         (2 * BWD_STAGES + 8) * 8;
}

// One block per (b, h) = blockIdx.x / H, % H. Round r holds key blocks
// BWD_WG * r + w (warpgroup w); every round walks the query blocks
// qb = 0 .. nq - 1. The wgmma accumulator layout: warp w of
// a warpgroup holds rows 16w + lane/4 (+ 8), columns 8j + 2*(lane%4) +
// {0, 1} at registers 4j + {0, 1} (+ 2). dq_acc holds, per (b, h) and
// query block, the owning warpgroup's fp32 dQ registers (register e of
// thread t at e * 128 + t).
template <int HD>
__global__ void __launch_bounds__(bwd_threads<HD>(), 1) bwd_main_kernel(
    const __grid_constant__ HeadMaps<HD> qkv_map, const __grid_constant__ HeadMaps<HD> do_map,
    const float* __restrict__ stats, float* __restrict__ dq_acc, bf16* __restrict__ dqkv,
    int N, int C, int H, float scale, float scale2) {
  constexpr int BWD_WG = bwd_wg<HD>();
  constexpr uint32_t TILE = BT * HD * 2;
  constexpr int CONSUMERS = 128 * BWD_WG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // 1024-aligned
  const uint32_t kv_s = smem_u32(sm);  // [2 rounds][K, V][BWD_WG] tiles
  const uint32_t ring_s = kv_s + 4 * BWD_WG * TILE;  // [BWD_STAGES][Q, dO] tiles
  const uint32_t ds_s = ring_s + 2 * BWD_STAGES * TILE;  // [2][BWD_WG] dS^T tiles
  float* St = reinterpret_cast<float*>(sm + 4 * BWD_WG * TILE + 2 * BWD_STAGES * TILE +
                                       2 * BWD_WG * DS_TILE);  // [BWD_STAGES][2][64]
  const uint32_t st_s = smem_u32(St);
  const uint32_t full_bar = st_s + BWD_STAGES * STAT_FLOATS * sizeof(float);
  const uint32_t empty_bar = full_bar + 8 * BWD_STAGES;
  const uint32_t kv_full = empty_bar + 8 * BWD_STAGES, kv_empty = kv_full + 16;  // [2] each
  const uint32_t ds_full = kv_empty + 16, ds_empty = ds_full + 16;  // [2] each
  auto k_tile = [&](int buf, int f) { return kv_s + (buf * 2 * BWD_WG + f) * TILE; };
  auto v_tile = [&](int buf, int f) { return kv_s + (buf * 2 * BWD_WG + BWD_WG + f) * TILE; };

  // The warp index through a shuffle, so the compiler sees it (and the
  // warpgroup index) uniform across the warp: wgmma on a path it cannot
  // prove uniform is serialized.
  const int tid = threadIdx.x, lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nq = (N + BT - 1) / BT, rounds = (nq + BWD_WG - 1) / BWD_WG;

  if (tid == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * BWD_WG);  // every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, 4 * BWD_WG);
      mbar_init(ds_full + 8 * i, CONSUMERS);  // every consumer thread, its part staged
      mbar_init(ds_empty + 8 * i, 128);       // the dQ warpgroup, done reading
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * BWD_WG) {
    // Producer: each round's K and V into its buffer once the round
    // before last has let it go, then the round's Q, dO and statistics
    // of every query block, a ring stage each.
    if (lane == 0) {
      const float* st_bh = stats + (size_t)bh * nq * STAT_FLOATS;
      for (int r = 0; r < rounds; ++r) {
        const int buf = r & 1, active = min(BWD_WG, nq - r * BWD_WG);
        mbar_wait(kv_empty + 8 * buf, ((r >> 1) & 1) ^ 1);
        mbar_expect_tx(kv_full + 8 * buf, active * 2 * TILE);
        for (int f = 0; f < active; ++f) {
          const int k0 = (r * BWD_WG + f) * BT;
          tma_load_head<HD>(k_tile(buf, f), qkv_map, kv_full + 8 * buf, C + h * HD, k0, b);
          tma_load_head<HD>(v_tile(buf, f), qkv_map, kv_full + 8 * buf, 2 * C + h * HD, k0, b);
        }
        for (int qb = 0; qb < nq; ++qb) {
          const int g = r * nq + qb, s = g % BWD_STAGES;
          mbar_wait(empty_bar + 8 * s, ((g / BWD_STAGES) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * s, 2 * TILE + STAT_FLOATS * sizeof(float));
          const uint32_t q_t = ring_s + 2 * s * TILE;
          tma_load_head<HD>(q_t, qkv_map, full_bar + 8 * s, h * HD, qb * BT, b);
          tma_load_head<HD>(q_t + TILE, do_map, full_bar + 8 * s, h * HD, qb * BT, b);
          bulk_load(st_s + s * STAT_FLOATS * sizeof(float), st_bh + (size_t)qb * STAT_FLOATS,
                    STAT_FLOATS * sizeof(float), full_bar + 8 * s);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, qw = warp & 3, t4 = lane & 3, tw = tid & 127;
  const size_t rs = (size_t)3 * C;
  bf16* out = dqkv + (size_t)b * N * rs + h * HD;
  float* dq_bh = dq_acc + (size_t)bh * nq * (HD / 2) * 128 + tw;
  for (int r = 0; r < rounds; ++r) {
    const int buf = r & 1, kb = r * BWD_WG + wg, active = min(BWD_WG, nq - r * BWD_WG);
    const bool act = kb < nq;
    const uint32_t kt = k_tile(buf, wg), vt = v_tile(buf, wg);
    float dk[HD / 2], dv[HD / 2];
    zero_acc(dk);
    zero_acc(dv);
    mbar_wait(kv_full + 8 * buf, (r >> 1) & 1);
    for (int qb = 0; qb < nq; ++qb) {
      const int g = r * nq + qb, s = g % BWD_STAGES;
      const uint32_t qt = ring_s + 2 * s * TILE, dt = qt + TILE;
      const uint32_t dst = ds_s + ((g & 1) * BWD_WG + wg) * DS_TILE;
      const float* st = St + s * STAT_FLOATS;
      mbar_wait(full_bar + 8 * s, (g / BWD_STAGES) & 1);
      if (act) {  // uniform across the warpgroup
        // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries.
        float sc[32], dp[32];
        zero_acc(sc);
        zero_acc(dp);
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_m64n64(sc, head_k_desc<HD>(kt, kk), head_k_desc<HD>(qt, kk));
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_m64n64(dp, head_k_desc<HD>(vt, kk), head_k_desc<HD>(dt, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        // P^T = exp2(s * scale2 - (m2 + log2 l)), 0 for keys past N
        // (queries past N have m2 + log2 l = +inf); dS^T = ((dP^T - D) *
        // P^T) * scale.
        const int key0 = kb * BT + qw * 16 + (lane >> 2);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = j * 8 + t4 * 2 + (e & 1), i = 4 * j + e;
            float p = ex2(fmaf(sc[i], scale2, -st[q]));
            if (key0 + (e >> 1) * 8 >= N) p = 0.f;
            sc[i] = p;
            dp[i] = ((dp[i] - st[BT + q]) * p) * scale;
          }
        uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[kk][x] = pack_bf16x2(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
            da[kk][x] = pack_bf16x2(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
          }
        // dV += bf16(P^T) dO, dK += bf16(dS^T) Q (dO and Q read MN-major).
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)
          wgmma_rs_pv<HD>(dv, pa[kk], dt, kk);
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)
          wgmma_rs_pv<HD>(dk, da[kk], qt, kk);
        wgmma_commit();
        // Stage bf16 dS^T [keys][queries] in the 128-byte swizzle while
        // the products run, once the dQ step two steps back has read the
        // buffer: da[kk][x] holds row (x & 1) * 8 and the 8-column group
        // 2kk + x/2.
        mbar_wait(ds_empty + 8 * (g & 1), ((g >> 1) & 1) ^ 1);
#pragma unroll
        for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int row = qw * 16 + (lane >> 2) + (x & 1) * 8, grp = 2 * kk + (x >> 1);
            const uint32_t a = dst + row * 128 + ((grp ^ (row & 7)) << 4) + t4 * 4;
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(da[kk][x]) : "memory");
          }
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      } else {
        mbar_wait(ds_empty + 8 * (g & 1), ((g >> 1) & 1) ^ 1);  // keeps its arrivals in step
      }
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done with Q and dO
      fence_async_shared();
      mbar_arrive(ds_full + 8 * (g & 1));
      if (qb % BWD_WG == wg) {
        // dQ += dS K over the round's key blocks, in block order, on the
        // fp32 accumulator this thread alone carries between rounds; the
        // other warpgroups go on to the next step meanwhile.
        float dq[HD / 2];
        float* acc = dq_bh + (size_t)qb * (HD / 2) * 128;
        if (r == 0) {
          zero_acc(dq);
        } else {
#pragma unroll
          for (int e = 0; e < HD / 2; ++e) dq[e] = acc[e * 128];
        }
        mbar_wait(ds_full + 8 * (g & 1), (g >> 1) & 1);  // the round's dS^T tiles staged
        fence_regs(dq);
        wgmma_fence();
        const uint32_t ds_g = ds_s + (g & 1) * BWD_WG * DS_TILE;
        for (int f = 0; f < active; ++f)
#pragma unroll
          for (int kk = 0; kk < BT / 16; ++kk)
            wgmma_ss_tt<HD>(dq, swz_desc<64>(ds_g + f * DS_TILE + kk * 16 * 128),
                            k_tile(buf, f), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        mbar_arrive(ds_empty + 8 * (g & 1));
        if (r == rounds - 1) {
          store_acc<HD>(out, rs, dq, qb * BT, N, qw, lane);
        } else {
#pragma unroll
          for (int e = 0; e < HD / 2; ++e) acc[e * 128] = dq[e];
        }
      }
    }
    if (lane == 0) mbar_arrive(kv_empty + 8 * buf);  // K, V of this round read for the last time
    if (act) {
      store_acc<HD>(out + C, rs, dk, kb * BT, N, qw, lane);
      store_acc<HD>(out + 2 * C, rs, dv, kb * BT, N, qw, lane);
    }
  }
}

// Bytes of scratch attn_backward takes: the statistics and the dQ
// accumulators, fp32, per (b, h) and 64-query block.
inline size_t bwd_scratch_bytes(int B, int N, int H, int HD) {
  const size_t nq = (size_t)(N + BT - 1) / BT;
  return (size_t)B * H * nq * (STAT_FLOATS + BT * HD) * sizeof(float);
}

template <int HD>
cudaError_t launch_bwd(const bf16* qkv, const bf16* dout, void* scratch, bf16* dqkv, int B,
                       int N, int C, int H, float scale, cudaStream_t s) {
  if (N <= 0) return cudaErrorInvalidValue;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(bwd_stats_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)stats_smem_bytes<HD>());
    if (e) return e;
    return cudaFuncSetAttribute(bwd_main_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)main_smem_bytes<HD>());
  }();
  if (attr != cudaSuccess) return attr;
  const int nq = (N + BT - 1) / BT;
  float* stats = static_cast<float*>(scratch);
  float* dq_acc = stats + (size_t)B * H * nq * STAT_FLOATS;
  const float scale2 = scale * LOG2E;
  bwd_stats_kernel<HD><<<dim3(nq, H, B), ATTN_THREADS, stats_smem_bytes<HD>(), s>>>(
      qkv, dout, stats, N, C, H, scale2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  HeadMaps<HD> qmap, dmap;
  if ((err = make_qkv_map<HD>(&qmap, qkv, B, N, C)) ||
      (err = make_rows_map<HD>(&dmap, dout, B, N, C)))
    return err;
  bwd_main_kernel<HD><<<B * H, bwd_threads<HD>(), main_smem_bytes<HD>(), s>>>(
      qmap, dmap, stats, dq_acc, dqkv, N, C, H, scale, scale2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B3: att [B, N, C] = attention(q, k, v) for qkv [B, N, 3C] bf16 (q | k |
// v, head h at columns h*HD of each). scale = hd^-0.5 * log2(e). Device
// pointers, 16-byte aligned; C % 8 == 0, C / H in {16, 32, 64, 80}.
int attn_forward(const void* qkv, void* att, int B, int N, int C, int H, float scale,
                 void* stream) {
  if (C % 8 != 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_attn_any((const bf16*)qkv, (bf16*)att, B, N, C, H, scale,
                              reinterpret_cast<cudaStream_t>(stream));
}

// How attn_forward (and B2's attention step) runs for these sizes:
// plan[0..5] = resident route (1) or two-pass (0), consumer warpgroups a
// block, Q buffers a warpgroup, blocks resident an SM, blocks launched,
// shared bytes a block. Returns cudaErrorInvalidValue for a head dim
// the core does not take.
int attn_core_plan(int B, int N, int C, int H, long long* plan) {
  if (C % 8 != 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  const AttnPlan p = attn_plan_any(B, N, C, H);
  if (p.wgs == 0) return (int)cudaErrorInvalidValue;
  const long long v[6] = {p.resident, p.wgs, p.qbuf, p.per_sm, p.blocks, (long long)p.smem};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

// The largest N whose K and V the core holds in shared memory, for a
// head dim of 16, 32, 64 or 80 (0 otherwise).
int attn_core_max_n(int hd) { return attn_resident_max_n_any(hd); }

// The bytes of scratch attn_backward takes for these sizes.
long long attn_backward_scratch_bytes(int B, int N, int C, int H) {
  return (long long)bwd_scratch_bytes(B, N, H, C / H);
}

// B4: dqkv [B, N, 3C] (dq | dk | dv) from qkv [B, N, 3C] and dout [B, N, C],
// all bf16; scratch of attn_backward_scratch_bytes bytes, 16-byte aligned.
// scale = hd^-0.5. Same requirements as attn_forward.
int attn_backward(const void* qkv, const void* dout, void* scratch, void* dqkv, int B, int N,
                  int C, int H, float scale, void* stream) {
  if (C % 8 != 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* q = (const bf16*)qkv;
  const bf16* g = (const bf16*)dout;
  bf16* d = (bf16*)dqkv;
  switch (C / H) {
    case 16: return (int)launch_bwd<16>(q, g, scratch, d, B, N, C, H, scale, s);
    case 32: return (int)launch_bwd<32>(q, g, scratch, d, B, N, C, H, scale, s);
    case 64: return (int)launch_bwd<64>(q, g, scratch, d, B, N, C, H, scale, s);
    case 80: return (int)launch_bwd<80>(q, g, scratch, d, B, N, C, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
