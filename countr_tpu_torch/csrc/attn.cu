// Kernels B3 and B4: self-attention over projected q/k/v [B, N, C]
// (packed as qkv [B*N, 3C]), forward and backward, bf16, for Hopper
// (sm_90a).
//
// B3 (attn_forward) replaces countr_tpu/ops/pallas_attn.py::_attn_kernel
// (launched by _fused). It runs the attention core of attention.cuh
// (launch_attn_any), the core of kernel B2, which computes exactly B3's
// function: QK^T once per key block up to 640 keys, two passes past it.
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
// the packed qkv.
//
// What bounds B4 on the H100: tensor-core operations. Its own work is
// 10 * B * N^2 * C FLOP (five N x N x hd products per head): 13.6 GFLOP
// at the decoder's [8, 576, 512] (13.7 us at 989 TFLOP/s) against 33 MB
// of q, k, v, dO read and dq, dk, dv written (9.9 us at 3.35 TB/s).
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, operands through ldmatrix, tiles by cp.async,
// double-buffered), no N x N tensor reaches memory, and the work is cut
// into (batch, head, 64-row) blocks for 132 SMs instead of the TPU's one
// program per batch element. Three kernels run back to back on the
// caller's stream, each block owning its outputs, so there are no atomics
// and the result is deterministic:
//   1. stats: one block per (b, h, 64 queries); three sweeps over 64-key
//      chunks give the exact row max m, then l = sum exp(s - m), then
//      D = sum (exp(s - m) / l) * dP, each in fp32, written to a [3, B, H,
//      N] fp32 scratch buffer. D comes from the fp32 P and dP, as in the
//      TPU kernel, not from the bf16 forward output.
//   2. dK/dV: one block per (b, h, 64 keys), each warp 16 keys with their
//      K and V rows held in registers; over 64-query chunks it recomputes
//      s^T = K Q^T and P^T, dV += bf16(P^T) dO, dP^T = V dO^T,
//      dS^T = bf16(((dP^T - D) * P^T) * scale), dK += dS^T Q.
//   3. dQ: one block per (b, h, 64 queries); over 64-key chunks it
//      recomputes P and dS the same way and accumulates dQ += dS K.
// The recomputation costs 11 products where the function needs 5; a
// single fused pass (and wgmma, TMA) is for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: expf and the division are
//        IEEE). Plain C interface, bound with ctypes; each entry returns
//        cudaGetLastError().

#include "attention.cuh"

namespace {

constexpr int BT = 64;  // rows of a block tile and of a chunk

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

// acc[16 x HD] += bf16(P)[16 x 64] . B, P in accumulator layout (as
// mma_abt leaves it), B a [64][HD + 8] tile (rows = the reduced index).
template <int HD>
__device__ __forceinline__ void mma_pb(float (&acc)[HD / 8][4], const float (&p)[BT / 8][4],
                                       const bf16* bs, int lane) {
  constexpr int LDH = HD + 8;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16x2(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16x2(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]),
    };
#pragma unroll
    for (int d2 = 0; d2 < HD / 16; ++d2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                               d2 * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * d2], pa, r[0], r[1]);
      mma16816(acc[2 * d2 + 1], pa, r[2], r[3]);
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

// Rows row0 + lane/4 (+ 8) of acc [16 x HD] to bf16 out (row stride
// `stride` elements, `out` already at the head's first column).
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, size_t stride, const float (&acc)[HD / 8][4],
                                           int row0, int N, int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = row0 + (lane >> 2) + hh * 8;
    if (n >= N) continue;
    bf16* o = out + (size_t)n * stride + (lane & 3) * 2;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      __nv_bfloat162 v;
      v.x = f2bf(acc[d][2 * hh]);
      v.y = f2bf(acc[d][2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(o + d * 8) = v;
    }
  }
}

__device__ __forceinline__ void quad_max(float& v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ void quad_sum(float& v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  // two single tiles + two double-buffered ones, plus 2 x 3 x 64 fp32 stats
  return (size_t)6 * BT * (HD + 8) * sizeof(bf16) + 2 * 3 * BT * sizeof(float);
}

// Pass 1: stats [3][B][H][N] = (m, l, D) per query row.
template <int HD>
__global__ void __launch_bounds__(ATTN_THREADS) bwd_stats_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout, float* __restrict__ stats,
    int N, int C, int H, float scale) {
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
  const int steps = 3 * nchunks;  // sweeps: max, sum, D

  load_tile<HD>(Qs, base + h * HD, rs, q0, N, tid);
  load_tile<HD>(Gs, dout + (size_t)b * N * C + h * HD, C, q0, N, tid);
  auto load = [&](int t) {
    const int k0 = (t % nchunks) * BT;
    load_tile<HD>(Ks + (t & 1) * BT * LDH, base + C + h * HD, rs, k0, N, tid);
    if (t >= 2 * nchunks)
      load_tile<HD>(Vs + (t & 1) * BT * LDH, base + 2 * C + h * HD, rs, k0, N, tid);
  };
  load(0);
  cp_async_commit();

  uint32_t qf[HD / 16][4], gf[HD / 16][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_a<HD>(qf, Qs, warp * 16, lane);
      load_a<HD>(gf, Gs, warp * 16, lane);
    }
    const int sweep = t / nchunks, k0 = (t % nchunks) * BT;
    float sc[BT / 8][4];
    zero(sc);
    mma_abt<HD>(sc, qf, Ks + (t & 1) * BT * LDH, lane);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t4 * 2 + (e & 1);
        sc[j][e] = key < N ? sc[j][e] * scale : -CUDART_INF_F;
      }
    if (sweep == 0) {
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], sc[j][e]);
      if (t == nchunks - 1) {
        quad_max(m[0]);
        quad_max(m[1]);
      }
    } else if (sweep == 1) {
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += expf(sc[j][e] - m[e >> 1]);
      if (t == 2 * nchunks - 1) {
        quad_sum(l[0]);
        quad_sum(l[1]);
      }
    } else {
      // dP = dO V^T in fp32; past N, V is zero-filled and P is 0.
      float dp[BT / 8][4];
      zero(dp);
      mma_abt<HD>(dp, gf, Vs + (t & 1) * BT * LDH, lane);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsum[e >> 1] += (expf(sc[j][e] - m[e >> 1]) / l[e >> 1]) * dp[j][e];
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  quad_sum(dsum[0]);
  quad_sum(dsum[1]);
  if (t4 == 0) {
    const size_t plane = (size_t)gridDim.z * H * N;
    float* st = stats + ((size_t)b * H + h) * N;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = q0 + warp * 16 + (lane >> 2) + hh * 8;
      if (n >= N) continue;
      st[n] = m[hh];
      st[plane + n] = l[hh];
      st[2 * plane + n] = dsum[hh];
    }
  }
}

// Pass 2: dK, dV for 64 keys of one (b, h).
template <int HD>
__global__ void __launch_bounds__(ATTN_THREADS) bwd_dkdv_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const float* __restrict__ stats, bf16* __restrict__ dqkv, int N, int C, int H,
    float scale) {
  constexpr int LDH = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BT * LDH;
  bf16* Qs = Vs + BT * LDH;      // [2][BT][LDH]
  bf16* Gs = Qs + 2 * BT * LDH;  // [2][BT][LDH]
  float* St = reinterpret_cast<float*>(Gs + 2 * BT * LDH);  // [2][3][BT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t4 = lane & 3;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)3 * C;
  const bf16* base = qkv + (size_t)b * N * rs;
  const bf16* gbase = dout + (size_t)b * N * C + h * HD;
  const size_t plane = (size_t)gridDim.z * H * N;
  const float* st_bh = stats + ((size_t)b * H + h) * N;
  const int nq = (N + BT - 1) / BT;

  load_tile<HD>(Ks, base + C + h * HD, rs, k0, N, tid);
  load_tile<HD>(Vs, base + 2 * C + h * HD, rs, k0, N, tid);
  auto load = [&](int t) {
    const int q0 = t * BT;
    load_tile<HD>(Qs + (t & 1) * BT * LDH, base + h * HD, rs, q0, N, tid);
    load_tile<HD>(Gs + (t & 1) * BT * LDH, gbase, C, q0, N, tid);
    float* st = St + (t & 1) * 3 * BT;
    for (int i = tid; i < 3 * BT; i += ATTN_THREADS) {
      const int which = i / BT, n = q0 + i % BT;
      st[i] = n < N ? st_bh[which * plane + n] : (which == 1 ? 1.f : 0.f);
    }
  };
  load(0);
  cp_async_commit();

  uint32_t kf[HD / 16][4], vf[HD / 16][4];
  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);
  for (int t = 0; t < nq; ++t) {
    if (t + 1 < nq) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_a<HD>(kf, Ks, warp * 16, lane);
      load_a<HD>(vf, Vs, warp * 16, lane);
    }
    const bf16* qs = Qs + (t & 1) * BT * LDH;
    const bf16* gs = Gs + (t & 1) * BT * LDH;
    const float* st = St + (t & 1) * 3 * BT;
    // P^T [16 keys x 64 queries], fp32; 0 for queries past N.
    float p[BT / 8][4];
    zero(p);
    mma_abt<HD>(p, kf, qs, lane);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = j * 8 + t4 * 2 + (e & 1);
        p[j][e] = t * BT + q < N ? expf(p[j][e] * scale - st[q]) / st[BT + q] : 0.f;
      }
    mma_pb<HD>(dv, p, gs, lane);  // dV += bf16(P^T) dO
    float ds[BT / 8][4];
    zero(ds);
    mma_abt<HD>(ds, vf, gs, lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = j * 8 + t4 * 2 + (e & 1);
        ds[j][e] = ((ds[j][e] - st[2 * BT + q]) * p[j][e]) * scale;
      }
    mma_pb<HD>(dk, ds, qs, lane);  // dK += bf16(dS^T) Q
    __syncthreads();
  }
  cp_async_wait<0>();
  bf16* out = dqkv + (size_t)b * N * rs;
  store_rows<HD>(out + C + h * HD, rs, dk, k0 + warp * 16, N, lane);
  store_rows<HD>(out + 2 * C + h * HD, rs, dv, k0 + warp * 16, N, lane);
}

// Pass 3: dQ for 64 queries of one (b, h).
template <int HD>
__global__ void __launch_bounds__(ATTN_THREADS) bwd_dq_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
    const float* __restrict__ stats, bf16* __restrict__ dqkv, int N, int C, int H,
    float scale) {
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
  const int nk = (N + BT - 1) / BT;

  load_tile<HD>(Qs, base + h * HD, rs, q0, N, tid);
  load_tile<HD>(Gs, dout + (size_t)b * N * C + h * HD, C, q0, N, tid);
  auto load = [&](int t) {
    load_tile<HD>(Ks + (t & 1) * BT * LDH, base + C + h * HD, rs, t * BT, N, tid);
    load_tile<HD>(Vs + (t & 1) * BT * LDH, base + 2 * C + h * HD, rs, t * BT, N, tid);
  };
  load(0);
  cp_async_commit();

  // This thread's two rows' (m, l, D); rows past N get (0, 1, 0).
  const size_t plane = (size_t)gridDim.z * H * N;
  const float* st_bh = stats + ((size_t)b * H + h) * N;
  float m[2], l[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = q0 + warp * 16 + (lane >> 2) + hh * 8;
    const bool ok = n < N;
    m[hh] = ok ? st_bh[n] : 0.f;
    l[hh] = ok ? st_bh[plane + n] : 1.f;
    dd[hh] = ok ? st_bh[2 * plane + n] : 0.f;
  }

  uint32_t qf[HD / 16][4], gf[HD / 16][4];
  float dq[HD / 8][4];
  zero(dq);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_a<HD>(qf, Qs, warp * 16, lane);
      load_a<HD>(gf, Gs, warp * 16, lane);
    }
    const bf16* ks = Ks + (t & 1) * BT * LDH;
    float p[BT / 8][4], ds[BT / 8][4];
    zero(p);
    zero(ds);
    mma_abt<HD>(p, qf, ks, lane);                      // s = Q K^T
    mma_abt<HD>(ds, gf, Vs + (t & 1) * BT * LDH, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, key = t * BT + j * 8 + t4 * 2 + (e & 1);
        const float pv = key < N ? expf(p[j][e] * scale - m[hh]) / l[hh] : 0.f;
        ds[j][e] = ((ds[j][e] - dd[hh]) * pv) * scale;
      }
    mma_pb<HD>(dq, ds, ks, lane);  // dQ += bf16(dS) K
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<HD>(dqkv + (size_t)b * N * rs + h * HD, rs, dq, q0 + warp * 16, N, lane);
}

template <int HD>
cudaError_t launch_bwd(const bf16* qkv, const bf16* dout, float* stats, bf16* dqkv, int B,
                       int N, int C, int H, float scale, cudaStream_t s) {
  const int smem = (int)bwd_smem_bytes<HD>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_stats_kernel<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) ||
      (err = cudaFuncSetAttribute(bwd_dkdv_kernel<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) ||
      (err = cudaFuncSetAttribute(bwd_dq_kernel<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return err;
  dim3 grid((N + BT - 1) / BT, H, B);
  bwd_stats_kernel<HD><<<grid, ATTN_THREADS, smem, s>>>(qkv, dout, stats, N, C, H, scale);
  if ((err = cudaGetLastError())) return err;
  bwd_dkdv_kernel<HD><<<grid, ATTN_THREADS, smem, s>>>(qkv, dout, stats, dqkv, N, C, H, scale);
  if ((err = cudaGetLastError())) return err;
  bwd_dq_kernel<HD><<<grid, ATTN_THREADS, smem, s>>>(qkv, dout, stats, dqkv, N, C, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B3: att [B, N, C] = attention(q, k, v) for qkv [B, N, 3C] bf16 (q | k |
// v, head h at columns h*HD of each). scale = hd^-0.5 * log2(e). Device
// pointers, 16-byte aligned; C % 8 == 0, C / H in {16, 32, 64}.
int attn_forward(const void* qkv, void* att, int B, int N, int C, int H, float scale,
                 void* stream) {
  if (C % 8 != 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_attn_any((const bf16*)qkv, (bf16*)att, B, N, C, H, scale,
                              reinterpret_cast<cudaStream_t>(stream));
}

// B4: dqkv [B, N, 3C] (dq | dk | dv) from qkv [B, N, 3C] and dout [B, N, C],
// all bf16; scratch stats fp32 [3, B, H, N]. scale = hd^-0.5. Same
// requirements as attn_forward.
int attn_backward(const void* qkv, const void* dout, void* stats, void* dqkv, int B, int N,
                  int C, int H, float scale, void* stream) {
  if (C % 8 != 0 || C % H != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* q = (const bf16*)qkv;
  const bf16* g = (const bf16*)dout;
  float* st = (float*)stats;
  bf16* d = (bf16*)dqkv;
  switch (C / H) {
    case 16: return (int)launch_bwd<16>(q, g, st, d, B, N, C, H, scale, s);
    case 32: return (int)launch_bwd<32>(q, g, st, d, B, N, C, H, scale, s);
    case 64: return (int)launch_bwd<64>(q, g, st, d, B, N, C, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* attn_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
