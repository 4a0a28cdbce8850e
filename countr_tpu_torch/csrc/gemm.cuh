// Shared row LayerNorm and tensor-core GEMM of the port's block kernels
// for Hopper (sm_90a): kernel B2 (attn_block.cu), B5 (mlp_block.cu) and
// B6 (cross_block.cu) each run ln_rows_kernel, then gemm_nt_kernel with
// the epilogue their step needs.
//
// ln_rows_kernel: y = bf16(LayerNorm(x)) per row, one warp per row, fp32
// mean, fp32 variance of (x - mean), rsqrt, fp32 affine
// (pallas_block.py:54-59).
//
// gemm_nt_kernel<EPI>: Out = epilogue(A . W^T) with A [M, K] and W [N, K]
// (torch's [out, in] weight layout, both operands K-contiguous), bf16
// operands, fp32 accumulation on the tensor cores (mma.sync m16n8k16,
// operands through ldmatrix), 128 x 128 output tiles, a 3-stage cp.async
// pipeline of 32-deep K slices. The epilogues round where the TPU kernels
// do: t = bf16(acc), then t = bf16(t + bias) (the bias added in bf16),
// then one of
//   EPI_BIAS            nothing more (B2's qkv, B6's q);
//   EPI_BIAS_RESID      t = bf16(R + t), the residual in bf16 (every proj
//                       and fc2);
//   EPI_BIAS_GELU_TANH  t = bf16(gelu_tanh(fp32 t)): fp32 from the bf16
//                       sum, rounded once, as torch's F.gelu(approximate=
//                       "tanh") computes a bf16 tensor (B5, tanh);
//   EPI_BIAS_GELU_ERF   t = bf16(gelu_erf(fp32 t)) (B5, erf;
//                       pallas_block.py:234-235).

#pragma once

#include "attention.cuh"  // bf16 helpers, cp.async, ldmatrix, mma.sync

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_MAX_VEC = 8;  // 8 bf16 x 32 lanes x 8 = rows up to 2048

constexpr int GBM = 128;       // GEMM rows per block
constexpr int GBN = 128;       // GEMM output columns per block
constexpr int GBK = 32;        // K slice per pipeline stage
constexpr int GLD = GBK + 8;   // smem row stride (bf16): 80 B, ldmatrix conflict-free
constexpr int GSTAGES = 3;
constexpr int GEMM_THREADS = 256;
constexpr size_t GEMM_SMEM = (size_t)GSTAGES * (GBM + GBN) * GLD * sizeof(bf16);

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_RESID = 1, EPI_BIAS_GELU_TANH = 2, EPI_BIAS_GELU_ERF = 3 };

// bf16 + bf16 rounded to bf16 (the sum of two bf16 values in fp32 is the
// correctly rounded operand pair; one rounding to bf16 follows).
__device__ __forceinline__ bf16 add_bf(bf16 a, bf16 b) {
  return f2bf(bf2f(a) + bf2f(b));
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
// C <= 32 * 8 * LN_MAX_VEC. fp32 mean, fp32 variance of (x - mean), rsqrt.
__global__ void __launch_bounds__(LN_THREADS) ln_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ lns,
    const float* __restrict__ lnb, float eps, bf16* __restrict__ y, int M, int C) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // whole warps leave together
  const bf16* xr = x + (size_t)row * C;
  float v[LN_MAX_VEC][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_VEC; ++i) {
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
  for (int i = 0; i < LN_MAX_VEC; ++i) {
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
  for (int i = 0; i < LN_MAX_VEC; ++i) {
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
  ln_rows_kernel<<<blocks, LN_THREADS, 0, stream>>>(x, lns, lnb, eps, y, M, C);
  return cudaGetLastError();
}

// Out[m, n] = epilogue(sum_k A[m, k] * W[n, k]) for one 128 x 128 tile.
// 8 warps as 2 (rows) x 4 (cols), each 64 x 32 = 4 x 4 mma tiles.
// Requires K % 8 == 0 and N % 2 == 0; ragged M, N and K are zero-filled.
// R (the residual, [M, N]) is read by EPI_BIAS_RESID only.
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_nt_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ W,
    const bf16* __restrict__ bias, const bf16* __restrict__ R,
    bf16* __restrict__ Out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [GSTAGES][GBM][GLD]
  bf16* Bs = As + GSTAGES * GBM * GLD;       // [GSTAGES][GBN][GLD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int KT = (K + GBK - 1) / GBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * GBK;
    bf16* as = As + stage * GBM * GLD;
    bf16* bs = Bs + stage * GBN * GLD;
#pragma unroll
    for (int i = tid; i < GBM * (GBK / 8); i += GEMM_THREADS) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool p = m < M && k < K;
      cp_async16(as + r * GLD + c, p ? A + (size_t)m * K + k : A, p);
    }
#pragma unroll
    for (int i = tid; i < GBN * (GBK / 8); i += GEMM_THREADS) {
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const int n = n0 + r, k = k0 + c;
      const bool p = n < N && k < K;
      cp_async16(bs + r * GLD + c, p ? W + (size_t)n * K + k : W, p);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // Slice kt has landed; every warp is done with slice kt - 1, whose
    // stage the prefetch below overwrites.
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    const int next = kt + GSTAGES - 1;
    if (next < KT) load(next % GSTAGES, next);
    cp_async_commit();

    const bf16* as = As + (kt % GSTAGES) * GBM * GLD;
    const bf16* bs = Bs + (kt % GSTAGES) * GBN * GLD;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + (wm * 64 + i * 16 + (lane & 15)) * GLD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn * 32 + j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * GLD +
                           kk + ((lane >> 3) & 1) * 8);
        bfr[2 * j2][0] = r[0];
        bfr[2 * j2][1] = r[1];
        bfr[2 * j2 + 1][0] = r[2];
        bfr[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
      if (n >= N) continue;
      const bf16 b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + hh * 8;
        if (m >= M) continue;
        bf16 t0 = add_bf(f2bf(acc[i][j][2 * hh]), b0);
        bf16 t1 = add_bf(f2bf(acc[i][j][2 * hh + 1]), b1);
        if constexpr (EPI == EPI_BIAS_RESID) {
          const __nv_bfloat162 rv =
              *reinterpret_cast<const __nv_bfloat162*>(R + (size_t)m * N + n);
          t0 = add_bf(rv.x, t0);
          t1 = add_bf(rv.y, t1);
        } else if constexpr (EPI == EPI_BIAS_GELU_TANH) {
          t0 = f2bf(gelu_tanh(bf2f(t0)));
          t1 = f2bf(gelu_tanh(bf2f(t1)));
        } else if constexpr (EPI == EPI_BIAS_GELU_ERF) {
          t0 = f2bf(gelu_erf(bf2f(t0)));
          t1 = f2bf(gelu_erf(bf2f(t1)));
        }
        __nv_bfloat162 o;
        o.x = t0;
        o.y = t1;
        *reinterpret_cast<__nv_bfloat162*>(Out + (size_t)m * N + n) = o;
      }
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const bf16* bias,
                        const bf16* R, bf16* Out, int M, int N, int K,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_nt_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GEMM_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_nt_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
      A, W, bias, R, Out, M, N, K);
  return cudaGetLastError();
}

}  // namespace
