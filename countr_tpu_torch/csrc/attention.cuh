// Shared pieces of the port's attention kernels for Hopper (sm_90a):
// the tensor-core helpers (cp.async, ldmatrix, mma.sync m16n8k16 bf16
// with fp32 accumulation) and the forward attention core attn_kernel<HD>,
// which kernel B2 (attn_block.cu) runs as its third step and kernel B3
// (attn.cu) runs on its own.
//
// attn_kernel computes exactly the TPU kernels' attention core
// (pallas_attn.py::_attn_kernel, pallas_block.py:60-87): logits in fp32
// scaled by hd^-0.5 * log2(e), p = exp2(logit - max) with the exact row
// max (two passes over the keys), the unnormalised p cast to bf16 for the
// PV product (fp32 accumulation), and the division by the fp32 row sum
// after PV. One block per (batch, head, 64-query tile), 4 warps of 16
// query rows; Q, S and P stay in registers; 64-key K/V chunks are
// double-buffered in shared memory by cp.async. No N x N tensor reaches
// memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int AQ = 64;  // queries per attention block
constexpr int AK = 64;  // keys per chunk
constexpr int ATTN_THREADS = 128;

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

template <int HD>
__host__ __device__ constexpr size_t attn_smem_bytes() {
  return (size_t)(AQ + 4 * AK) * (HD + 8) * sizeof(bf16);  // Q, 2 x (K, V)
}

// qkv [B*N, 3C] (q | k | v, head h at columns h*HD of each) ->
// att [B*N, C]. Grid (ceil(N/64), H, B); 4 warps, 16 query rows each.
// A thread holds rows g = lane/4 and g + 8 of its warp's 16, at columns
// 2*(lane%4) + {0, 1} of every 8-wide tile (the mma accumulator layout).
template <int HD>
__global__ void __launch_bounds__(ATTN_THREADS) attn_kernel(
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
  const size_t smem = attn_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + AQ - 1) / AQ, H, B);
  attn_kernel<HD><<<grid, ATTN_THREADS, smem, stream>>>(qkv, att, N, C, scale);
  return cudaGetLastError();
}

// attn_kernel for a head dim of 16, 32 or 64.
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
