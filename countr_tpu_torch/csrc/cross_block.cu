// Kernel B6: the cross-attention half-block y = x + proj(attn(q(LN(x)),
// k, v)) of the interaction decoder, over precomputed k, v [B, ny <= 8, C]
// (the exemplar tokens), forward, bf16 activations, for Hopper (sm_90a).
//
// Replaces countr_tpu/ops/pallas_block.py::_cross_block_kernel (launched
// by _fused_cross, public entry fused_cross_attention_block). As in the
// JAX package it is wired into no model; its entry is driven by the A/B
// measurements.
//
// What bounds it on the H100: tensor-core operations, barely. At 16
// windows of the decoder ([16, 576, 512], 16 heads, ny 3) the q and proj
// products are 9.7 GFLOP, 9.8 us at 989 TFLOP/s; the attention itself is
// 0.06 GFLOP; device-memory traffic (x in, y out, weights) is ~20 MB,
// 6 us at 3.35 TB/s, and the q and att round trips add 38 MB (11 us).
//
// What the design does about it: four kernels back to back on the
// caller's stream, the intermediates through scratch that the caller
// allocates (q [M, C] and att [M, C], M = B*N); the two products run on
// the GEMM that B2 and B5 share (gemm.cuh: wgmma, TMA into an mbarrier
// ring, persistent tiles), which this kernel inherits:
//   1. LN (gemm.cuh): fp32 statistics and affine, bf16 result into att
//      (free until step 3);
//   2. q GEMM (gemm.cuh): q = bf16(bf16(att . Wq^T) + bq);
//   3. small-k attention: one thread per 8 columns of a row; the hd/8
//      threads of a head are neighbouring lanes and exchange partial
//      logits by shuffles, so a (row, head) pair needs no shared memory
//      and k, v (a few KB per batch element) stay in L1/L2. For each key
//      j < ny: logit = fp32(q . k_j) * hd^-0.5 * log2(e); then the exact
//      max, p = exp2(logit - max), s += p (fp32), acc += bf16(p) * v_j
//      (fp32), and att = bf16(acc / s): the TPU kernel's rounding points
//      (pallas_block.py:405-436), division after PV;
//   4. proj GEMM + bias + residual (gemm.cuh).
// Step 3 is memory-bound: q in and att out, 2 x 9.4 MB at 16 windows,
// ~6 us at 3.35 TB/s; the two GEMMs dominate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface, bound
//        with ctypes; the entry returns cudaGetLastError().

#include "gemm.cuh"

namespace {

constexpr int XK_MAX = 8;  // the most key tokens step 3 takes
constexpr int XK_THREADS = 256;

__device__ __forceinline__ void load8(const bf16* p, float (&out)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = bf2f(e[j]);
}

// q [B*N, C] -> att [B*N, C] over k, v [B, ny, C] (head h at columns
// h*hd of each). Thread i owns the 16-byte vector i of the flattened q;
// VPH = hd / 8 threads share a head (VPH divides 32, so a head's lanes
// never straddle a warp). Lanes past the end load vector 0 and store
// nothing, so every lane of a warp takes part in the shuffles.
template <int VPH>
__global__ void __launch_bounds__(XK_THREADS) smallk_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ att, int N, int C, int ny, float scale, long long total) {
  const long long i = (long long)blockIdx.x * XK_THREADS + threadIdx.x;
  const bool valid = i < total;
  const long long iv = valid ? i : 0;
  const int cv = C / 8;
  const long long row = iv / cv;
  const int col = (int)(iv % cv) * 8;
  const long long kv_base = (row / N) * ny * (long long)C + col;

  float qv[8];
  load8(q + row * C + col, qv);
  float logit[XK_MAX];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < XK_MAX; ++j) {
    if (j < ny) {  // ny is the same for the whole grid
      float kj[8];
      load8(k + kv_base + (long long)j * C, kj);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d += qv[e] * kj[e];
#pragma unroll
      for (int o = VPH / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      logit[j] = d * scale;
      mx = fmaxf(mx, logit[j]);
    }
  }
  float s = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < XK_MAX; ++j) {
    if (j < ny) {
      const float p = exp2f(logit[j] - mx);
      s += p;
      const float pb = bf2f(f2bf(p));
      float vj[8];
      load8(v + kv_base + (long long)j * C, vj);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += pb * vj[e];
    }
  }
  if (!valid) return;
  uint4 u;
  bf16* o = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = f2bf(acc[e] / s);
  *reinterpret_cast<uint4*>(att + row * C + col) = u;
}

template <int VPH>
cudaError_t launch_smallk(const bf16* q, const bf16* k, const bf16* v, bf16* att, int M,
                          int N, int C, int ny, float scale, cudaStream_t stream) {
  const long long total = (long long)M * (C / 8);
  const long long blocks = (total + XK_THREADS - 1) / XK_THREADS;
  smallk_attn_kernel<VPH><<<(unsigned)blocks, XK_THREADS, 0, stream>>>(
      q, k, v, att, N, C, ny, scale, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = x + proj(attn(q(LN(x)), k, v)) for x [B, N, C] bf16 and k, v
// [B, ny, C] bf16, all pointers device pointers, 16-byte aligned: lns, lnb
// fp32 [C]; wq, wproj bf16 [C, C]; bq, bproj bf16 [C]; scratch q and att
// bf16 [B*N, C]; y bf16 [B, N, C]. Requires C % 8 == 0, C <= 2048,
// 1 <= ny <= 8 and C / H in {8, 16, 32, 64, 128, 256}. Returns
// cudaGetLastError() (0 on success).
int cross_block_forward(const void* x, const void* lns, const void* lnb, const void* wq,
                        const void* bq, const void* k, const void* v, const void* wproj,
                        const void* bproj, void* q, void* att, void* y, int B, int N,
                        int C, int H, int ny, float eps, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * N, hd = C / H;
  if (C % 8 != 0 || C > 32 * 8 * LN_MAX_VEC || hd * H != C || ny < 1 || ny > XK_MAX ||
      M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_ln((const bf16*)x, (const float*)lns, (const float*)lnb, eps,
                              (bf16*)att, M, C, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<EPI_BIAS>((const bf16*)att, (const bf16*)wq, (const bf16*)bq, nullptr,
                              (bf16*)q, M, C, C, s);
  if (err != cudaSuccess) return (int)err;
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k, *vp = (const bf16*)v;
  switch (hd) {
    case 8: err = launch_smallk<1>(qp, kp, vp, (bf16*)att, M, N, C, ny, scale, s); break;
    case 16: err = launch_smallk<2>(qp, kp, vp, (bf16*)att, M, N, C, ny, scale, s); break;
    case 32: err = launch_smallk<4>(qp, kp, vp, (bf16*)att, M, N, C, ny, scale, s); break;
    case 64: err = launch_smallk<8>(qp, kp, vp, (bf16*)att, M, N, C, ny, scale, s); break;
    case 128: err = launch_smallk<16>(qp, kp, vp, (bf16*)att, M, N, C, ny, scale, s); break;
    case 256: err = launch_smallk<32>(qp, kp, vp, (bf16*)att, M, N, C, ny, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<EPI_BIAS_RESID>((const bf16*)att, (const bf16*)wproj,
                                    (const bf16*)bproj, (const bf16*)x, (bf16*)y, M, C, C,
                                    s);
  return (int)err;
}

const char* cross_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
