// Kernel B5: the MLP half-block y = x + fc2(GELU(fc1(LN(x)))) of a
// pre-norm transformer block, forward, bf16 activations, for Hopper
// (sm_90a).
//
// Replaces countr_tpu/ops/pallas_block.py::_mlp_block_kernel (launched by
// _fused_mlp, public entry fused_mlp_block). As in the JAX package it is
// wired into no model; its entry is driven by the A/B measurements.
//
// What bounds it on the H100: tensor-core operations. At 16 windows of
// the encoder ([16, 576, 768], hidden 3072) the two products are 87.0
// GFLOP, 88 us at 989 TFLOP/s, against ~38 MB of device-memory traffic
// (x in, y out, both weights), 11 us at 3.35 TB/s; the decoder's
// [16, 576, 512] with hidden 2048 is 38.7 GFLOP, 39 us.
//
// What the design does about it: both products run on gemm.cuh's Hopper
// GEMM (wgmma from shared memory, TMA loads into an mbarrier ring fed by
// a producer warp, persistent tiles whose width is chosen per product so
// the last wave is not mostly empty, the epilogue rounded in bf16 pairs
// and stored by TMA), instead of the TPU's one program per batch
// element. Three kernels run back to back on the caller's
// stream; the intermediates go through scratch that the caller allocates
// (xn [M, C] and h [M, 4C], M = B*N):
//   1. LN: fp32 statistics and affine, bf16 result into xn;
//   2. fc1 GEMM: h = GELU(bf16(bf16(xn . W1^T) + b1)), GELU in fp32 from
//      the bf16 sum and rounded once (tanh or erf);
//   3. fc2 GEMM + bias + residual: y = bf16(x + bf16(bf16(h . W2^T) + b2)).
// The rounding points are the TPU kernel's (pallas_block.py:222-240), with
// the tanh GELU computed in fp32 and rounded once, as the port's Mlp
// computes it. The h round trip through device memory (2 x 57 MB for the
// encoder, ~34 us at 3.35 TB/s against ~88 us of products) is what a
// fused fc1-fc2 design would remove; at hidden 3072 a 128-row tile of h
// is 768 KB, more than a block's shared memory, so it stays in memory.
//
// gemm_nt_forward exposes the shared GEMM alone, with each epilogue, for
// the card tests and chip_smoke.py's per-shape GEMM lines.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface, bound
//        with ctypes; the entry returns cudaGetLastError().

#include "gemm.cuh"

extern "C" {

// y = x + fc2(GELU(fc1(LN(x)))) for x [M, C] bf16 (M = B*N), all pointers
// device pointers, 16-byte aligned: lns, lnb fp32 [C]; w1 bf16 [Hid, C];
// b1 bf16 [Hid]; w2 bf16 [C, Hid]; b2 bf16 [C]; scratch xn bf16 [M, C] and
// h bf16 [M, Hid]; y bf16 [M, C]. tanh_form: 1 for the tanh GELU, 0 for
// erf. Requires C % 8 == 0, C <= 2048 and Hid % 8 == 0. Returns
// cudaGetLastError() (0 on success).
int mlp_block_forward(const void* x, const void* lns, const void* lnb, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* xn, void* h,
                      void* y, int M, int C, int Hid, float eps, int tanh_form,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (C % 8 != 0 || C > 32 * 8 * LN_MAX_VEC || Hid % 8 != 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_ln((const bf16*)x, (const float*)lns, (const float*)lnb, eps,
                              (bf16*)xn, M, C, s);
  if (err != cudaSuccess) return (int)err;
  if (tanh_form)
    err = launch_gemm<EPI_BIAS_GELU_TANH>((const bf16*)xn, (const bf16*)w1,
                                          (const bf16*)b1, nullptr, (bf16*)h, M, Hid, C, s);
  else
    err = launch_gemm<EPI_BIAS_GELU_ERF>((const bf16*)xn, (const bf16*)w1,
                                         (const bf16*)b1, nullptr, (bf16*)h, M, Hid, C, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<EPI_BIAS_RESID>((const bf16*)h, (const bf16*)w2, (const bf16*)b2,
                                    (const bf16*)x, (bf16*)y, M, C, Hid, s);
  return (int)err;
}

// Out [M, N] = epilogue(A [M, K] . W [N, K]^T) with bias [N] and, for
// epi 1, the residual R [M, N]; all bf16 device pointers, 16-byte
// aligned. epi: 0 bias, 1 bias + residual, 2 bias + tanh GELU, 3 bias +
// erf GELU (gemm.cuh's Epilogue). Requires K % 8 == 0 and N % 8 == 0.
// Returns cudaGetLastError() (0 on success).
int gemm_nt_forward(const void* A, const void* W, const void* bias, const void* R, void* out,
                    int M, int N, int K, int epi, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16 *a = (const bf16*)A, *w = (const bf16*)W, *b = (const bf16*)bias;
  const bf16* r = (const bf16*)R;
  bf16* o = (bf16*)out;
  switch (epi) {
    case EPI_BIAS: return (int)launch_gemm<EPI_BIAS>(a, w, b, r, o, M, N, K, s);
    case EPI_BIAS_RESID: return (int)launch_gemm<EPI_BIAS_RESID>(a, w, b, r, o, M, N, K, s);
    case EPI_BIAS_GELU_TANH:
      return (int)launch_gemm<EPI_BIAS_GELU_TANH>(a, w, b, r, o, M, N, K, s);
    case EPI_BIAS_GELU_ERF:
      return (int)launch_gemm<EPI_BIAS_GELU_ERF>(a, w, b, r, o, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mlp_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
