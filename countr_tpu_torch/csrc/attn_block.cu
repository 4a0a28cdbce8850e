// Kernel B2: the attention half-block y = x + proj(MHA(qkv(LN(x)))) of a
// pre-norm transformer block, forward, bf16 activations, for Hopper (sm_90a).
//
// Replaces countr_tpu/ops/pallas_block.py::_attn_block_kernel (launched by
// _fused_block, public entry fused_attention_block).
//
// What bounds it on the H100: tensor-core operations. At the main path's
// 16 windows the encoder launch is 59.8 GFLOP (qkv 2.04, QK^T + PV 1.02,
// proj 0.68 GFLOP per window), 60 us at 989 TFLOP/s; its device-memory
// traffic (x in, y out, weights) is ~33 MB, ~10 us at 3.35 TB/s.
//
// What the design does about it: every product runs on wgmma, the
// tensor-core instruction that reaches the card's full rate, with its
// operands brought by TMA, and the attention reads each head's K and V
// from device memory once per block that works on the head. Four
// kernels run back to back on the caller's stream; the intermediates go
// through scratch that the caller allocates (qkv [M, 3C] and att [M, C],
// M = B*N):
//   1. LN: one warp per row, fp32 mean and variance of (x - mean),
//      rsqrt, fp32 affine, bf16 result into att (free until step 3).
//   2. qkv GEMM (gemm.cuh): Out = att . Wqkv^T + bqkv. A producer warp
//      brings 64-deep K slices of both operands by TMA into an mbarrier
//      ring; two consumer warpgroups run wgmma on persistent 128 x 256 or
//      128 x 128 tiles and store each tile by TMA from shared memory.
//      Wqkv is [3C, C] in torch's [out, in] layout: an "NT" product, both
//      operands K-contiguous, as wgmma reads them.
//   3. Attention (attention.cuh, the core B3 runs too): persistent
//      blocks, each holding one head's K and V in shared memory at a
//      time (brought once by TMA, up to 832 keys at hd 64), consumer
//      warpgroups on their own 64-query tiles. Sweep 1 runs QK^T (wgmma)
//      for the exact row max only; sweep 2 runs QK^T again, then
//      p = exp2(logit - max), s += p (fp32), acc += bf16(p) . V (wgmma,
//      fp32), and bf16(acc / s). Past the resident limit a two-pass
//      route streams K and V from device memory. No N x N tensor
//      reaches device memory.
//   4. proj GEMM + bias + residual x, the GEMM of step 2 (the residual
//      tile also by TMA).
// The rounding points are the TPU kernel's (pallas_block.py:60-87): bf16
// LN output, bf16(acc) + bf16(bias) rounded to bf16, logits scaled by
// hd^-0.5 * log2(e) in fp32, exp2 softmax with the unnormalised P cast to
// bf16 and the division after PV, the residual added in bf16. The exact
// max is what keeps them: an online-softmax rescale would round P at
// other values.
//
// The helpers and the attention core (step 3) are in attention.cuh,
// shared with kernel B3 (attn.cu); the LN pass and the GEMM (steps 1, 2
// and 4) in gemm.cuh, shared with kernels B5 (mlp_block.cu) and B6
// (cross_block.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math). Plain C interface, bound
//        with ctypes; the entry returns cudaGetLastError().

#include "gemm.cuh"

extern "C" {

// y = x + proj(MHA(qkv(LN(x)))) for x [B, N, C] bf16, all pointers device
// pointers, 16-byte aligned: lns, lnb fp32 [C]; wqkv bf16 [3C, C];
// bqkv bf16 [3C]; wproj bf16 [C, C]; bproj bf16 [C]; scratch qkv bf16
// [B*N, 3C] and att bf16 [B*N, C]; y bf16 [B, N, C]. Requires
// C % 8 == 0, C <= 2048 and C / H in {16, 32, 64}. Returns
// cudaGetLastError() (0 on success).
int attn_block_forward(const void* x, const void* lns, const void* lnb,
                       const void* wqkv, const void* bqkv, const void* wproj,
                       const void* bproj, void* qkv, void* att, void* y,
                       int B, int N, int C, int H, float eps, float scale,
                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * N, hd = C / H;
  if (C % 8 != 0 || C > 32 * 8 * LN_MAX_VEC || hd * H != C)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_ln((const bf16*)x, (const float*)lns, (const float*)lnb, eps,
                              (bf16*)att, M, C, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<EPI_BIAS>((const bf16*)att, (const bf16*)wqkv, (const bf16*)bqkv,
                              nullptr, (bf16*)qkv, M, 3 * C, C, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_attn_any((const bf16*)qkv, (bf16*)att, B, N, C, H, scale, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<EPI_BIAS_RESID>((const bf16*)att, (const bf16*)wproj,
                                    (const bf16*)bproj, (const bf16*)x, (bf16*)y, M, C, C,
                                    s);
  return (int)err;
}

const char* attn_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
