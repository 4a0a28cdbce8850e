"""Kernel B2: the attention half-block ``x + proj(MHA(qkv(LN(x))))``,
in CUDA C++ for Hopper (``countr_tpu_torch/csrc/attn_block.cu``), and
its backward.

Replaces ``countr_tpu/ops/pallas_block.py::_attn_block_kernel``
(launched by ``_fused_block``, public entry ``fused_attention_block``)
and the custom VJP ``_fused_block_bwd`` (``pallas_block.py:164-208``).

What bounds it on the H100: tensor-core operations — 59.8 GFLOP per
encoder launch at 16 windows (60 us at 989 TFLOP/s) against ~33 MB of
device-memory traffic (~10 us). What the design does about it: every
product runs on wgmma, Hopper's warpgroup tensor-core instruction, with
its operands brought by TMA onto mbarriers. The qkv and proj GEMMs
(``csrc/gemm.cuh``, shared with B5 and B6) are warp-specialised and
persistent, with 128 x 256 or 128 x 128 tiles chosen per product and
the output tile stored by TMA. The attention step
(``csrc/attention.cuh``, shared with B3) computes QK^T once per key
block up to 576 keys, parking the fp32 logits in shared memory until
the exact row max is known; past 576 it recomputes QK^T in a second
pass. The work is cut into tiles and (batch, head, 64-query) blocks for
132 SMs instead of the TPU's one program per batch element. The
source's header has the details and the rounding points, which are the
TPU kernel's.

The entry is a ``torch.autograd.Function``. Its forward is the kernel
on a CUDA tensor (it launches or raises) and ``attention_block_plain``
on a CPU tensor — the JAX package's ``_unfused_reference`` with the
kernel's softmax (exp2 of logits scaled by hd^-0.5*log2(e), unnormalised
P cast to the value dtype, division after PV;
``fused_attn.attention_exp2``). Its backward is ``_fused_block_bwd``'s:
no kernel of its own, it recomputes LN (the plain formula, with its
VJP) and the qkv product, recomputes the attention output with B3,
takes the proj gradients, runs the attention backward through B4 and
the qkv and LN gradients, and adds the residual's. Weight gradients are
fp32 sums of the activations' products (``pallas_block.py:193-205``,
``_weight_grad``), returned in the weights' dtype, so a caller that
trains the weights hands in the fp32 parameters and the Function casts
them (``models/vit.py fused_attn_branch``). On a CPU
tensor B3 and B4 run as their plain versions.
``fused_attention_block.launches`` counts kernel launches; the
backward's launches count in B3's and B4's counters
(``fused_attention.launches``, ``.bwd_launches``).

Weights are in torch's layout: ``w_qkv`` [3C, C] (rows q | k | v, head
h at rows h*hd of each), ``w_proj`` [C, C].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from countr_tpu_torch.ops import fused_attn
from countr_tpu_torch.ops.cuda_build import activation, build_library, launch, operand
from countr_tpu_torch.ops.fused_attn import LOG2E, attention_exp2
from countr_tpu_torch.ops.norms import layer_norm

MAX_C = 2048  # the LN pass holds a row in one warp's registers
# B2's head dims: the attention core's but 80 (ViT-H/14's, which only the
# pretrain build runs, with B2 off)
HEAD_DIMS = (16, 32, 64)
ENTRY = "fused_attention_block"


def attention_block_plain(
    x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, at x's dtype."""
    cd = x.dtype
    xn = layer_norm(x, ln_scale, ln_bias, eps)
    qkv = F.linear(xn, w_qkv.to(cd)) + b_qkv.to(cd)
    q, k, v = qkv.chunk(3, dim=-1)
    att = attention_exp2(q, k, v, num_heads)
    return x + (F.linear(att, w_proj.to(cd)) + b_proj.to(cd))


def _lib():
    lib, record = build_library("attn_block")
    if not getattr(lib, "_countr_bound", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_block_forward.argtypes = [vp] * 10 + [ci] * 4 + [cf, cf, vp]
        lib.attn_block_forward.restype = ci
        lib.attn_block_error_string.argtypes = [ci]
        lib.attn_block_error_string.restype = ctypes.c_char_p
        lib._countr_bound = True
    return lib, record


def build() -> dict:
    """Build and load the kernel library; returns the build record
    (path, seconds, nvcc log)."""
    return _lib()[1]


def _launch(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
            num_heads: int, eps: float) -> torch.Tensor:
    activation(ENTRY, "x", x)
    b, n, c = x.shape
    hd = c // num_heads
    if hd * num_heads != c or hd not in HEAD_DIMS or c % 8 or c > MAX_C:
        raise ValueError(
            f"{ENTRY}: C={c} with {num_heads} heads is not supported "
            f"(head dim one of {HEAD_DIMS}, C % 8 == 0, C <= {MAX_C})"
        )
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    lns = operand(ENTRY, "ln_scale", ln_scale, f32, (c,), dev)
    lnb = operand(ENTRY, "ln_bias", ln_bias, f32, (c,), dev)
    wqkv = operand(ENTRY, "w_qkv", w_qkv, bf, (3 * c, c), dev)
    bqkv = operand(ENTRY, "b_qkv", b_qkv, bf, (3 * c,), dev)
    wproj = operand(ENTRY, "w_proj", w_proj, bf, (c, c), dev)
    bproj = operand(ENTRY, "b_proj", b_proj, bf, (c,), dev)
    lib, _ = _lib()
    qkv = torch.empty((b * n, 3 * c), device=dev, dtype=bf)
    att = torch.empty((b * n, c), device=dev, dtype=bf)
    y = torch.empty_like(x)
    launch(ENTRY, lib.attn_block_forward, lib.attn_block_error_string, dev,
           x, lns, lnb, wqkv, bqkv, wproj, bproj, qkv, att, y,
           b, n, c, num_heads, eps, hd ** -0.5 * LOG2E)
    fused_attention_block.launches += 1
    return y


def _weight_grad(dy: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """dW = dy^T a in fp32 for the rows of dy [..., N] and a [..., K]:
    ``_fused_block_bwd``'s fp32 einsum over the activations' values
    (``pallas_block.py:193-205``). Those values are bf16 on the kernel
    path, so every product is exact in fp32; on a CUDA bf16 tensor cuBLAS
    takes them as they are, on the tensor cores, with fp32 accumulation
    and an fp32 result — the same products and an fp32 sum in another
    order — instead of an fp32 GEMM of the upcast copies."""
    dy2, a2 = dy.reshape(-1, dy.shape[-1]), a.reshape(-1, a.shape[-1])
    if dy.is_cuda and dy.dtype == a.dtype == torch.bfloat16:
        return torch.mm(dy2.t(), a2, out_dtype=torch.float32)
    return dy2.t().float() @ a2.float()


def attention_block_bwd(g, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                        num_heads: int, eps: float, kernel: bool, needs=(True,) * 7):
    """The gradients of ``fused_attention_block`` for the output cotangent
    ``g``: (dx, d ln_scale, d ln_bias, dw_qkv, db_qkv, dw_proj, db_proj),
    each None where ``needs`` (one flag per input, in that order) is
    false. ``kernel`` runs B3 and B4, else their plain versions."""
    h, cd = num_heads, x.dtype
    g = g.contiguous()
    # Recompute LN (with its VJP), the qkv product and the attention
    # output (B3).
    ln_in = [t.detach().requires_grad_(bool(n)) for t, n in zip((x, ln_scale, ln_bias), needs)]
    with torch.enable_grad():
        xn_graph = layer_norm(*ln_in, eps)
    xn = xn_graph.detach()
    wqkv_c = w_qkv.to(cd)
    qkv = (F.linear(xn, wqkv_c) + b_qkv.to(cd)).contiguous()
    if kernel:
        att = fused_attn._launch_fwd(qkv, h)
    else:
        att = attention_exp2(*qkv.chunk(3, dim=-1), h)
    # proj: y = att . Wproj^T + bproj
    datt = torch.matmul(g, w_proj.to(cd)).contiguous()
    dwproj = _weight_grad(g, att).to(w_proj.dtype) if needs[5] else None
    dbproj = g.sum((0, 1), dtype=torch.float32).to(b_proj.dtype) if needs[6] else None
    # attention backward (B4), then qkv = xn . Wqkv^T + bqkv
    if kernel:
        dqkv = fused_attn._launch_bwd(qkv, datt, h)
    else:
        dqkv = torch.cat(fused_attn.attention_bwd_plain(*qkv.chunk(3, dim=-1), datt, h),
                         dim=-1)
    dwqkv = _weight_grad(dqkv, xn).to(w_qkv.dtype) if needs[3] else None
    dbqkv = dqkv.sum((0, 1), dtype=torch.float32).to(b_qkv.dtype) if needs[4] else None
    dx = dlns = dlnb = None
    wanted = [t for t in ln_in if t.requires_grad]
    if wanted:
        dxn = torch.matmul(dqkv, wqkv_c)
        grads = iter(torch.autograd.grad(xn_graph, wanted, dxn))
        dx, dlns, dlnb = (next(grads) if t.requires_grad else None for t in ln_in)
        if dx is not None:
            dx = g + dx
    return dx, dlns, dlnb, dwqkv, dbqkv, dwproj, dbproj


class _AttnBlock(torch.autograd.Function):
    """B2 forward (``kernel``) or its plain version; the backward of
    ``_fused_block_bwd`` through B3/B4 or their plain versions."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                num_heads: int, eps: float, kernel: bool):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj)
        ctx.num_heads, ctx.eps, ctx.kernel = num_heads, eps, kernel
        if kernel:
            return _launch(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                           num_heads, eps)
        return attention_block_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                     b_proj, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        grads = attention_block_bwd(g, *ctx.saved_tensors, ctx.num_heads, ctx.eps,
                                    ctx.kernel, ctx.needs_input_grad[:7])
        return (*grads, None, None, None)


def fused_attention_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_qkv: torch.Tensor,
    b_qkv: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor,
    num_heads: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x + proj(MHA(qkv(LN(x))))`` for [B, N, C] activations,
    differentiable: kernel B2 (backward through B3/B4) on a CUDA tensor,
    the plain versions on a CPU tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{ENTRY}: unsupported device {x.device}")
    return _AttnBlock.apply(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                            num_heads, eps, x.device.type == "cuda")


fused_attention_block.launches = 0
