"""Kernel B6: the cross-attention half-block ``x + proj(attn(q(LN(x)),
k, v))`` over precomputed k, v [B, ny <= 8, C], in CUDA C++ for Hopper
(``countr_tpu_torch/csrc/cross_block.cu``).

Replaces ``countr_tpu/ops/pallas_block.py::_cross_block_kernel``
(launched by ``_fused_cross``, public entry
``fused_cross_attention_block``). As in the JAX package it is wired into
no model (``models/countr.py:102-106`` there: it measured slower than
XLA on the TPU); ``chip_smoke.py`` holds it against its plain version
and a library composition.

What bounds it on the H100: tensor-core operations, 4·M·C² FLOP for the
q and proj products (9.7 GFLOP at the decoder's [16, 576, 512], 9.8 us
at 989 TFLOP/s) against ~20 MB of device-memory traffic (6 us); the
attention over ny <= 8 keys is 4·M·ny·C FLOP, under 1% of it. What the
design does about it: the two products on the Hopper GEMM that B2
and B5 share (``csrc/gemm.cuh``: wgmma fed by TMA, persistent tiles,
the output stored by TMA), the small-k attention as one thread per 8 columns
with the head's lanes exchanging partial logits by shuffles, k and v
read from L1/L2. The source's header has the details.

The plain version ``cross_block_plain`` follows the kernel, as B2's
does: exp2 of logits scaled by hd^-0.5·log2(e), the unnormalised P cast
to the value dtype for the PV sum, the division by the fp32 row sum
after PV (``fused_attn.attention_exp2``). The JAX package's twin
``_unfused_cross_reference`` normalises P first; the two agree to fp32
rounding in fp32 and differ by bf16 roundings of P in bf16.

The entry is a ``torch.autograd.Function`` on a CUDA tensor with ny <= 8
(kernel forward, the plain formula's VJP as backward, as
``pallas_block.py:522-529``); for ny > 8 it is the plain version, as the
JAX entry takes its XLA route there (``:569-573``), and that route counts
no launch. On a CPU tensor it is the plain version.
``fused_cross_attention_block.launches`` counts kernel launches. Weights
are in torch's layout: ``w_q`` and ``w_proj`` [C_out, C_in].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from countr_tpu_torch.ops.cuda_build import activation, build_library, launch, operand
from countr_tpu_torch.ops.fused_attn import LOG2E, attention_exp2
from countr_tpu_torch.ops.norms import layer_norm
from countr_tpu_torch.ops.vjp import recompute_vjp

MAX_C = 2048  # the LN pass holds a row in one warp's registers
MAX_NY = 8  # the kernel's key tokens; more take the plain route
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
ENTRY = "fused_cross_attention_block"


def cross_block_plain(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
                      num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch, at x's dtype."""
    cd = x.dtype
    xn = layer_norm(x, ln_scale, ln_bias, eps)
    q = F.linear(xn, w_q.to(cd)) + b_q.to(cd)
    att = attention_exp2(q, k.to(cd), v.to(cd), num_heads)
    return x + (F.linear(att, w_proj.to(cd)) + b_proj.to(cd))


def _lib():
    lib, record = build_library("cross_block")
    if not getattr(lib, "_countr_bound", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cross_block_forward.argtypes = [vp] * 12 + [ci] * 5 + [cf, cf, vp]
        lib.cross_block_forward.restype = ci
        lib.cross_block_error_string.argtypes = [ci]
        lib.cross_block_error_string.restype = ctypes.c_char_p
        lib._countr_bound = True
    return lib, record


def build() -> dict:
    """Build and load the kernel library; returns the build record
    (path, seconds, nvcc log)."""
    return _lib()[1]


def _launch(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
            num_heads: int, eps: float) -> torch.Tensor:
    activation(ENTRY, "x", x)
    activation(ENTRY, "k", k)
    activation(ENTRY, "v", v)
    b, n, c = x.shape
    ny = k.shape[1]
    hd = c // num_heads
    if hd * num_heads != c or hd not in HEAD_DIMS or c % 8 or c > MAX_C:
        raise ValueError(f"{ENTRY}: C={c} with {num_heads} heads is not supported "
                         f"(head dim one of {HEAD_DIMS}, C % 8 == 0, C <= {MAX_C})")
    if tuple(k.shape) != (b, ny, c) or tuple(v.shape) != (b, ny, c) or not 1 <= ny <= MAX_NY:
        raise ValueError(f"{ENTRY}: k and v must be [{b}, ny <= {MAX_NY}, {c}]; "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    if k.device != dev or v.device != dev:
        raise ValueError(f"{ENTRY}: k and v must be on {dev}")
    lns = operand(ENTRY, "ln_scale", ln_scale, f32, (c,), dev)
    lnb = operand(ENTRY, "ln_bias", ln_bias, f32, (c,), dev)
    wq = operand(ENTRY, "w_q", w_q, bf, (c, c), dev)
    bq = operand(ENTRY, "b_q", b_q, bf, (c,), dev)
    wproj = operand(ENTRY, "w_proj", w_proj, bf, (c, c), dev)
    bproj = operand(ENTRY, "b_proj", b_proj, bf, (c,), dev)
    lib, _ = _lib()
    q = torch.empty((b * n, c), device=dev, dtype=bf)
    att = torch.empty((b * n, c), device=dev, dtype=bf)
    y = torch.empty_like(x)
    launch(ENTRY, lib.cross_block_forward, lib.cross_block_error_string, dev,
           x, lns, lnb, wq, bq, k, v, wproj, bproj, q, att, y, b, n, c, num_heads, ny,
           eps, hd ** -0.5 * LOG2E)
    fused_cross_attention_block.launches += 1
    return y


class _CrossBlock(torch.autograd.Function):
    """B6 forward, the plain formula's VJP backward."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj, num_heads, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj)
        ctx.num_heads, ctx.eps = num_heads, eps
        return _launch(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj, num_heads, eps)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_vjp(cross_block_plain, ctx.saved_tensors, ctx.needs_input_grad, g,
                              ctx.num_heads, ctx.eps)
        return (*grads, None, None)


def fused_cross_attention_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_q: torch.Tensor,
    b_q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w_proj: torch.Tensor,
    b_proj: torch.Tensor,
    num_heads: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x + proj(smallk_attn(q(LN(x)), k, v))`` for [B, N, C] queries
    over precomputed [B, ny, C] keys and values, differentiable: kernel B6
    on a CUDA tensor with ny <= 8, the plain version otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{ENTRY}: unsupported device {x.device}")
    if x.device.type == "cpu" or k.shape[1] > MAX_NY:
        return cross_block_plain(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
                                 num_heads, eps)
    return _CrossBlock.apply(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
                             num_heads, eps)


fused_cross_attention_block.launches = 0
