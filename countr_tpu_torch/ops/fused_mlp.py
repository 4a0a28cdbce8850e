"""Kernel B5: the MLP half-block ``x + fc2(GELU(fc1(LN(x))))``, in CUDA
C++ for Hopper (``countr_tpu_torch/csrc/mlp_block.cu``).

Replaces ``countr_tpu/ops/pallas_block.py::_mlp_block_kernel`` (launched
by ``_fused_mlp``, public entry ``fused_mlp_block``). As in the JAX
package it is wired into no model (``models/vit.py:259-263`` there: it
measured slower than XLA on the TPU); ``models/vit.py fused_mlp_branch``
runs it from a Block's parameters, and ``chip_smoke.py`` holds it
against its plain version and a library composition.

What bounds it on the H100: tensor-core operations, 4·M·C·Hid FLOP
(87.0 GFLOP at the encoder's [16, 576, 768] with hidden 3072, 88 us at
989 TFLOP/s) against ~38 MB of device-memory traffic (11 us). What the
design does about it: both products run on the Hopper GEMM of
``csrc/gemm.cuh`` (wgmma fed by TMA through an mbarrier ring, a
producer warp and two consumer warpgroups, persistent tiles sized per
product for 132 SMs, the output stored by TMA); the GELU rides the fc1
epilogue and the bias and residual the fc2 epilogue. The h round trip
through device memory stays: a 128-row tile of h at hidden 3072 is
768 KB. The source's header has the details.

The entry is a ``torch.autograd.Function``: on a CUDA tensor its forward
launches the kernel or raises, and its backward is the VJP of
``mlp_block_plain`` recomputed from the saved inputs, as the TPU
kernel's custom VJP (``pallas_block.py:310-318``) runs ``jax.vjp`` over
``_unfused_mlp_reference``. On a CPU tensor the entry is
``mlp_block_plain`` itself. ``fused_mlp_block.launches`` counts kernel
launches.

GELU: the tanh form is computed in fp32 from the bf16 sum and rounded
once (what the port's ``Mlp`` and torch's ``F.gelu(approximate="tanh")``
do; XLA rounds after each op of the formula), the erf form in fp32 and
then cast (``pallas_block.py:232-235``). Weights are in torch's layout:
``w_fc1`` [Hid, C], ``w_fc2`` [C, Hid].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from countr_tpu_torch.ops.cuda_build import activation, build_library, launch, operand
from countr_tpu_torch.ops.norms import layer_norm
from countr_tpu_torch.ops.vjp import recompute_vjp

MAX_C = 2048  # the LN pass holds a row in one warp's registers
ENTRY = "fused_mlp_block"


def mlp_block_plain(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2,
                    eps: float = 1e-6, approx_gelu: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, at x's dtype
    (``_unfused_mlp_reference``, ``pallas_block.py:288``)."""
    cd = x.dtype
    xn = layer_norm(x, ln_scale, ln_bias, eps)
    h = F.linear(xn, w_fc1.to(cd)) + b_fc1.to(cd)
    if approx_gelu:
        h = F.gelu(h, approximate="tanh")
    else:
        h = F.gelu(h.float()).to(cd)
    return x + (F.linear(h, w_fc2.to(cd)) + b_fc2.to(cd))


def _lib():
    lib, record = build_library("mlp_block")
    if not getattr(lib, "_countr_bound", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mlp_block_forward.argtypes = [vp] * 10 + [ci] * 3 + [cf, ci, vp]
        lib.mlp_block_forward.restype = ci
        lib.mlp_block_error_string.argtypes = [ci]
        lib.mlp_block_error_string.restype = ctypes.c_char_p
        lib._countr_bound = True
    return lib, record


def build() -> dict:
    """Build and load the kernel library; returns the build record
    (path, seconds, nvcc log)."""
    return _lib()[1]


def _launch(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, eps: float,
            approx_gelu: bool) -> torch.Tensor:
    activation(ENTRY, "x", x)
    b, n, c = x.shape
    hid = w_fc1.shape[0]
    if c % 8 or c > MAX_C or hid % 8:
        raise ValueError(f"{ENTRY}: C={c}, hidden {hid} is not supported "
                         f"(C % 8 == 0, C <= {MAX_C}, hidden % 8 == 0)")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    lns = operand(ENTRY, "ln_scale", ln_scale, f32, (c,), dev)
    lnb = operand(ENTRY, "ln_bias", ln_bias, f32, (c,), dev)
    w1 = operand(ENTRY, "w_fc1", w_fc1, bf, (hid, c), dev)
    b1 = operand(ENTRY, "b_fc1", b_fc1, bf, (hid,), dev)
    w2 = operand(ENTRY, "w_fc2", w_fc2, bf, (c, hid), dev)
    b2 = operand(ENTRY, "b_fc2", b_fc2, bf, (c,), dev)
    lib, _ = _lib()
    xn = torch.empty((b * n, c), device=dev, dtype=bf)
    h = torch.empty((b * n, hid), device=dev, dtype=bf)
    y = torch.empty_like(x)
    launch(ENTRY, lib.mlp_block_forward, lib.mlp_block_error_string, dev,
           x, lns, lnb, w1, b1, w2, b2, xn, h, y, b * n, c, hid, eps, int(approx_gelu))
    fused_mlp_block.launches += 1
    return y


class _MlpBlock(torch.autograd.Function):
    """B5 forward, the plain formula's VJP backward."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, eps, approx_gelu):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2)
        ctx.eps, ctx.approx_gelu = eps, approx_gelu
        return _launch(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, eps, approx_gelu)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_vjp(mlp_block_plain, ctx.saved_tensors, ctx.needs_input_grad, g,
                              ctx.eps, ctx.approx_gelu)
        return (*grads, None, None)


def fused_mlp_block(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_fc1: torch.Tensor,
    b_fc1: torch.Tensor,
    w_fc2: torch.Tensor,
    b_fc2: torch.Tensor,
    eps: float = 1e-6,
    approx_gelu: bool = True,
) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` for [B, N, C] activations,
    differentiable: kernel B5 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, eps,
                               approx_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"{ENTRY}: unsupported device {x.device}")
    return _MlpBlock.apply(x, ln_scale, ln_bias, w_fc1, b_fc1, w_fc2, b_fc2, eps,
                           approx_gelu)


fused_mlp_block.launches = 0
