"""Kernel B2: the attention half-block ``x + proj(MHA(qkv(LN(x))))``,
in CUDA C++ for Hopper (``countr_tpu_torch/csrc/attn_block.cu``).

Replaces ``countr_tpu/ops/pallas_block.py::_attn_block_kernel``
(launched by ``_fused_block``, public entry ``fused_attention_block``);
forward only.

What bounds it on the H100: tensor-core operations — 59.8 GFLOP per
encoder launch at 16 windows (60 us at 989 TFLOP/s) against ~33 MB of
device-memory traffic (~10 us). What the design does about it: all
three products (qkv, QK^T/PV, proj) run on the tensor cores (mma.sync)
behind cp.async pipelines, and the work is cut into 128x128 GEMM tiles
and (batch, head, 64-query) attention blocks (1,728 for the encoder)
instead of the TPU's one program per batch element (16 programs for 132
SMs). The source's header has the details and the rounding points,
which are the TPU kernel's.

On a CPU tensor the wrapper runs ``attention_block_plain`` — the JAX
package's ``_unfused_reference`` with the kernel's softmax (exp2 of
logits scaled by hd^-0.5*log2(e), unnormalised P cast to the value
dtype, division after PV; ``fused_attn.attention_exp2``). On a CUDA
tensor it launches the kernel or raises; it also raises under autograd
(grad enabled and an input requiring grad), because the kernel's
backward (``pallas_block.py:164-208 _fused_block_bwd``) is not ported
yet and its output would carry no gradient. Training builds keep B2 off
(``config.fast_mode_overrides(..., training=True)``).
``fused_attention_block.launches`` counts kernel launches.

Weights are in torch's layout: ``w_qkv`` [3C, C] (rows q | k | v, head
h at rows h*hd of each), ``w_proj`` [C, C].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from countr_tpu_torch.ops.cuda_build import build_library
from countr_tpu_torch.ops.fused_attn import HEAD_DIMS, LOG2E, attention_exp2
from countr_tpu_torch.ops.norms import layer_norm

MAX_C = 2048  # the LN pass holds a row in one warp's registers


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
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(
            "fused_attention_block: x must be a contiguous bf16 [B, N, C] "
            f"tensor; got {x.dtype} {tuple(x.shape)}"
        )
    b, n, c = x.shape
    hd = c // num_heads
    if hd * num_heads != c or hd not in HEAD_DIMS or c % 8 or c > MAX_C:
        raise ValueError(
            f"fused_attention_block: C={c} with {num_heads} heads is not "
            f"supported (head dim one of {HEAD_DIMS}, C % 8 == 0, C <= {MAX_C})"
        )
    dev = x.device

    def arg(t, dtype, shape, name):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(
                f"fused_attention_block: {name} must be {shape} on {dev}; "
                f"got {tuple(t.shape)} on {t.device}"
            )
        return t.to(dtype).contiguous()

    lns = arg(ln_scale, torch.float32, (c,), "ln_scale")
    lnb = arg(ln_bias, torch.float32, (c,), "ln_bias")
    wqkv = arg(w_qkv, torch.bfloat16, (3 * c, c), "w_qkv")
    bqkv = arg(b_qkv, torch.bfloat16, (3 * c,), "b_qkv")
    wproj = arg(w_proj, torch.bfloat16, (c, c), "w_proj")
    bproj = arg(b_proj, torch.bfloat16, (c,), "b_proj")
    for name, t in (("x", x), ("ln_scale", lns), ("ln_bias", lnb), ("w_qkv", wqkv),
                    ("b_qkv", bqkv), ("w_proj", wproj), ("b_proj", bproj)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_attention_block: {name} must be 16-byte aligned")
    lib, _ = _lib()
    qkv = torch.empty((b * n, 3 * c), device=dev, dtype=torch.bfloat16)
    att = torch.empty((b * n, c), device=dev, dtype=torch.bfloat16)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.attn_block_forward(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            qkv.data_ptr(), att.data_ptr(), y.data_ptr(),
            b, n, c, num_heads, eps, hd ** -0.5 * LOG2E, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "fused_attention_block: kernel launch failed: "
            f"{lib.attn_block_error_string(rc).decode()} (code {rc})"
        )
    fused_attention_block.launches += 1
    return y


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
    """``x + proj(MHA(qkv(LN(x))))`` for [B, N, C] activations: the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return attention_block_plain(
            x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads, eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
    params = (x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj)
    if torch.is_grad_enabled() and any(t.requires_grad for t in params):
        raise RuntimeError(
            "fused_attention_block: kernel B2 has no backward yet (the TPU "
            "kernel's is pallas_block.py:164-208 _fused_block_bwd); run it "
            "under torch.no_grad()/inference_mode, or build with "
            "fused_attn_block=False for training"
        )
    return _launch(
        x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj, num_heads, eps
    )


fused_attention_block.launches = 0
