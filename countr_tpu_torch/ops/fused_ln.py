"""Kernel B1: LayerNorm over the last dim, in Triton.

Replaces ``countr_tpu/ops/pallas_ln.py::_ln_kernel`` (launched by
``_fused_ln``, public entry ``fused_layer_norm``).

What bounds it on the H100: memory. It reads each bf16 row once and
writes it once, with ~8 FLOP per element against 4 bytes moved, far
below the ~295 FLOP/byte where the tensor cores would become the limit.
At the main path's [16*576, 768] bf16 that is 28.3 MB, 8.5 us at
3.35 TB/s; at [16*576, 512], 18.9 MB, 5.6 us.

What the design does about it: one pass. Each program loads a
[ROWS, next_pow2(C)] tile of rows (masked tail: 768 is not a power of
two) into registers, computes the fp32 mean and the fp32 variance of
(x - mean) there, normalises with rsqrt, applies the fp32 affine and
stores the input dtype. No intermediate touches device memory; the
[C] scale and bias stay in L1/L2 across programs.

Numerics follow ``_ln_kernel`` exactly: x32 = x.float(); mean;
var = mean((x32 - mean)^2); (x32 - mean) * rsqrt(var + eps);
* scale32 + bias32; cast to x.dtype.

The wrapper is a ``torch.autograd.Function``: its forward is the
kernel on a CUDA tensor and ``layer_norm_plain`` (the same arithmetic in
PyTorch) on a CPU tensor; its backward, on either, is the VJP of
``layer_norm_plain`` recomputed from the saved inputs, as the TPU
kernel's custom VJP runs XLA's LN VJP (``pallas_ln.py:81-86``); the JAX
package has no backward kernel for it. On a CUDA tensor the forward
launches the kernel or raises. ``fused_layer_norm.launches`` counts
kernel launches.
"""

import torch

from countr_tpu_torch.ops.vjp import recompute_vjp

_KERNEL = None


def _ln_kernel():
    """Build (once) and return the Triton kernel. ``triton`` is imported
    here, at first launch, so that this module imports without it."""
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_fwd(X, S, B, Y, n_rows, C, eps,
                BLOCK: tl.constexpr, ROWS: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK)
        cmask = cols < C
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / C
        d = tl.where(mask, x - mean[:, None], 0.0)
        var = tl.sum(d * d, axis=1) / C
        y = d * tl.rsqrt(var + eps)[:, None]
        s = tl.load(S + cols, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(B + cols, mask=cmask, other=0.0).to(tl.float32)
        y = y * s[None, :] + b[None, :]
        tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)

    _KERNEL = (triton, _ln_fwd)
    return _KERNEL


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    triton, kernel = _ln_kernel()
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"fused_layer_norm: scale/bias must be [{c}]")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("fused_layer_norm: scale/bias must be on x's device")
    rows = x.numel() // c
    y = torch.empty_like(x)
    block = triton.next_power_of_2(c)
    n_rows_per_prog = 4 if block <= 1024 else 1
    grid = (triton.cdiv(rows, n_rows_per_prog),)
    kernel[grid](
        x, scale.contiguous(), bias.contiguous(), y, rows, c, eps,
        BLOCK=block, ROWS=n_rows_per_prog, num_warps=4,
    )
    fused_layer_norm.launches += 1
    return y


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        if x.device.type == "cuda":
            return _launch(x, scale, bias, eps)
        return layer_norm_plain(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_vjp(layer_norm_plain, ctx.saved_tensors, ctx.needs_input_grad,
                              g, ctx.eps)
        return (*grads, None)


def fused_layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last dim, differentiable: the Triton kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    return _LayerNorm.apply(x, scale, bias, eps)


fused_layer_norm.launches = 0
