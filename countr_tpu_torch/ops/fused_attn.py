"""Kernels B3 and B4: self-attention over projected q/k/v, forward and
backward, in CUDA C++ for Hopper (``countr_tpu_torch/csrc/attn.cu``).

B3 replaces ``countr_tpu/ops/pallas_attn.py::_attn_kernel`` (launched by
``_fused``, public entry ``fused_attention``); B4 replaces
``pallas_attn.py::_attn_bwd_kernel`` (launched by ``_fused_bwd``), B3's
VJP (``_fused_diff``). ``fused_attention`` is a ``torch.autograd.Function``
with B3 as its forward and B4 as its backward.

What bounds them on the H100: B3 moves about as many bytes as it does
operations (4·B·N²·C FLOP against q, k, v and the output; at the
decoder's [8, 576, 512] 5.4 GFLOP and 18.9 MB, 5.5 and 5.6 us); B4 is
bound by operations (10·B·N²·C FLOP, 13.6 GFLOP there, 13.7 us, against
33 MB). What the design does about it: no N x N tensor in memory, and
blocks of (batch, head, 64 rows) for 132 SMs. B3 runs the attention core
it shares with B2 (``csrc/attention.cuh``): up to ``resident_max_n``
keys (832 at head dim 64) each block holds its head's K and V in shared
memory, brought once by TMA, and runs QK^T twice by wgmma (the exact row
max, then p and PV) with no logits kept; two ``mma.sync`` passes over
keys streamed from device memory past that. B4 runs two passes:
the row statistics in one online sweep (``mma.sync``), then one wgmma +
TMA pass per (batch, head) that forms P and dS once per (query, key) pair
for dV, dK and dQ; each block owns its outputs, so no atomics and the
same bits on every run. The sources' headers have the details.

The kernels take the packed qkv [B, N, 3C] (q | k | v, head h at
columns h*hd of each), which is what ``SelfAttention``'s one projection
makes, and B4 returns the gradient of that packed tensor.

On a CPU tensor the Function runs the plain versions beside the kernels:
``attention_exp2`` (B3's arithmetic: exp2 softmax, unnormalised P cast
to the value dtype, division after PV) and ``attention_bwd_plain`` (B4's,
op for op: natural-exp P normalised in fp32, D from the fp32 P and dP).
On a CUDA tensor it launches the kernels or raises.
``fused_attention.launches`` and ``fused_attention.bwd_launches`` count
kernel launches; ``launches_h80`` and ``bwd_launches_h80`` the share of
them at head dim 80, whose 160-byte rows the kernels bring in two
swizzled parts (64 + 16 columns) and whose B4 main pass runs two
warpgroups a block instead of three.
"""

from __future__ import annotations

import ctypes

import torch

from countr_tpu_torch.ops.cuda_build import build_library, launch

LOG2E = 1.4426950408889634
HEAD_DIMS = (16, 32, 64, 80)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor, dtype) -> torch.Tensor:
    b, h, n, hd = t.shape
    return t.to(dtype).transpose(1, 2).reshape(b, n, h * hd)


def attention_exp2(q, k, v, num_heads: int) -> torch.Tensor:
    """B3's function: fp32 logits scaled by hd^-0.5*log2(e), exp2 softmax
    numerator, P cast to the value dtype for the PV product (fp32
    accumulation), division by the fp32 row sum after PV. q/k/v
    [B, N, C] -> [B, N, C]."""
    hd = q.shape[-1] // num_heads
    qh, kh, vh = (_heads(t, num_heads).float() for t in (q, k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (hd ** -0.5 * LOG2E)
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    s = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vh) / s
    return _merge(out, q.dtype)


def attention_bwd_plain(q, k, v, g, num_heads: int):
    """B4's function, op for op as ``pallas_attn.py:114-142``: the
    gradients (dq, dk, dv) of B3 at q/k/v [B, N, C] for the output
    cotangent g [B, N, C], each in q's dtype."""
    hd = q.shape[-1] // num_heads
    scale = hd ** -0.5
    qh, kh, vh, gh = (_heads(t, num_heads).float() for t in (q, k, v, g))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    pn = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(pn.to(v.dtype).float().transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    d = (dp * pn).sum(dim=-1, keepdim=True)
    ds = ((dp - d) * pn * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_merge(t, q.dtype) for t in (dq, dk, dv))


def _lib():
    lib, record = build_library("attn")
    if not getattr(lib, "_countr_bound", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_forward.argtypes = [vp, vp] + [ci] * 4 + [cf, vp]
        lib.attn_forward.restype = ci
        lib.attn_backward.argtypes = [vp] * 4 + [ci] * 4 + [cf, vp]
        lib.attn_backward.restype = ci
        lib.attn_backward_scratch_bytes.argtypes = [ci] * 4
        lib.attn_backward_scratch_bytes.restype = ctypes.c_longlong
        lib.attn_core_plan.argtypes = [ci] * 4 + [vp]
        lib.attn_core_plan.restype = ci
        lib.attn_core_max_n.argtypes = [ci]
        lib.attn_core_max_n.restype = ci
        lib.attn_error_string.argtypes = [ci]
        lib.attn_error_string.restype = ctypes.c_char_p
        lib._countr_bound = True
    return lib, record


def build() -> dict:
    """Build and load the kernel library; returns the build record
    (path, seconds, nvcc log)."""
    return _lib()[1]


CORE_PLAN_KEYS = ("resident", "warpgroups", "q_buffers", "blocks_per_sm", "blocks",
                  "smem_bytes")


def core_plan(b: int, n: int, c: int, num_heads: int) -> dict:
    """How the attention core (B3, and B2's attention step) runs on the
    current card for these sizes: ``resident`` 1 (K and V in shared
    memory) or 0 (the two-pass kernel past the limit), consumer
    warpgroups a block, Q buffers a warpgroup, blocks resident on an SM,
    blocks launched and shared bytes a block. Builds the library."""
    lib, _ = _lib()
    out = (ctypes.c_longlong * len(CORE_PLAN_KEYS))()
    code = lib.attn_core_plan(b, n, c, num_heads, ctypes.addressof(out))
    if code:
        raise ValueError(f"fused_attention: no plan for C={c} with {num_heads} heads "
                         f"({lib.attn_error_string(code).decode()})")
    return dict(zip(CORE_PLAN_KEYS, out))


def resident_max_n(hd: int) -> int:
    """The largest N whose K and V the attention core holds in shared
    memory at head dim ``hd`` (16, 32, 64 or 80; 0 for another). Builds
    the library."""
    return _lib()[0].attn_core_max_n(hd)


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"fused_attention: {name} must be a contiguous bf16 {shape} tensor; "
            f"got {t.dtype} {tuple(t.shape)}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"fused_attention: {name} must be 16-byte aligned")


def _geometry(qkv: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_attention: qkv must be [B, N, 3C]; got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    if hd * num_heads != c or hd not in HEAD_DIMS or c % 8:
        raise ValueError(
            f"fused_attention: C={c} with {num_heads} heads is not supported "
            f"(head dim one of {HEAD_DIMS}, C % 8 == 0)"
        )
    _check("qkv", qkv, (b, n, 3 * c))
    return b, n, c, hd


def _launch_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c, hd = _geometry(qkv, num_heads)
    lib, _ = _lib()
    att = torch.empty((b, n, c), device=qkv.device, dtype=torch.bfloat16)
    launch("fused_attention", lib.attn_forward, lib.attn_error_string, qkv.device,
           qkv, att, b, n, c, num_heads, hd ** -0.5 * LOG2E)
    fused_attention.launches += 1
    if hd == 80:
        fused_attention.launches_h80 += 1
    return att


def _launch_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c, hd = _geometry(qkv, num_heads)
    _check("the output gradient", g, (b, n, c))
    lib, _ = _lib()
    scratch = torch.empty(lib.attn_backward_scratch_bytes(b, n, c, num_heads),
                          device=qkv.device, dtype=torch.uint8)
    dqkv = torch.empty_like(qkv)
    launch("fused_attention", lib.attn_backward, lib.attn_error_string, qkv.device,
           qkv, g, scratch, dqkv, b, n, c, num_heads, hd ** -0.5)
    fused_attention.bwd_launches += 1
    if hd == 80:
        fused_attention.bwd_launches_h80 += 1
    return dqkv


def fused_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """B4 alone: the gradient [B, N, 3C] of the packed qkv for the output
    cotangent g [B, N, C]; the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if qkv.device.type == "cuda":
        return _launch_bwd(qkv, g.contiguous(), num_heads)
    if qkv.device.type != "cpu":
        raise ValueError(f"fused_attention: unsupported device {qkv.device}")
    return torch.cat(attention_bwd_plain(*qkv.chunk(3, dim=-1), g, num_heads), dim=-1)


class _Attention(torch.autograd.Function):
    """Attention over the packed qkv [B, N, 3C]: B3 forward and B4
    backward when ``kernel``, else their plain versions."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, kernel: bool):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.kernel = num_heads, kernel
        if kernel:
            return _launch_fwd(qkv, num_heads)
        return attention_exp2(*qkv.chunk(3, dim=-1), num_heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        if ctx.kernel:
            return _launch_bwd(qkv, g.contiguous(), ctx.num_heads), None, None
        grads = attention_bwd_plain(*qkv.chunk(3, dim=-1), g, ctx.num_heads)
        return torch.cat(grads, dim=-1), None, None


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention of the packed qkv [B, N, 3C] -> [B, N, C],
    differentiable: kernels B3/B4 on a CUDA tensor, their plain versions
    on a CPU tensor."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention: unsupported device {qkv.device}")
    return _Attention.apply(qkv, num_heads, qkv.device.type == "cuda")


def attention_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``fused_attention_qkv`` through the plain versions on any device
    (the comparison path of the card's checks)."""
    return _Attention.apply(qkv, num_heads, False)


def fused_attention(q, k, v, num_heads: int) -> torch.Tensor:
    """Self-attention [B, N, C] x3 -> [B, N, C] (the JAX entry's
    signature); q, k and v are packed into one buffer for the kernels."""
    return fused_attention_qkv(torch.cat([q, k, v], dim=-1), num_heads)


fused_attention.launches = 0
fused_attention.bwd_launches = 0
# the launches of those at head dim 80 (ViT-H/14), counted in both
fused_attention.launches_h80 = 0
fused_attention.bwd_launches_h80 = 0
