"""Kernel B1: LayerNorm over the last dim, in Triton, forward and backward.

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

The backward (B1bwd) is a kernel of its own. The TPU kernel's custom VJP
runs XLA's LN VJP (``pallas_ln.py:81-86``), which XLA fuses into a couple
of passes; the JAX package has no backward kernel to port. It is bound by
bytes too: it reads x and the output cotangent g and writes dx (6 bytes
an element in bf16) for ~12 FLOP. What the design does about it: one
pass over the rows and a small second launch. ``_ln_bwd`` runs a
persistent grid of a few programs an SM; each strides over tiles of ROWS
rows (a [ROWS, next_pow2(C)] register tile, as the forward's) and, for
each, loads x and g once (the next tile's loads issued before the
current tile's arithmetic, so that their latency overlaps it),
recomputes the rows' fp32 mean and rstd with the forward's arithmetic,
writes dx = rstd * (g*s - mean(g*s) - x^ * mean(g*s*x^)) in x's dtype,
and adds g*x^ and g into fp32 column sums held in registers across its
tiles. Each program then writes its column sums to a [2, programs, C]
fp32 scratch, and ``_ln_bwd_cols`` sums the programs' rows per column in
a fixed order, every program's row of a column block in one load, into
the scale's and the bias's gradients. No atomics: the same inputs give
the same bits. ``bwd_plan`` picks rows a tile, warps and programs an SM
by the width. Only the gradients asked for are computed: without dx no
dx is stored, without the weights' no column sum and no second launch.

The wrapper is a ``torch.autograd.Function``: on a CUDA tensor its
forward and backward launch the kernels or raise; on a CPU tensor they
are ``layer_norm_plain`` and ``layer_norm_bwd_plain``, the same
arithmetic in PyTorch. ``fused_layer_norm.launches`` counts forward
launches, ``fused_layer_norm.bwd_launches`` backward calls on the card
(one a call, whatever its launches).
"""

from typing import NamedTuple

import torch

_KERNEL = None
_BWD = None


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


def _ln_bwd_kernels():
    """Build (once) and return the backward's two Triton kernels."""
    global _BWD, tl
    if _BWD is not None:
        return _BWD
    import triton
    import triton.language as tl

    @triton.jit
    def _ln_bwd(X, G, S, DX, PART, n_rows, C, eps,
                BLOCK: tl.constexpr, ROWS: tl.constexpr,
                WANT_DX: tl.constexpr, WANT_SB: tl.constexpr):
        pid = tl.program_id(0)
        n_prog = tl.num_programs(0)
        cols = tl.arange(0, BLOCK)
        cmask = cols < C
        s = tl.load(S + cols, mask=cmask, other=0.0).to(tl.float32)
        # the column sums of g*x^ and g, kept per row of the tile (no
        # exchange between threads in the loop) and summed over its rows at
        # the end
        acc_gx = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
        acc_g = tl.zeros([ROWS, BLOCK], dtype=tl.float32)
        # the first tile's loads; each iteration then loads the next tile
        # before it works on the one it holds
        rows = pid * ROWS + tl.arange(0, ROWS)
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x_next = tl.load(X + offs, mask=mask, other=0.0)
        g_next = tl.load(G + offs, mask=mask, other=0.0)
        for t in range(pid, tl.cdiv(n_rows, ROWS), n_prog):
            x = x_next.to(tl.float32)
            g = g_next.to(tl.float32)
            rows = (t + n_prog) * ROWS + tl.arange(0, ROWS)
            mask = (rows < n_rows)[:, None] & cmask[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x_next = tl.load(X + offs, mask=mask, other=0.0)
            g_next = tl.load(G + offs, mask=mask, other=0.0)
            rows = t * ROWS + tl.arange(0, ROWS)
            here_mask = (rows < n_rows)[:, None] & cmask[None, :]
            here_offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            mean = tl.sum(x, axis=1) / C
            d = tl.where(here_mask, x - mean[:, None], 0.0)
            rstd = tl.rsqrt(tl.sum(d * d, axis=1) / C + eps)
            h = d * rstd[:, None]
            if WANT_SB:
                acc_gx += g * h
                acc_g += g
            if WANT_DX:
                gs = g * s[None, :]
                c1 = tl.sum(gs * h, axis=1) / C
                c2 = tl.sum(gs, axis=1) / C
                dx = (gs - c2[:, None] - h * c1[:, None]) * rstd[:, None]
                tl.store(DX + here_offs, dx.to(DX.dtype.element_ty), mask=here_mask)
        if WANT_SB:
            tl.store(PART + pid * C + cols, tl.sum(acc_gx, axis=0), mask=cmask)
            tl.store(PART + (n_prog + pid) * C + cols, tl.sum(acc_g, axis=0), mask=cmask)

    @triton.jit
    def _ln_bwd_cols(PART, DS, DB, n_parts, C,
                     BLOCK_N: tl.constexpr, BLOCK_P: tl.constexpr):
        # column sums of PART [2, n_parts, C], the parts in a fixed order
        cols = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        cmask = cols < C
        acc_s = tl.zeros([BLOCK_N], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_N], dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            parts = p0 + tl.arange(0, BLOCK_P)
            m = (parts < n_parts)[:, None] & cmask[None, :]
            offs = parts[:, None] * C + cols[None, :]
            acc_s += tl.sum(tl.load(PART + offs, mask=m, other=0.0), axis=0)
            acc_b += tl.sum(tl.load(PART + n_parts * C + offs, mask=m, other=0.0), axis=0)
        tl.store(DS + cols, acc_s.to(DS.dtype.element_ty), mask=cmask)
        tl.store(DB + cols, acc_b.to(DB.dtype.element_ty), mask=cmask)

    _BWD = (triton, _ln_bwd, _ln_bwd_cols)
    return _BWD


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         g: torch.Tensor, eps: float = 1e-6, needs=(True, True, True)):
    """The backward kernel's arithmetic in plain PyTorch: (dx, dscale,
    dbias) of ``layer_norm_plain`` for the output cotangent ``g``, each in
    its input's dtype, None where ``needs`` does not ask for it. The
    rows' statistics are recomputed as the forward computes them; dx =
    rstd * (g*s - mean(g*s) - x^ * mean(g*s*x^)), dscale = sum of g*x^
    and dbias = sum of g over the rows, all in fp32."""
    c = x.shape[-1]
    x32 = x.float().reshape(-1, c)
    g32 = g.float().reshape(-1, c)
    d = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(d.square().mean(dim=-1, keepdim=True) + eps)
    xhat = d * rstd
    dx = dscale = dbias = None
    if needs[0]:
        gs = g32 * scale.float()
        dx = (gs - gs.mean(dim=-1, keepdim=True)
              - xhat * (gs * xhat).mean(dim=-1, keepdim=True)) * rstd
        dx = dx.to(x.dtype).reshape(x.shape)
    if needs[1]:
        dscale = (g32 * xhat).sum(dim=0).to(scale.dtype)
    if needs[2]:
        dbias = g32.sum(dim=0).to(bias.dtype)
    return dx, dscale, dbias


class BwdPlan(NamedTuple):
    """A launch plan of the backward's row pass: rows a tile, warps a
    program, programs an SM."""

    rows: int
    warps: int
    per_sm: int


def bwd_plan(c: int) -> BwdPlan:
    """The backward's plan at width ``c``: tiles of 4096 elements (8 rows
    at C 512, 4 at 768, 2 at 1280), 4 warps, 2 programs an SM, the
    fastest of a grid of plans at each of the training steps' shapes on
    the H100 (``scripts/profile_torch_ln_bwd.py --plans``)."""
    return BwdPlan(max(1, min(8, 4096 // _pow2_at_least(c))), 4, 2)


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"fused_layer_norm: scale/bias must be [{c}]")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("fused_layer_norm: scale/bias must be on x's device")


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    triton, kernel = _ln_kernel()
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous")
    c = x.shape[-1]
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


def _launch_bwd(x, scale, bias, g, eps: float, needs, plan: BwdPlan = None):
    """The backward's kernels on the card: (dx, dscale, dbias), None where
    ``needs`` does not ask."""
    triton, row_pass, cols_pass = _ln_bwd_kernels()
    if not x.is_contiguous():
        raise ValueError("fused_layer_norm: x must be contiguous")
    if g.shape != x.shape or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"fused_layer_norm: g must be contiguous, {tuple(x.shape)}, "
                         "on x's device")
    want_dx, want_sb = bool(needs[0]), bool(needs[1] or needs[2])
    if not (want_dx or want_sb):
        return None, None, None
    c = x.shape[-1]
    rows = x.numel() // c
    plan = plan or bwd_plan(c)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_prog = max(1, min(triton.cdiv(rows, plan.rows), plan.per_sm * sms))
    dx = torch.empty_like(x) if want_dx else x
    part = (torch.empty((2, n_prog, c), device=x.device, dtype=torch.float32) if want_sb
            else x)
    row_pass[(n_prog,)](
        x, g, scale.contiguous(), dx, part, rows, c, eps,
        BLOCK=_pow2_at_least(c), ROWS=plan.rows, WANT_DX=want_dx, WANT_SB=want_sb,
        num_warps=plan.warps,
    )
    dscale = dbias = None
    if want_sb:
        dscale = torch.empty(c, device=x.device, dtype=scale.dtype)
        dbias = torch.empty(c, device=x.device, dtype=bias.dtype)
        # every program's partial row of a column block in one load
        block_p = min(_pow2_at_least(n_prog), 2048)
        block_n = max(4, 8192 // block_p)
        cols_pass[(triton.cdiv(c, block_n),)](part, dscale, dbias, n_prog, c,
                                              BLOCK_N=block_n, BLOCK_P=block_p, num_warps=8)
    fused_layer_norm.bwd_launches += 1
    return (dx if want_dx else None, dscale if needs[1] else None,
            dbias if needs[2] else None)


def fused_layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         g: torch.Tensor, eps: float = 1e-6, needs=(True, True, True)):
    """B1's backward alone: (dx, dscale, dbias) for the output cotangent
    ``g``, None where ``needs`` does not ask; the kernels on a CUDA
    tensor, the plain version on a CPU tensor; a non-contiguous ``g`` is
    made contiguous first."""
    _check(x, scale, bias)
    g = g.contiguous()
    if x.device.type == "cuda":
        return _launch_bwd(x, scale, bias, g, eps, needs)
    return layer_norm_bwd_plain(x, scale, bias, g, eps, needs)


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
        grads = fused_layer_norm_bwd(*ctx.saved_tensors, g, ctx.eps, ctx.needs_input_grad[:3])
        return (*grads, None)


def fused_layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last dim, differentiable: the Triton kernels on
    a CUDA tensor, the plain versions on a CPU tensor."""
    _check(x, scale, bias)
    return _LayerNorm.apply(x, scale, bias, eps)


fused_layer_norm.launches = 0
fused_layer_norm.bwd_launches = 0
