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
at 989 TFLOP/s) against ~20 MB of device-memory traffic (x in, y out,
the weights, k and v; 6 us); the attention over ny <= 8 keys is
4·M·ny·C FLOP, under 1% of it. What the design does about it: one
kernel launch per call, at every C <= 2048 (the widths B2 and B5 take).
A block takes a tile of rows: 64, or, where 64-row tiles would need a
second wave of blocks, one tile an SM of up to 72 rows. A producer warp
brings x and the weights' K-slices by TMA; two consumer warpgroups run
both products on the same weight stages (rows 0-63 by wgmma, the rest by
mma.sync) and round q into shared memory, where attention warps, joined
by the consumers once their q products are done, turn it into att in
place; the proj product reads att from shared memory, slice by slice as
the attention finishes it, and adds the bias and the residual in its
epilogue. LN(x), q and att never reach device memory; the wrapper
allocates y and nothing else. Two plans (``plan``): LN(x) of the tile
resident in shared memory (256·C bytes with att at 64-row tiles, so C <=
768; the decoder's C 512 at 72-row tiles), or streamed: each row's mean
and rstd kept, x brought per 64-column K-chunk with the q product's
weight stage and normalised in place by helper warps. Past C 1280 att no
longer fits one block, and a 2-block cluster shares each tile, each
block the att of half the heads and half of proj's outputs, reading the
peer's att through distributed shared memory. The plan is chosen by
shape (``PLANS``: a named one for measurement); all give the same bits.
On a CUDA tensor C > 2048 raises ValueError. ``csrc/cross_block.cu``'s
header has the budgets and the details.

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
are in torch's layout: ``w_q`` and ``w_proj`` [C_out, C_in]. ``build``
refuses a library in which ptxas serialised the kernel's wgmma (its
C7515 warning); ``ptxas_report`` reads the kernel's registers, spills
and warnings from the build log.
"""

from __future__ import annotations

import ctypes
import re

import torch
import torch.nn.functional as F

from countr_tpu_torch.ops.cuda_build import activation, build_library, launch, operand
from countr_tpu_torch.ops.fused_attn import LOG2E, attention_exp2
from countr_tpu_torch.ops.norms import layer_norm
from countr_tpu_torch.ops.vjp import recompute_vjp

MAX_C = 2048  # the widest rows: the streamed plan's (B2 and B5 take the same)
MAX_NY = 8  # the kernel's key tokens; more take the plain route
# Launch plans: chosen by shape, or one named (for measurement and tests).
PLANS = {"auto": 0, "resident": 1, "streamed": 2, "cluster": 3}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
ENTRY = "fused_cross_attention_block"
KERNEL = "cross_block_kernel"


def cross_block_plain(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
                      num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch, at x's dtype."""
    cd = x.dtype
    xn = layer_norm(x, ln_scale, ln_bias, eps)
    q = F.linear(xn, w_q.to(cd)) + b_q.to(cd)
    att = attention_exp2(q, k.to(cd), v.to(cd), num_heads)
    return x + (F.linear(att, w_proj.to(cd)) + b_proj.to(cd))


def ptxas_report(log: str) -> list:
    """The kernel's entry functions in nvcc's ``-Xptxas -v`` log, one dict
    each: ``function`` (mangled), ``registers``, ``stack_frame``,
    ``spill_stores`` and ``spill_loads`` (bytes), ``c7515`` (ptxas's
    wgmma-serialisation warnings for it)."""
    funcs, current, props = {}, None, None

    def entry(name):
        return funcs.setdefault(name, {"function": name, "c7515": []})

    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            entry(current)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            entry(props).update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            entry(current)["registers"] = int(m.group(1))
            continue
        if "C7515" in line:
            named = re.search(r"'(_Z[^']+)'", line)
            name = named.group(1) if named else current
            if name:
                entry(name)["c7515"].append(line.strip())
    return [f for name, f in funcs.items() if KERNEL in name]


def _lib():
    lib, record = build_library("cross_block")
    if not getattr(lib, "_countr_bound", False):
        serialised = [f["function"] for f in ptxas_report(record["log"]) if f["c7515"]]
        if serialised:
            raise RuntimeError(f"{ENTRY}: ptxas serialised the wgmma of {serialised} "
                               "(C7515); the build is refused")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cross_block_forward.argtypes = [vp] * 10 + [ci] * 5 + [cf, cf, ci, vp]
        lib.cross_block_forward.restype = ci
        lib.cross_block_plan.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.cross_block_plan.restype = ci
        lib.cross_block_error_string.argtypes = [ci]
        lib.cross_block_error_string.restype = ctypes.c_char_p
        lib._countr_bound = True
    return lib, record


def build() -> dict:
    """Build and load the kernel library; returns the build record
    (path, seconds, nvcc log)."""
    return _lib()[1]


def _mode(plan_name: str) -> int:
    if plan_name not in PLANS:
        raise ValueError(f"{ENTRY}: plan must be one of {sorted(PLANS)}, not {plan_name!r}")
    return PLANS[plan_name]


def plan(m: int, c: int, num_heads: int, plan_name: str = "auto") -> dict:
    """How the kernel runs M rows of width C over ``num_heads`` heads
    (from the library's ``cross_block_plan``): the products' N-slice
    width, ring stages, dynamic shared bytes per block, blocks, rows per
    block at most, whether LN(x) is resident in shared memory or streamed
    by K-chunks, blocks per cluster (2: each holds att of half the heads)
    and the first column of the second block's heads."""
    lib, _ = _lib()
    out = (ctypes.c_int * 8)()
    rc = lib.cross_block_plan(m, c, num_heads, _mode(plan_name), out)
    if rc != 0:
        raise ValueError(f"{ENTRY}: no {plan_name} plan for M={m}, C={c}, {num_heads} heads")
    return {"slice_width": out[0], "ring_stages": out[1], "smem_bytes": out[2],
            "blocks": out[3], "rows_per_block": out[4],
            "ln": "streamed" if out[5] else "resident", "cluster": out[6], "split_col": out[7]}


def _launch(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
            num_heads: int, eps: float, plan_name: str = "auto") -> torch.Tensor:
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
    mode = _mode(plan_name)
    if mode:
        plan(b * n, c, num_heads, plan_name)  # raises ValueError where the shape does not fit it
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
    y = torch.empty_like(x)
    launch(ENTRY, lib.cross_block_forward, lib.cross_block_error_string, dev,
           x, lns, lnb, wq, bq, k, v, wproj, bproj, y, b, n, c, num_heads, ny,
           eps, hd ** -0.5 * LOG2E, mode)
    fused_cross_attention_block.launches += 1
    return y


class _CrossBlock(torch.autograd.Function):
    """B6 forward, the plain formula's VJP backward."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj, num_heads, eps,
                plan_name):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj)
        ctx.num_heads, ctx.eps = num_heads, eps
        return _launch(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj, num_heads, eps,
                       plan_name)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_vjp(cross_block_plain, ctx.saved_tensors, ctx.needs_input_grad, g,
                              ctx.num_heads, ctx.eps)
        return (*grads, None, None, None)


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
    *,
    plan: str = "auto",
) -> torch.Tensor:
    """``x + proj(smallk_attn(q(LN(x)), k, v))`` for [B, N, C] queries
    over precomputed [B, ny, C] keys and values, differentiable: kernel B6
    on a CUDA tensor with ny <= 8, the plain version otherwise. ``plan``
    names the kernel's launch plan (``PLANS``; "auto" chooses by shape;
    the others are for measurement and tests, and raise ValueError where
    the shape does not fit them)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{ENTRY}: unsupported device {x.device}")
    if x.device.type == "cpu" or k.shape[1] > MAX_NY:
        return cross_block_plain(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
                                 num_heads, eps)
    return _CrossBlock.apply(x, ln_scale, ln_bias, w_q, b_q, k, v, w_proj, b_proj,
                             num_heads, eps, plan)


fused_cross_attention_block.launches = 0
