"""Kernels B3 and B4 of the port (countr_tpu_torch/ops/fused_attn.py) on
the CPU, where the autograd Function runs their plain versions, against
the JAX package's Pallas kernels in interpret mode
(countr_tpu/ops/pallas_attn.py: ``_fused`` B3, ``_fused_bwd`` B4,
``_fused_diff`` their custom VJP). Head dims 32 and 64, N = 576 (the
model's) and a ragged N = 37; inputs N(0, 1) from numpy, the scale of
scripts/validate_fast_mode.py:129-134, whose on-chip gate gives the bf16
bounds below.

Tolerances, and the maxima observed on the CPU:
- fp32: max|d| <= 1e-5 (observed: B3 1.5e-6, B4 1.2e-6). The two sides
  compute the same fp32 arithmetic and differ only in the order of the
  sums.
- bf16: max|d| <= 3.9e-3 and max|d| / max|ref| <= 3.1e-3
  (docs/PARITY.md:229-230, the JAX kernel's own bf16 bounds on the
  chip). Both sides round at the same points (P and dS to bf16, outputs
  to bf16), so what differs is one bf16 rounding of a value whose fp32
  sum fell on the other side of a boundary: one ulp of the output, and
  the outputs here stay below 2.4, where an ulp is <= 1.6e-2 but the
  differing roundings land on small elements (observed: B3 max|d|
  9.8e-4, normalised 2.8e-3; B4 1.95e-3, normalised 2.1e-3).

``test_b4_kernel_arithmetic_matches_pallas`` holds a model of the card
kernel's own arithmetic (csrc/attn.cu), where it departs from the plain
version, against ``_fused_bwd``: the row statistics from one online sweep
over 64-key chunks (per thread of a row: running max, rescaled sum and
unnormalised D; the four threads merged at the end), and P as one exp2
of the logits scaled by hd^-0.5·log2(e) less the row max plus log2 of
the row sum, in place of exp and a division per pair. Head dims 16 and
32 at N not a multiple of 64, and logits scaled x8 so that one key
dominates each row. Limits: fp32 max|d| <= 1e-5·max(1, max|ref|)
(observed 6.6e-7; 3.0e-5 at x8, where dk reaches 19.8); bf16 one bf16
ulp of the largest reference value and not below 3.9e-3, the card
tests' limit (observed 9.8e-4; 3.1e-2 at x8, a quarter of dk's ulp).

``test_b3_kernel_arithmetic_matches_pallas`` does the same for B3, the
attention core of csrc/attention.cuh, against ``_fused``: the exact row
max of the raw products then scaled, p = exp2 of the scaled logit less
the max, the row sum taken in the kernel's order (each of a row's four
threads over its keys 64c + 8j + 2t + {0, 1}, chunk by chunk, the four
partial sums merged pairwise), and PV added into one fp32 accumulator a
64-key chunk at a time. Head dims 16, 32 and 64, N not a multiple of 64,
N = 650 past the 576 keys of the core it replaced, logits scaled x8.
Same limits (observed fp32 8.6e-7, 9.0e-6 at x8 where outputs reach
4.2; bf16 9.8e-4, 7.8e-3 at x8 against an ulp of 3.1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.ops.pallas_attn import _fused, _fused_bwd, _fused_diff
from countr_tpu_torch.ops.fused_attn import (
    attention_bwd_plain, attention_exp2, fused_attention, fused_attention_qkv,
)

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (b, n, c, heads): head dims 64 and 32 at N = 576, and a ragged N
SHAPES = [(1, 576, 128, 2), (1, 576, 64, 2), (2, 37, 128, 2), (2, 37, 96, 3)]
IDS = ["hd64-n576", "hd32-n576", "hd64-n37", "hd32-n37"]


def _inputs(shape, dtype, k=4, seed=0):
    rng = np.random.default_rng(seed)
    jd, td = DT[dtype]
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]
    # round through the working dtype so both sides see the same values
    arrs = [np.array(jnp.asarray(a, jd).astype(jnp.float32)) for a in arrs]
    return [jnp.asarray(a, jd) for a in arrs], [torch.from_numpy(a).to(td) for a in arrs]


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype):
    d = np.abs(_np(got) - _np(want)).max()
    if dtype == "fp32":
        assert d <= 1e-5, d
    else:
        assert d <= 3.9e-3, d
        assert d / np.abs(_np(want)).max() <= 3.1e-3, d


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c,h", SHAPES, ids=IDS)
def test_b3_plain_matches_pallas(b, n, c, h, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs((b, n, c), dtype, k=3)
    want = _fused(qj, kj, vj, h, True)
    n0 = fused_attention.launches
    got = fused_attention(qt, kt, vt, h)
    assert fused_attention.launches == n0  # CPU: the plain version ran
    assert got.dtype == DT[dtype][1] and tuple(got.shape) == (b, n, c)
    _assert_close(got, want, dtype)
    _assert_close(attention_exp2(qt, kt, vt, h), want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c,h", SHAPES, ids=IDS)
def test_b4_plain_matches_pallas(b, n, c, h, dtype):
    (qj, kj, vj, gj), (qt, kt, vt, gt) = _inputs((b, n, c), dtype)
    want = _fused_bwd(qj, kj, vj, gj, h, True)
    got = attention_bwd_plain(qt, kt, vt, gt, h)
    for g, w in zip(got, want):
        assert g.dtype == DT[dtype][1]
        _assert_close(g, w, dtype)


LOG2E = np.float32(1.4426950408889634)


def _kernel_bwd_model(q, k, v, g, num_heads, dtype):
    """B4 as csrc/attn.cu computes it, for float32 numpy [B, N, C] inputs
    already in the working dtype: (dq, dk, dv) as float32 arrays rounded
    to ``dtype``. The products are float32 matmuls (the tensor cores' own
    order of sums is not modelled); P and dS round to ``dtype`` before
    them, as on the card in bf16."""
    f32 = np.float32
    rnd = (lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))) \
        if dtype == "bf16" else (lambda x: x.astype(f32))
    b, n, c = q.shape
    hd = c // num_heads
    heads = [x.reshape(b, n, num_heads, hd).transpose(0, 2, 1, 3) for x in (q, k, v, g)]
    qh, kh, vh, gh = heads
    scale = f32(hd ** -0.5)
    scale2 = f32(scale * LOG2E)
    s = (qh @ kh.transpose(0, 1, 3, 2)).astype(f32)
    dp = (gh @ vh.transpose(0, 1, 3, 2)).astype(f32)

    def ex2_of_fma(x, mu):  # exp2(fma(x, scale2, -mu)), one rounding of the argument
        return np.exp2((x.astype(np.float64) * scale2 - mu).astype(f32)).astype(f32)

    # Statistics: thread t of a row's four holds keys 8j + 2t + {0, 1} of
    # every 64-key chunk, in the order j, then the pair.
    m = np.full((b, num_heads, n, 4), -np.inf, f32)
    lsum = np.zeros_like(m)
    dsum = np.zeros_like(m)
    for k0 in range(0, n, 64):
        cols = [[k0 + 8 * j + 2 * t + e for j in range(8) for e in range(2)] for t in range(4)]
        vals = np.stack([np.stack([s[..., x] if x < n else np.full(s.shape[:-1], -np.inf, f32)
                                   for x in cs], -1) for cs in cols], -2)  # [.., 4, 16]
        dps = np.stack([np.stack([dp[..., x] if x < n else np.zeros(dp.shape[:-1], f32)
                                  for x in cs], -1) for cs in cols], -2)
        mc = np.maximum(m, vals.max(-1) * scale2)
        mu = np.where(mc == -np.inf, f32(0), mc)
        alpha = np.exp2(m - mu).astype(f32)
        lsum, dsum = lsum * alpha, dsum * alpha
        for i in range(16):
            p = ex2_of_fma(vals[..., i], mu)
            lsum = lsum + p
            dsum = (p.astype(np.float64) * dps[..., i] + dsum).astype(f32)  # fmaf
        m = mc
    mx = m.max(-1)
    f = np.exp2(m - mx[..., None]).astype(f32)
    lw, dw = lsum * f, dsum * f
    lt = (lw[..., 0] + lw[..., 1]) + (lw[..., 2] + lw[..., 3])
    dt = (dw[..., 0] + dw[..., 1]) + (dw[..., 2] + dw[..., 3])
    m2 = (mx + np.log2(lt)).astype(f32)
    dd = dt / lt
    # The main pass: P once per pair, dS from the fp32 P and dP.
    pn = ex2_of_fma(s, m2[..., None])
    dv = rnd(pn).transpose(0, 1, 3, 2) @ gh
    ds = rnd(((dp - dd[..., None]) * pn) * scale)
    dq, dk = ds @ kh, ds.transpose(0, 1, 3, 2) @ qh
    return tuple(rnd(x.transpose(0, 2, 1, 3).reshape(b, n, c)) for x in (dq, dk, dv))


# (b, n, c, heads, logit scale): head dims 16 and 32, N not a multiple of 64
KERNEL_SHAPES = [(2, 100, 64, 4, 1.0), (1, 150, 96, 3, 1.0), (2, 100, 64, 2, 8.0)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c,h,logit_scale", KERNEL_SHAPES,
                         ids=["hd16-n100", "hd32-n150", "hd32-n100-x8"])
def test_b4_kernel_arithmetic_matches_pallas(b, n, c, h, logit_scale, dtype):
    (qj, kj, vj, gj), _ = _inputs((b, n, c), dtype, seed=2)
    qj = (qj.astype(jnp.float32) * logit_scale).astype(qj.dtype)  # exact: a power of 2
    want = _fused_bwd(qj, kj, vj, gj, h, True)
    got = _kernel_bwd_model(*(_np(x) for x in (qj, kj, vj, gj)), h, dtype)
    for g, w in zip(got, want):
        d, top = np.abs(g - _np(w)).max(), np.abs(_np(w)).max()
        if dtype == "fp32":
            assert d <= 1e-5 * max(1.0, top), (d, top)
        else:
            assert d <= max(3.9e-3, 2.0 ** (np.floor(np.log2(top)) - 7)), (d, top)


def _kernel_fwd_model(q, k, v, num_heads, dtype):
    """B3 as the attention core of csrc/attention.cuh computes it, for
    float32 numpy [B, N, C] inputs already in the working dtype: the
    output as a float32 array rounded to ``dtype``. The products are
    float32 matmuls (the tensor cores' own order of sums is not
    modelled); p rounds to ``dtype`` before PV, as on the card in bf16."""
    f32 = np.float32
    rnd = (lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))) \
        if dtype == "bf16" else (lambda x: x.astype(f32))
    b, n, c = q.shape
    hd = c // num_heads
    qh, kh, vh = (x.reshape(b, n, num_heads, hd).transpose(0, 2, 1, 3) for x in (q, k, v))
    scale = f32(f32(hd ** -0.5) * LOG2E)
    s = (qh @ kh.transpose(0, 1, 3, 2)).astype(f32)
    # Sweep 1: the exact max of the raw products, merged per chunk and
    # over a row's four threads, then scaled (scaling keeps the order).
    m = (s.max(-1) * scale).astype(f32)
    # Sweep 2: p = exp2(fl(s * scale) - max), keys past N give 0.
    nch = -(-n // 64)
    p = np.zeros(s.shape[:-1] + (nch * 64,), f32)
    p[..., :n] = np.exp2(((s * scale).astype(f32) - m[..., None]).astype(f32)).astype(f32)
    # Row sums in the kernel's order: thread t of a row's four adds keys
    # 64c + 8j + 2t + e for chunk c, then j, then the pair e; the four
    # partial sums meet as (s0 + s1) + (s2 + s3).
    order = np.arange(nch * 64).reshape(nch, 8, 4, 2).transpose(2, 0, 1, 3).reshape(4, -1)
    part = np.zeros(p.shape[:-1] + (4,), f32)
    for i in range(order.shape[1]):
        part = (part + p[..., order[:, i]]).astype(f32)
    srow = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    # PV: one fp32 accumulator, a 64-key chunk at a time.
    o = np.zeros(qh.shape, f32)
    pr = rnd(p[..., :n])
    for c0 in range(0, n, 64):
        o = (o + pr[..., c0:c0 + 64] @ vh[..., c0:c0 + 64, :]).astype(f32)
    out = (o / srow[..., None]).astype(f32)
    return rnd(out.transpose(0, 2, 1, 3).reshape(b, n, c))


# (b, n, c, heads, logit scale): head dims 16, 32 and 64, N not a multiple
# of 64 and N past 576, logits scaled x8
B3_KERNEL_SHAPES = [(2, 100, 64, 4, 1.0), (1, 150, 96, 3, 1.0), (1, 650, 128, 2, 1.0),
                    (2, 100, 64, 2, 8.0), (1, 200, 128, 2, 8.0)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c,h,logit_scale", B3_KERNEL_SHAPES,
                         ids=["hd16-n100", "hd32-n150", "hd64-n650", "hd32-n100-x8",
                              "hd64-n200-x8"])
def test_b3_kernel_arithmetic_matches_pallas(b, n, c, h, logit_scale, dtype):
    (qj, kj, vj), _ = _inputs((b, n, c), dtype, k=3, seed=3)
    qj = (qj.astype(jnp.float32) * logit_scale).astype(qj.dtype)  # exact: a power of 2
    want = _np(_fused(qj, kj, vj, h, True))
    got = _kernel_fwd_model(*(_np(x) for x in (qj, kj, vj)), h, dtype)
    d, top = np.abs(got - want).max(), np.abs(want).max()
    if dtype == "fp32":
        assert d <= 1e-5 * max(1.0, top), (d, top)
    else:
        assert d <= max(3.9e-3, 2.0 ** (np.floor(np.log2(top)) - 7)), (d, top)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c,h", SHAPES[1:3], ids=IDS[1:3])
def test_function_grad_matches_jax_vjp(b, n, c, h, dtype):
    """The autograd Function's gradient on the CPU (B4's plain version)
    against jax.vjp through the custom VJP of the Pallas kernels."""
    (qj, kj, vj, gj), (qt, kt, vt, gt) = _inputs((b, n, c), dtype, seed=1)
    out_j, vjp = jax.vjp(lambda q, k, v: _fused_diff(q, k, v, h, True), qj, kj, vj)
    want = vjp(gj)
    qkv = torch.cat([qt, kt, vt], dim=-1).requires_grad_(True)
    n0 = fused_attention.bwd_launches
    out = fused_attention_qkv(qkv, h)
    out.backward(gt)
    assert fused_attention.bwd_launches == n0
    _assert_close(out.detach(), out_j, dtype)
    for g, w in zip(qkv.grad.chunk(3, dim=-1), want):
        _assert_close(g, w, dtype)
