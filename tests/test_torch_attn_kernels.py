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
