"""Autograd through the port's kernel wrappers and weight casts, on the
CPU:

- B1 (ops/fused_ln.py) is a torch.autograd.Function whose backward on
  the CPU is ``layer_norm_bwd_plain``, the VJP of the plain LayerNorm
  formula in closed form from the saved inputs; its gradients against ``jax.vjp`` of the JAX package's B1
  (``pallas_ln._fused_ln_diff`` in interpret mode, whose VJP is XLA's LN
  VJP). Both sides run the fp32 formula on the same inputs: every fp32
  gradient (all of the fp32 run, the weights' in the bf16 run) within
  1e-5 * max(1, max|ref|); the bf16 input gradient within one bf16 ulp
  of its largest value, for the one rounding each side makes. Observed:
  fp32 2.9e-6 (the scale's gradient, largest value 15); bf16 1.9e-6 on
  the scale's, 0 on the input's.
- ``cast_param`` keeps the cast differentiable under autograd (the
  gradient reaches the fp32 parameter) and caches it otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.ops.pallas_ln import _fused_ln_diff
from countr_tpu_torch.models.vit import cast_param
from countr_tpu_torch.ops.fused_ln import fused_layer_norm, layer_norm_bwd_plain, layer_norm_plain

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_ln_grad_matches_jax_vjp(dtype):
    rng = np.random.default_rng(0)
    jd, td = DT[dtype]
    c = 96
    x = np.array(jnp.asarray(rng.standard_normal((37, c)), jd).astype(jnp.float32))
    g = np.array(jnp.asarray(rng.standard_normal((37, c)), jd).astype(jnp.float32))
    s = (1 + 0.05 * rng.standard_normal(c)).astype(np.float32)
    b = (0.05 * rng.standard_normal(c)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s, b: _fused_ln_diff(x, s, b, 1e-6, True),
                     jnp.asarray(x, jd), jnp.asarray(s), jnp.asarray(b))
    want = [np.asarray(jnp.asarray(w, jnp.float32)) for w in vjp(jnp.asarray(g, jd))]
    xs = [torch.from_numpy(x).to(td).requires_grad_(True),
          torch.from_numpy(s).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)]
    n0 = fused_layer_norm.launches
    fused_layer_norm(*xs, 1e-6).backward(torch.from_numpy(g).to(td))
    assert fused_layer_norm.launches == n0
    got = [t.grad for t in xs]
    assert got[0].dtype == td and got[1].dtype == torch.float32
    for name, gt, w in zip(("x", "scale", "bias"), got, want):
        d = np.abs(gt.float().numpy() - w).max()
        top = np.abs(w).max()
        if dtype == "bf16" and name == "x":
            assert d <= 2.0 ** (np.floor(np.log2(top)) - 7), name
        else:
            assert d <= 1e-5 * max(1.0, top), name


def test_fused_ln_grad_is_the_plain_vjp():
    """On the CPU the backward is ``layer_norm_bwd_plain`` (to the bit),
    the plain formula's VJP in closed form: within 1e-6 * max(1,
    max|ref|) of autograd through ``layer_norm_plain``."""
    rng = np.random.default_rng(1)
    x, s, b, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  for shape in ((5, 48), (48,), (48,), (5, 48)))
    grads = []
    for fn in (fused_layer_norm, layer_norm_plain):
        ts = [t.clone().requires_grad_(True) for t in (x, s, b)]
        fn(*ts, 1e-6).backward(g)
        grads.append([t.grad for t in ts])
    for a, closed, w in zip(grads[0], layer_norm_bwd_plain(x, s, b, g, 1e-6), grads[1]):
        assert torch.equal(a, closed)
        assert float((a - w).abs().max()) <= 1e-6 * max(1.0, float(w.abs().max()))
    # no gradient asked for the input: only the weights' are computed
    ts = [x, s.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    fused_layer_norm(*ts, 1e-6).sum().backward()
    assert ts[1].grad is not None and ts[2].grad is not None


def test_cast_param_is_differentiable_and_cached_in_inference():
    p = torch.nn.Parameter(torch.linspace(-1, 1, 12).reshape(3, 4))
    w = cast_param(p, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.requires_grad
    (w.float() * torch.arange(12.0).reshape(3, 4)).sum().backward()
    assert p.grad is not None and p.grad.dtype == torch.float32
    torch.testing.assert_close(p.grad, torch.arange(12.0).reshape(3, 4))
    with torch.no_grad():
        c1 = cast_param(p, torch.bfloat16)
        c2 = cast_param(p, torch.bfloat16)
        assert c1 is c2 and not c1.requires_grad
        p.add_(1.0)  # a new version: a new copy
        c3 = cast_param(p, torch.bfloat16)
    assert c3 is not c1
    assert torch.equal(c3, (p.detach()).to(torch.bfloat16))
