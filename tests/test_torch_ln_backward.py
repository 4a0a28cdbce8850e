"""B1's backward (countr_tpu_torch/ops/fused_ln.py) on the CPU, where the
wrapper runs ``layer_norm_bwd_plain``, the closed form that the card's
kernels compute:

- against autograd through ``layer_norm_plain`` (the forward's plain
  arithmetic) at C 48, 80, 512 and 1280, in fp32 and bf16, for every
  subset of the gradients asked for, and through the autograd Function
  with the same subsets (only the asked-for gradients are computed);
- against ``jax.vjp`` of the JAX package's B1 (``pallas_ln._fused_ln_diff``
  in interpret mode, whose VJP is XLA's LN VJP);
- the refusals: a scale or bias of the wrong shape, a device other than
  the CPU or CUDA.

Tolerances. Against autograd: dx within 1e-6 * max(1, max|ref|) in fp32
(the two differ in the order of fp32 operations; observed 4.8e-7 at
max|ref| 4.9) and within one bf16 ulp of max|ref| in bf16 (one rounding
each; observed 0); dscale and dbias within 1e-6 * max(1, max|ref|)
(the same fp32 sums; observed 0). Against JAX, tests/test_torch_kernels.py's
B1 bounds on a gradient's scale: fp32 within 1e-6 * max(1, max|ref|)
(XLA sums over the rows in another order; the weights' gradients reach
~20 over 64 rows), bf16 within 2^-6 * max(1, max|ref|) (docs/PARITY.md:228's
1.56e-2; dx is rounded to bf16 on both sides).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.ops.pallas_ln import _fused_ln_diff
from countr_tpu_torch.ops.fused_ln import (
    fused_layer_norm, fused_layer_norm_bwd, layer_norm_bwd_plain, layer_norm_plain,
)

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
NEEDS = list(itertools.product((False, True), repeat=3))


def _inputs(rng, rows, c, td):
    """x and g exactly representable in ``td``, fp32 scale and bias."""
    x = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32)).to(td)
    g = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32)).to(td)
    s = torch.from_numpy((1 + 0.05 * rng.standard_normal(c)).astype(np.float32))
    b = torch.from_numpy((0.05 * rng.standard_normal(c)).astype(np.float32))
    return x, s, b, g


def _autograd(x, s, b, g):
    ts = [t.clone().requires_grad_(True) for t in (x, s, b)]
    layer_norm_plain(*ts, 1e-6).backward(g)
    return [t.grad for t in ts]


def _close(got, want, dtype, name):
    top = float(want.float().abs().max())
    d = float((got.float() - want.float()).abs().max())
    if dtype == "bf16" and name == "x":
        assert d <= 2.0 ** (np.floor(np.log2(top)) - 7), (name, d, top)
    else:
        assert d <= 1e-6 * max(1.0, top), (name, d, top)


@pytest.mark.parametrize("needs", NEEDS, ids=lambda n: "".join("xsb"[i] for i in range(3) if n[i])
                         or "none")
@pytest.mark.parametrize("c", [48, 80, 512, 1280])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bwd_plain_matches_autograd(dtype, c, needs):
    x, s, b, g = _inputs(np.random.default_rng(c), 37, c, DT[dtype][1])
    want = _autograd(x, s, b, g)
    got = layer_norm_bwd_plain(x, s, b, g, 1e-6, needs)
    for name, need, a, w in zip(("x", "scale", "bias"), needs, got, want):
        if not need:
            assert a is None, name
            continue
        assert a.dtype == w.dtype and a.shape == w.shape, name
        _close(a, w, dtype, name)


@pytest.mark.parametrize("needs", [n for n in NEEDS if any(n)],
                         ids=lambda n: "".join("xsb"[i] for i in range(3) if n[i]))
@pytest.mark.parametrize("c", [48, 1280])
def test_fused_ln_backward_computes_what_is_asked(c, needs):
    """Through the autograd Function: the inputs that require grad get
    ``layer_norm_bwd_plain``'s gradients, to the bit; the others none."""
    x, s, b, g = _inputs(np.random.default_rng(7), 2 * 3 * 5, c, torch.bfloat16)
    ts = [t.clone().requires_grad_(need) for t, need in zip((x, s, b), needs)]
    n0 = fused_layer_norm.bwd_launches
    fused_layer_norm(ts[0].reshape(2, 15, c), *ts[1:], 1e-6).backward(g.reshape(2, 15, c))
    assert fused_layer_norm.bwd_launches == n0  # CPU: the plain version ran
    want = layer_norm_bwd_plain(x, s, b, g, 1e-6, needs)
    for name, t, w in zip(("x", "scale", "bias"), ts, want):
        if w is None:
            assert t.grad is None, name
        else:
            assert torch.equal(t.grad, w), name


def test_bwd_takes_a_non_contiguous_cotangent():
    x, s, b, g = _inputs(np.random.default_rng(8), 24, 80, torch.bfloat16)
    gt = g.t().contiguous().t()  # the same values, column-major
    assert not gt.is_contiguous()
    for a, w in zip(fused_layer_norm_bwd(x, s, b, gt), fused_layer_norm_bwd(x, s, b, g)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 9, 768), (64, 512), (37, 80)])
def test_fused_ln_grad_matches_pallas_vjp(rng, shape, dtype):
    jd, td = DT[dtype]
    c = shape[-1]
    x = np.array(jnp.asarray(rng.standard_normal(shape), jd).astype(jnp.float32))
    g = np.array(jnp.asarray(rng.standard_normal(shape), jd).astype(jnp.float32))
    s = (1 + 0.05 * rng.standard_normal(c)).astype(np.float32)
    b = (0.05 * rng.standard_normal(c)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, s, b: _fused_ln_diff(x, s, b, 1e-6, True),
                     jnp.asarray(x, jd), jnp.asarray(s), jnp.asarray(b))
    want = [np.asarray(jnp.asarray(w, jnp.float32)) for w in vjp(jnp.asarray(g, jd))]
    xs = [torch.from_numpy(x).to(td).requires_grad_(True),
          torch.from_numpy(s).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)]
    fused_layer_norm(*xs, 1e-6).backward(torch.from_numpy(g).to(td))
    tol = 2.0 ** -6 if dtype == "bf16" else 1e-6
    for name, t, w in zip(("x", "scale", "bias"), xs, want):
        assert t.grad.dtype == (td if name == "x" else torch.float32), name
        d = np.abs(t.grad.float().numpy() - w).max()
        assert d <= tol * max(1.0, np.abs(w).max()), (name, d)


@pytest.mark.parametrize("scale_shape,bias_shape", [((81,), (80,)), ((80,), (79,)),
                                                    ((1,), (80,)), ((80, 1), (80,))])
def test_refuses_wrong_scale_or_bias_shape(scale_shape, bias_shape):
    x = torch.zeros(3, 80)
    s, b = torch.ones(scale_shape), torch.zeros(bias_shape)
    with pytest.raises(ValueError, match="scale/bias must be"):
        fused_layer_norm(x, s, b)
    with pytest.raises(ValueError, match="scale/bias must be"):
        fused_layer_norm_bwd(x, s, b, torch.ones(3, 80))


def test_refuses_other_devices():
    x, s, b = (torch.zeros(shape, device="meta") for shape in ((3, 80), (80,), (80,)))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_layer_norm(x, s, b)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_layer_norm_bwd(x, s, b, torch.zeros(3, 80, device="meta"))
