"""The shared GEMM's plain version (countr_tpu_torch/ops/gemm.py
``gemm_nt_plain``) against the JAX package's own rounding of the same
steps, on the CPU: the products and epilogues of
countr_tpu/ops/pallas_block.py (qkv and proj, lines 60-63 and 83-87;
fc1's GELU, lines 232-235), written with the same jnp expressions, on
the same seeded numpy inputs (rounded through the working dtype first).
Weights in each package's layout (JAX [in, out], torch [out, in]).

Tolerances, and the maxima observed:
- fp32: max|d| <= 1e-5 * max(1, max|ref|): both sides sum K fp32
  products in another order. Observed at most 1.9e-6.
- bf16: max|d| <= 2^-6 * max(1, max|ref|): both sides round the fp32
  product once and add the bias in bf16, so they differ by one bf16
  rounding of a sum taken in another order (one ulp, 2^-7 relative at
  most, of a value below max|ref|), and for the tanh GELU also by
  XLA's rounding after each op of the formula where the port rounds
  once. Observed: 0 but for the tanh GELU, 1.5625e-2 there (one bf16
  ulp in [2, 4); 0.37 of the limit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu_torch.ops.gemm import EPILOGUES, gemm_nt, gemm_nt_plain

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (M, K, N): the card tests' ragged sizes (M 37, K 48, N 96 and 144) and
# a K that is not a multiple of the kernel's 64-deep slice.
SHAPES = [(37, 48, 96), (70, 200, 144)]


def _inputs(seed, m, k, n, dtype):
    """a [M, K] ~ N(0, 1), w [K, N] ~ 0.05 N(0, 1) (JAX layout), bias [N]
    and residual [M, N], rounded through ``dtype``: (jax list, torch list
    with w as [N, K])."""
    jd, td = DT[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((m, k)), 0.05 * rng.standard_normal((k, n)),
            0.05 * rng.standard_normal(n), rng.standard_normal((m, n))]
    arrs = [np.array(jnp.asarray(a, jd).astype(jnp.float32)) for a in arrs]
    jx = [jnp.asarray(a, jd) for a in arrs]
    tx = [torch.from_numpy(np.ascontiguousarray(a.T if i == 1 else a)).to(td)
          for i, a in enumerate(arrs)]
    return jx, tx


def _jax_gemm(a, w, bias, residual, epilogue):
    """pallas_block.py's expressions: the fp32 product cast to the
    activation dtype plus the bias in that dtype, then the residual add,
    XLA's tanh GELU on that dtype, or the erf GELU in fp32 cast back."""
    cd, f32 = a.dtype, jnp.float32
    t = jax.lax.dot_general(a, w.astype(cd), (((1,), (0,)), ((), ())),
                            preferred_element_type=f32).astype(cd) + bias.astype(cd)
    if epilogue == "residual":
        return residual + t
    if epilogue == "gelu_tanh":
        return jax.nn.gelu(t, approximate=True)
    if epilogue == "gelu_erf":
        return jax.nn.gelu(t.astype(f32), approximate=False).astype(cd)
    return t


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_gemm_plain_matches_jax_rounding(epilogue, dtype, m, k, n):
    jx, tx = _inputs(0, m, k, n, dtype)
    want = np.asarray(jnp.asarray(_jax_gemm(*jx, epilogue), jnp.float32))
    got = gemm_nt_plain(*tx, epilogue=epilogue)
    assert got.dtype == DT[dtype][1] and tuple(got.shape) == (m, n)
    d = float(np.abs(got.float().numpy() - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    lim = (1e-5 if dtype == "fp32" else 2.0 ** -6) * scale
    assert d <= lim, (d, lim)


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_gemm_entry_on_cpu_is_the_plain_version(epilogue):
    _, (a, w, bias, r) = _inputs(1, 37, 48, 96, "bf16")
    n0 = gemm_nt.launches
    got = gemm_nt(a, w, bias, r, epilogue)
    assert gemm_nt.launches == n0
    assert torch.equal(got, gemm_nt_plain(a, w, bias, r, epilogue))


def test_gemm_refuses_unknown_epilogue_and_missing_residual():
    _, (a, w, bias, _) = _inputs(2, 8, 16, 8, "bf16")
    with pytest.raises(ValueError, match="epilogue"):
        gemm_nt(a, w, bias, epilogue="relu")
    with pytest.raises(ValueError, match="residual"):
        gemm_nt(a, w, bias, epilogue="residual")
