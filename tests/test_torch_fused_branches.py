"""Kernels B5 (ops/fused_mlp.py), B6 (ops/fused_cross.py) and B2's
backward (ops/fused_block.py) of the port on the CPU, where their
entries run the plain versions, against the JAX package's public entries
with the Pallas kernels in interpret mode (countr_tpu/ops/pallas_block.py
``fused_mlp_block``, ``fused_cross_attention_block``,
``fused_attention_block``), as tests/test_pallas_block.py runs them.
Same inputs from numpy on both sides (rounded through the working dtype
first); weights in each package's own layout (flax [in, out], torch
[out, in]).

Tolerances, and the maxima observed on the CPU:
- fp32 forward: max|d| <= 3e-5 (tests/test_pallas_block.py:86's bound
  for the JAX kernel against its own composition). Observed: B5 3.0e-7,
  B6 2.4e-7 at head dim 16, 9.5e-7 at the decoder's head dim 32 (C 512,
  16 heads), 3.1e-6 at C 1024 and 5.7e-6 at C 2048 (0.19 of the limit).
- bf16 forward: max|d| <= 2^-5 * max(1, max|ref|) (docs/PARITY.md:231's
  bf16 bound of the fused blocks). Both sides round at the same points
  except the tanh GELU (fp32, rounded once here; rounded after each op
  by XLA) and, for B6 at ny > 8, P (the port's plain version divides
  after PV, as the kernel; JAX's twin normalises first). Observed: B5
  1.56e-2 with either GELU (one bf16 ulp of the residual stream in
  [2, 4); 0.13 of the limit); B6 0 at ny <= 8 at head dim 16 and
  1.56e-2 at ny 9; at head dim 32, 1.56e-2 at ny 3 and 9 (0.10 of the
  limit), 0 at ny 1 and 8; at C 1024, 0; at C 2048, 1.56e-2 (0.06).
- fp32 gradients against ``jax.grad``: max|d| <= 1e-4 * max(1, max|g|).
  B5 and B6 differentiate the same fp32 formula on both sides; B2's
  backward recomputes attention with B3's plain version and runs B4's
  (natural-exp P, normalised in fp32), where JAX's on the CPU runs XLA's
  VJP of its attention. Observed: B5 2.5e-6, B6 5.7e-6, B2 3.8e-6
  (at most 0.006 of the limit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from countr_tpu.ops import pallas_block as jpb
from countr_tpu_torch.ops.fused_attn import fused_attention
from countr_tpu_torch.ops.fused_block import fused_attention_block
from countr_tpu_torch.ops.fused_cross import fused_cross_attention_block
from countr_tpu_torch.ops.fused_mlp import fused_mlp_block

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _act(rng, shape, dtype):
    """An N(0, 1) activation rounded through ``dtype``: (jax, torch)."""
    jd, td = DT[dtype]
    a = np.array(jnp.asarray(rng.standard_normal(shape), jd).astype(jnp.float32))
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _weights(rng, shapes):
    """fp32 weights 0.05 N(0, 1) (LN scales 1 + that), as flax [in, out]:
    (jax list, torch list with 2-D weights transposed to [out, in])."""
    out = []
    for name, shape in shapes:
        a = (0.05 * rng.standard_normal(shape)).astype(np.float32)
        out.append(a + 1.0 if name == "ln_scale" else a)
    jw = [jnp.asarray(a) for a in out]
    tw = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)) for a in out]
    return jw, tw


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_forward(got, want, dtype):
    d = np.abs(_np(got) - _np(want)).max()
    lim = 3e-5 if dtype == "fp32" else 2.0 ** -5 * max(1.0, np.abs(_np(want)).max())
    assert d <= lim, (d, lim)


def _assert_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        w = _np(w)
        g = _np(g)
        if g.ndim == 2:  # torch [out, in] against flax [in, out]
            g = g.T
        lim = 1e-4 * max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= lim, (name, np.abs(g - w).max(), lim)


def _mlp_weights(rng, c, hid):
    return _weights(rng, [("ln_scale", c), ("ln_bias", c), ("w1", (c, hid)), ("b1", hid),
                          ("w2", (hid, c)), ("b2", c)])


MLP_NAMES = ("x", "ln_scale", "ln_bias", "w_fc1", "b_fc1", "w_fc2", "b_fc2")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("approx_gelu", [True, False], ids=["tanh", "erf"])
def test_b5_forward_matches_pallas(approx_gelu, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _act(rng, (2, 37, 64), dtype)
    jw, tw = _mlp_weights(rng, 64, 256)
    want = jpb.fused_mlp_block(xj, *jw, eps=1e-6, approx_gelu=approx_gelu, interpret=True)
    n0 = fused_mlp_block.launches
    got = fused_mlp_block(xt, *tw, 1e-6, approx_gelu)
    assert fused_mlp_block.launches == n0  # CPU: the plain version ran
    assert got.dtype == DT[dtype][1] and got.shape == xt.shape
    _assert_forward(got, want, dtype)


@pytest.mark.parametrize("approx_gelu", [True, False], ids=["tanh", "erf"])
def test_b5_grads_match_jax(approx_gelu):
    rng = np.random.default_rng(1)
    xj, xt = _act(rng, (2, 37, 64), "fp32")
    jw, tw = _mlp_weights(rng, 64, 128)
    gj, gt = _act(rng, (2, 37, 64), "fp32")
    want = jax.grad(
        lambda *a: jnp.sum(jpb.fused_mlp_block(*a, eps=1e-6, approx_gelu=approx_gelu,
                                               interpret=True) * gj),
        argnums=tuple(range(7)))(xj, *jw)
    ts = [t.clone().requires_grad_(True) for t in [xt, *tw]]
    fused_mlp_block(*ts, 1e-6, approx_gelu).backward(gt)
    _assert_grads([t.grad for t in ts], want, MLP_NAMES)


def _cross_inputs(rng, dtype, b, n, c, ny):
    xj, xt = _act(rng, (b, n, c), dtype)
    kj, kt = _act(rng, (b, ny, c), dtype)
    vj, vt = _act(rng, (b, ny, c), dtype)
    jw, tw = _weights(rng, [("ln_scale", c), ("ln_bias", c), ("wq", (c, c)), ("bq", c),
                            ("wproj", (c, c)), ("bproj", c)])
    return (xj, *jw[:4], kj, vj, *jw[4:]), (xt, *tw[:4], kt, vt, *tw[4:])


CROSS_NAMES = ("x", "ln_scale", "ln_bias", "w_q", "b_q", "k", "v", "w_proj", "b_proj")


# (b, n, c, heads): head dim 16, and the decoder's head dim 32 (C 512,
# 16 heads) at a small N; the widths the card runs with LN(x) streamed:
# C 1024 (one block a tile) and C 2048 (a 2-block cluster a tile), head
# dim 64 and 128, at ny 3 and 8
CROSS_GEOMETRIES = {"hd16": (2, 37, 64, 4), "hd32": (1, 20, 512, 16),
                    "c1024": (1, 9, 1024, 16), "c2048": (1, 5, 2048, 16)}
CROSS_NY = {"hd16": (1, 3, 8, 9), "hd32": (1, 3, 8, 9), "c1024": (3, 8), "c2048": (3, 8)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("geometry,ny", [
    pytest.param(g, ny, id=str(ny) if g == "hd16" else f"{g}-{ny}")
    for g in CROSS_GEOMETRIES for ny in CROSS_NY[g]])
def test_b6_forward_matches_pallas(geometry, ny, dtype):
    """ny <= 8: the JAX kernel in interpret mode; ny 9: both entries take
    their plain route."""
    b, n, c, h = CROSS_GEOMETRIES[geometry]
    rng = np.random.default_rng(2)
    ja, ta = _cross_inputs(rng, dtype, b, n, c, ny)
    want = jpb.fused_cross_attention_block(*ja, h, eps=1e-6, interpret=True)
    n0 = fused_cross_attention_block.launches
    got = fused_cross_attention_block(*ta, h, 1e-6)
    assert fused_cross_attention_block.launches == n0
    assert got.dtype == DT[dtype][1] and got.shape == ta[0].shape
    _assert_forward(got, want, dtype)


@pytest.mark.parametrize("ny", [1, 3, 8, 9])
def test_b6_grads_match_jax(ny):
    rng = np.random.default_rng(3)
    ja, ta = _cross_inputs(rng, "fp32", 2, 37, 64, ny)
    gj, gt = _act(rng, (2, 37, 64), "fp32")
    want = jax.grad(
        lambda *a: jnp.sum(jpb.fused_cross_attention_block(*a, 4, eps=1e-6, interpret=True)
                           * gj),
        argnums=tuple(range(9)))(*ja)
    ts = [t.clone().requires_grad_(True) for t in ta]
    fused_cross_attention_block(*ts, 4, 1e-6).backward(gt)
    _assert_grads([t.grad for t in ts], want, CROSS_NAMES)


@pytest.mark.parametrize("b,n,c,h", [(2, 37, 64, 4), (1, 100, 96, 3)])
def test_b2_grads_match_jax(b, n, c, h):
    """Autograd through the port's B2 entry (its backward: LN and qkv
    recomputed, B3/B4 as plain versions on the CPU) against ``jax.grad``
    of the JAX entry's custom VJP; fp32 weights in, fp32 weight
    gradients out."""
    rng = np.random.default_rng(4)
    xj, xt = _act(rng, (b, n, c), "fp32")
    jw, tw = _weights(rng, [("ln_scale", c), ("ln_bias", c), ("wqkv", (c, 3 * c)),
                            ("bqkv", 3 * c), ("wproj", (c, c)), ("bproj", c)])
    gj, gt = _act(rng, (b, n, c), "fp32")
    want = jax.grad(
        lambda *a: jnp.sum(jpb.fused_attention_block(*a, h, eps=1e-6, interpret=True) * gj),
        argnums=tuple(range(7)))(xj, *jw)
    ts = [t.clone().requires_grad_(True) for t in [xt, *tw]]
    n0, m0 = fused_attention.launches, fused_attention.bwd_launches
    y = fused_attention_block(*ts, h, 1e-6)
    y.backward(gt)
    assert (fused_attention.launches, fused_attention.bwd_launches) == (n0, m0)
    assert all(t.grad.dtype == torch.float32 for t in ts)
    _assert_grads([t.grad for t in ts],
                  want, ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_proj", "b_proj"))


def test_b2_backward_skips_unwanted_gradients():
    """Only the gradients asked for are made: frozen weights get none."""
    rng = np.random.default_rng(5)
    _, xt = _act(rng, (1, 16, 32), "fp32")
    _, tw = _weights(rng, [("ln_scale", 32), ("ln_bias", 32), ("wqkv", (32, 96)),
                           ("bqkv", 96), ("wproj", (32, 32)), ("bproj", 32)])
    x = xt.clone().requires_grad_(True)
    fused_attention_block(x, *tw, 2, 1e-6).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert all(t.grad is None for t in tw)


def test_b2_backward_function_is_the_entrys_backward():
    """``attention_block_bwd``, called directly, gives the entry's
    gradients under autograd exactly, and None where a flag is off."""
    from countr_tpu_torch.ops.fused_block import attention_block_bwd

    rng = np.random.default_rng(6)
    _, xt = _act(rng, (2, 21, 48), "fp32")
    _, tw = _weights(rng, [("ln_scale", 48), ("ln_bias", 48), ("wqkv", (48, 144)),
                           ("bqkv", 144), ("wproj", (48, 48)), ("bproj", 48)])
    _, gt = _act(rng, (2, 21, 48), "fp32")
    ts = [t.clone().requires_grad_(True) for t in [xt, *tw]]
    fused_attention_block(*ts, 3, 1e-6).backward(gt)
    got = attention_block_bwd(gt, xt, *tw, 3, 1e-6, False)
    for a, t in zip(got, ts):
        assert torch.equal(a, t.grad)
    needs = (True, False, False, False, True, True, False)
    part = attention_block_bwd(gt, xt, *tw, 3, 1e-6, False, needs)
    for a, t, need in zip(part, ts, needs):
        assert torch.equal(a, t.grad) if need else a is None


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_mlp_branch_matches_block_modules(dtype):
    """``models/vit.py fused_mlp_branch`` runs a Block's norm2 + Mlp as
    one B5 entry: the same function as the modules (fp32 within 1e-5;
    bf16 within 2^-5 * max(1, max|ref|), the LayerNorms rounding by
    rsqrt here and 1/sqrt there), and in fp32 under autograd the
    gradients of the fp32 parameters match the modules' within
    1e-5 * max(1, max|g|)."""
    from countr_tpu_torch.models.vit import Block, fused_mlp_branch

    td = DT[dtype][1]
    torch.manual_seed(0)
    blk = Block(64, 4, dtype=td, approx_gelu=True)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    _, x = _act(np.random.default_rng(6), (2, 37, 64), dtype)
    with torch.no_grad():
        got = fused_mlp_branch(x, blk.norm2, blk.mlp)
        want = x + blk.mlp(blk.norm2(x))
    assert got.dtype == td
    lim = 1e-5 if dtype == "fp32" else 2.0 ** -5 * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= lim
    if dtype == "bf16":
        return
    params = [*blk.norm2.parameters(), *blk.mlp.parameters()]
    grads = []
    for fn in (lambda: fused_mlp_branch(x, blk.norm2, blk.mlp),
               lambda: x + blk.mlp(blk.norm2(x))):
        blk.zero_grad(set_to_none=True)
        fn().square().sum().backward()
        grads.append([p.grad for p in params])
    for g, w in zip(*grads):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max()))


def test_b6_ptxas_report_reads_registers_spills_and_c7515():
    """The build check's reading of nvcc's -Xptxas -v log: one entry per
    B6 kernel instantiation (other kernels left out), its registers and
    spill bytes, and a C7515 wgmma-serialisation warning tied to it."""
    from countr_tpu_torch.ops.fused_cross import ptxas_report

    b6 = "_ZN12_GLOBAL__N_118cross_block_kernelILi32EEEv14CUtensorMap_st"
    other = "_ZN12_GLOBAL__N_114gemm_nt_kernelILi128ELi1EEEv14CUtensorMap_st"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{other}' for 'sm_90a'",
        f"ptxas info    : Function properties for {other}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        f"ptxas info    : Compiling entry function '{b6}' for 'sm_90a'",
        f"ptxas info    : Function properties for {b6}",
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 3 barriers",
        "ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
        f"are serialized in the function '{b6}'",
    ])
    (entry,) = ptxas_report(log)
    assert entry["function"] == b6 and entry["registers"] == 128
    assert (entry["stack_frame"], entry["spill_stores"], entry["spill_loads"]) == (16, 12, 8)
    assert len(entry["c7515"]) == 1
    assert ptxas_report(log.replace("(C7515)", "(C7510)"))[0]["c7515"] == []
