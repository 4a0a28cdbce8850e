"""HGN's plain version (countr_tpu_torch/ops/fused_gn.py: the density
head's conv bias + GroupNorm + ReLU, and at the subpixel stage 3 the pred
conv) on the CPU, and the density head's dispatch to it.

- Against the composition it replaces in the port (``ops/conv.py``'s bias
  add, ``ops/norms.py group_norm``, ReLU; ``ops/subpixel.py``
  ``gn_phase_stats`` / ``gn_phase_apply`` + ReLU + ``pred_phase_flat``)
  and against the JAX package's head ops, at small head shapes with
  several tiles, in fp32 and bf16, in NHWC and NCHW order (a conv returns
  either). fp32: within 1e-5 of max|ref| (statistics summed in tiles, in
  another order; 1e-5 where a reading is ~1e-7). bf16: each output
  within one rounding of the reference, 2^-7 * |ref| + 1e-5 (both round
  at the same points after fp32 statistics that differ in the last
  bits); the pred fold's dot of such values, rounded once more, within
  2^-6 of max|ref|; against JAX's bf16 head the same bounds.
- The statistics against float64, no less accurate than the two-pass
  fp32 arithmetic they replaced (data far off zero, where a raw sum of
  squares would lose digits).
- Dispatch: with no gradient recorded the head calls HGN four times (its
  plain version here, no launch counted); under autograd it keeps the
  ATen chain, its output and every gradient the same bits as before.
- The wrappers' refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from countr_tpu.ops import norms as jnorms
from countr_tpu.ops import subpixel as jsub
from countr_tpu_torch.models import countr as tcountr
from countr_tpu_torch.ops import subpixel as tsub
from countr_tpu_torch.ops.conv import conv2d_nhwc
from countr_tpu_torch.ops.fused_gn import (
    fused_group_norm, fused_group_norm_phase, group_norm_phase_plain, group_norm_relu_plain,
    group_stats_plain, tile_plan,
)
from countr_tpu_torch.ops.launches import launch_counts
from countr_tpu_torch.ops.norms import group_norm
from tests import torch_port_helpers  # noqa: F401  (one intra-op thread)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _order(x: torch.Tensor, order: str) -> torch.Tensor:
    """x [N, H, W, C] with the same values, laid out NHWC or NCHW."""
    x = x.contiguous()
    return x if order == "nhwc" else x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


def _close(got, want, dtype):
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    else:
        assert bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all()), float(d.max())


def _stage_args(rng, shape, dtype, order):
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 1.5 + 0.3).to(dtype)
    vec = [torch.from_numpy(v.astype(np.float32)) for v in
           (0.3 * rng.standard_normal(c), 1 + 0.1 * rng.standard_normal(c),
            0.1 * rng.standard_normal(c))]
    return (_order(x, order), *vec)


def _phase_inputs(rng, dtype, order, n=2, h=24, w=25, cin=8, c=32):
    """A stage-3 input x, conv3's kernel and bias, the phase tensor made
    without the bias (in ``order``) and the ring strips (with it)."""
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32)).to(dtype)
    k = torch.from_numpy((0.2 * rng.standard_normal((c, cin, 3, 3))).astype(np.float32))
    b = torch.from_numpy((0.3 * rng.standard_normal(c)).astype(np.float32))
    ph = _order(tsub.phase_conv2x_core(x, k, None), order)
    return x, k, b, ph, tsub.ring_strips(x, k, b)


def _gn_params(rng, c):
    return [torch.from_numpy(v.astype(np.float32)) for v in
            (1 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
             0.2 * rng.standard_normal((c, 1)), 0.1 * rng.standard_normal(1))]


@pytest.mark.parametrize("order", ["nhwc", "nchw"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_stage_plain_matches_aten_chain(dt, order):
    rng = np.random.default_rng(0)
    dtype = DTYPES[dt]
    x, cb, s, b = _stage_args(rng, (2, 48, 50, 32), dtype, order)
    assert tile_plan(x, 32, 8)[0] < 48 * 50  # several tiles a sample
    got = group_norm_relu_plain(x, cb, s, b, 8)
    assert got.dtype == dtype
    _close(got, F.relu(group_norm(x + cb.to(dtype), s, b, 8)), dtype)
    assert torch.equal(fused_group_norm(x, cb, s, b, 8), got)  # the CPU wrapper: plain


@pytest.mark.parametrize("order", ["nhwc", "nchw"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_phase_plain_matches_aten_chain(dt, order):
    rng = np.random.default_rng(1)
    dtype = DTYPES[dt]
    _, _, bias, ph, strips = _phase_inputs(rng, dtype, order)
    gs, gb, pk, pb = _gn_params(rng, 32)
    z, mean, rstd = group_norm_phase_plain(ph, strips, bias, gs, gb, 4, pk.to(dtype), pb)
    phb = ph + bias.repeat(4).to(dtype)
    mean_w, rstd_w = tsub.gn_phase_stats(phb, strips, 4, c_real=32)
    torch.testing.assert_close(mean, mean_w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rstd_w, rtol=1e-5, atol=0)
    yb = F.relu(tsub.gn_phase_apply(phb, mean_w, rstd_w, gs, gb, c_real=32))
    want = tsub.pred_phase_flat(yb, pk.to(dtype), pb)
    assert z.dtype == dtype and z.shape == want.shape == (2, 24, 25, 4)
    lim = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * float(want.float().abs().max())
    assert float((z.float() - want.float()).abs().max()) <= lim
    got = fused_group_norm_phase(ph, strips, bias, gs, gb, 4, pk.to(dtype), pb)
    for a, w_ in zip(got, (z, mean, rstd)):
        assert torch.equal(a, w_)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_plain_against_jax_head_ops(dt):
    """A stage and the subpixel stage 3 against the JAX package's head ops
    on the same numbers (JAX adds the conv bias inside its conv)."""
    rng = np.random.default_rng(2)
    dtype = DTYPES[dt]
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    x, cb, s, b = _stage_args(rng, (2, 40, 36, 32), dtype, "nhwc")
    xb = (x + cb.to(dtype)).float().numpy()
    want = np.asarray(jnp.maximum(jnorms.group_norm(
        jnp.asarray(xb, jdt), jnp.asarray(s.numpy()), jnp.asarray(b.numpy()), 8), 0))
    _close(group_norm_relu_plain(x, cb, s, b, 8), torch.from_numpy(want.astype(np.float32)),
           dtype)

    xin, k, bias, ph, strips = _phase_inputs(rng, dtype, "nhwc")
    gs, gb, pk, pb = _gn_params(rng, 32)
    z, _, _ = group_norm_phase_plain(ph, strips, bias, gs, gb, 4, pk.to(dtype), pb)
    xj = jnp.asarray(xin.float().numpy(), jdt)
    kj = jnp.asarray(k.numpy().transpose(2, 3, 1, 0))
    bj = jnp.asarray(bias.numpy())
    ph_j = jsub.phase_conv2x_core(xj, kj, bj)
    strips_j = jsub.ring_strips(xj, kj, bj)
    mean_j, rstd_j = jsub.gn_phase_stats(ph_j, strips_j, 4, c_real=32)
    yb = jnp.maximum(jsub.gn_phase_apply(ph_j, mean_j, rstd_j, jnp.asarray(gs.numpy()),
                                         jnp.asarray(gb.numpy()), c_real=32), 0)
    z_j = np.asarray(jsub.pred_phase_flat(yb, jnp.asarray(pk.numpy(), jdt),
                                          jnp.asarray(pb.numpy())), np.float32)
    lim = (2.0 ** -6 if dtype == torch.bfloat16 else 1e-5) * float(np.abs(z_j).max())
    assert float(np.abs(z.float().numpy() - z_j).max()) <= lim


def _fp64_moments(x64, g):
    n, h, w, c = x64.shape
    xg = x64.reshape(n, h * w, g, c // g)
    mean = xg.mean(dim=(1, 3))
    var = (xg - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return mean, var


@pytest.mark.parametrize("order", ["nhwc", "nchw"])
def test_statistics_no_less_accurate_than_two_pass(order):
    """mean, rstd and the stage-3 sums of squares against float64, on data
    with a mean of 20 and a spread of 1: the tiles' merges are within the
    two-pass fp32 arithmetic's error (or 4 fp32 ulps, where both are
    exact to rounding)."""
    rng = np.random.default_rng(3)
    x = _order(torch.from_numpy(
        (20 + rng.standard_normal((2, 64, 72, 32))).astype(np.float32)), order)
    zero = torch.zeros(32)
    floor = 4 * 2.0 ** -24
    mean64, var64 = _fp64_moments(x.double(), 8)
    rstd64 = 1 / torch.sqrt(var64 + 1e-5)
    mean, rstd = group_stats_plain(x, zero, 8).unbind(1)
    xg = x.reshape(2, -1, 8, 4)  # the two-pass fp32 arithmetic of ops/norms.py
    mean_2p = xg.mean(dim=(1, 3))
    var_2p = (xg - mean_2p[:, None, :, None]).square().mean(dim=(1, 3))
    rstd_2p = torch.reciprocal(torch.sqrt(var_2p + 1e-5))
    for got, old, ref in ((mean, mean_2p, mean64), (rstd, rstd_2p, rstd64)):
        err = float(((got.double() - ref) / ref).abs().max())
        old_err = float(((old.double() - ref) / ref).abs().max())
        assert err <= max(old_err, floor), (err, old_err)
    s1, s2 = group_stats_plain(x, zero, 8, sums=True).unbind(1)
    s1_old, s2_old = tsub._sums_flat(x, 32, 8)  # the stage-3 sums they replace
    xg64 = x.double().reshape(2, -1, 8, 4)
    for got, old, ref in ((s1, s1_old, xg64.sum(dim=(1, 3))),
                          (s2, s2_old, xg64.square().sum(dim=(1, 3)))):
        err = float(((got.double() - ref) / ref).abs().max())
        old_err = float(((old.double() - ref) / ref).abs().max())
        assert err <= max(old_err, floor), (err, old_err)


def _head_stages(seed, width=32, cin=16):
    torch.manual_seed(seed)
    stages = []
    for k in range(4):
        layers = [nn.Conv2d(cin if k == 0 else width, width, 3, padding=1),
                  nn.GroupNorm(8, width), nn.ReLU()]
        if k == 3:
            layers.append(nn.Conv2d(width, 1, 1))
        stages.append(nn.Sequential(*layers))
    with torch.no_grad():
        for st in stages:
            st[1].weight.uniform_(0.8, 1.2)
            st[1].bias.uniform_(-0.1, 0.1)
    return stages


def _aten_head(x, stages, dtypes, subpixel):
    """The density head as the port ran it before HGN: every stage's conv
    bias, GroupNorm and ReLU in ATen ops (autograd's path still)."""
    def stage(x, st, dt):
        y = conv2d_nhwc(x.to(dt), st[0].weight, st[0].bias, 1)
        return F.relu(group_norm(y, st[1].weight, st[1].bias, 8, st[1].eps))

    for idx in range(3):
        x = stage(x, stages[idx], dtypes[idx])
        if idx < 2 or not subpixel:
            x = tcountr.upsample2x_bilinear(x)
    pred = stages[3][3]
    if not subpixel:
        x = stage(x, stages[3], dtypes[3])
        x = conv2d_nhwc(x.to(dtypes[4]), pred.weight, pred.bias, 0)
        return tcountr.upsample2x_bilinear(x)[..., 0]
    dt = dtypes[0]
    n, h, w, _ = x.shape
    conv3, gn3 = stages[3][0], stages[3][1]
    width = conv3.weight.shape[0]
    pk = pred.weight.reshape(1, width).t()
    xd = x.to(dt)
    ph = tsub.phase_conv2x_core(xd, conv3.weight, conv3.bias)
    strips = tsub.ring_strips(xd, conv3.weight, conv3.bias)
    mean, rstd = tsub.gn_phase_stats(ph, strips, 8, c_real=width)
    yb = F.relu(tsub.gn_phase_apply(ph, mean, rstd, gn3.weight, gn3.bias, c_real=width))
    z4 = tsub.pred_phase_flat(yb, pk.to(dt), pred.bias)
    zs = [(F.relu(tsub.gn_phase_apply(s, mean, rstd, gn3.weight, gn3.bias, c_real=width))
           @ pk.to(dt) + pred.bias.to(dt))[..., 0] for s in strips]
    return tsub.upsample2x_phase(tsub.scatter_ring(z4.reshape(n, h, w, 2, 2), *zs))


HEADS = [("bf16", True), ("fp32", False), ("fp32", True)]


def _spied(monkeypatch):
    calls = []
    for name in ("fused_group_norm", "fused_group_norm_phase"):
        fn = getattr(tcountr, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(tcountr, name, spy)
    return calls


@pytest.mark.parametrize("dt,subpixel", HEADS)
def test_density_head_takes_hgn_without_grad(monkeypatch, dt, subpixel):
    """No gradient recorded: four HGN stage calls (the plain version on
    the CPU, no launch counted), output within a rounding a stage of the
    ATen chain's; the grid itself may require grad."""
    stages = _head_stages(4)
    dtypes = (DTYPES[dt],) * 5
    grid = torch.randn(2, 24, 24, 16).to(dtypes[0])
    calls = _spied(monkeypatch)
    before = launch_counts()["HGN"]
    with torch.no_grad():
        want = _aten_head(grid, stages, dtypes, subpixel).float()
        got = tcountr.density_head(grid.requires_grad_(), stages, dtypes, subpixel).float()
    assert launch_counts()["HGN"] == before == fused_group_norm.launches
    assert calls == (["fused_group_norm"] * 3 + ["fused_group_norm_phase"] if subpixel
                     else ["fused_group_norm"] * 4)
    top = float(want.abs().max())
    d = float((got - want).abs().max())
    assert d <= (2.0 ** -5 if dt == "bf16" else 1e-5) * top


@pytest.mark.parametrize("dt,subpixel", HEADS)
def test_density_head_keeps_aten_chain_under_autograd(monkeypatch, dt, subpixel):
    """The finetune step's head (parameters requiring grad, grad mode on):
    HGN not called, the output and every gradient the same bits as the
    ATen chain's."""
    dtypes = (DTYPES[dt],) * 5
    grid = torch.randn(2, 24, 24, 16).to(dtypes[0])
    cot = None
    outs = []
    for path in ("head", "aten"):
        stages = _head_stages(5)
        calls = _spied(monkeypatch)
        fn = tcountr.density_head if path == "head" else _aten_head
        out = fn(grid, stages, dtypes, subpixel)
        if cot is None:
            cot = torch.randn(out.shape).to(out.dtype)
        (out * cot).float().sum().backward()
        assert calls == []
        outs.append((out.detach(), [p.grad for st in stages for p in st.parameters()]))
    (got, g_got), (want, g_want) = outs
    assert torch.equal(got, want)
    assert len(g_got) == len(g_want) == 18
    for a, b in zip(g_got, g_want):
        assert a is not None and torch.equal(a, b)


def test_wrappers_refuse_malformed_input():
    rng = np.random.default_rng(6)
    x, cb, s, b = _stage_args(rng, (2, 8, 8, 32), torch.bfloat16, "nhwc")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_group_norm(x.half(), cb, s, b, 8)
    with pytest.raises(ValueError, match=r"\[N, H, W, C\]"):
        fused_group_norm(x[0], cb, s, b, 8)
    with pytest.raises(ValueError, match="groups"):
        fused_group_norm(x, cb, s, b, 6)
    with pytest.raises(ValueError, match="shift"):
        fused_group_norm(x, cb, s, b[:16], 8)
    with pytest.raises(ValueError, match="gradient"):
        fused_group_norm(x, cb, s.clone().requires_grad_(), b, 8)
    with torch.no_grad():  # no gradient recorded: taken
        fused_group_norm(x, cb, s.clone().requires_grad_(), b, 8)
    _, _, bias, ph, strips = _phase_inputs(rng, torch.bfloat16, "nhwc")
    gs, gb, pk, pb = _gn_params(rng, 32)
    with pytest.raises(ValueError, match="pred_kernel"):
        fused_group_norm_phase(ph, strips, bias, gs, gb, 4, pk, pb)  # fp32 pred kernel
    with pytest.raises(ValueError, match=r"\[N, h, w, 128\]"):
        fused_group_norm_phase(ph[..., :96], strips, bias, gs, gb, 4, pk.to(torch.bfloat16), pb)
