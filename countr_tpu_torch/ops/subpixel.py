"""Fused 2x-upsample + 3x3-conv as a phase-space (subpixel) conv
(counterpart of ``countr_tpu/ops/subpixel.py``; the derivation and the
exactness argument are in that module's docstring).

conv3x3(upsample2x(x)) equals one 3x3 conv at the LOW resolution that
produces the four output phases, z[2i+p, 2j+q] = (x * K'[p, q])[i, j].
Everything downstream (GroupNorm, ReLU, the 1x1 pred conv, the final 2x
upsample) consumes the flat phase layout [N, h, w, 4*C] directly. The
low-resolution zero padding makes the outermost two high-res rows/cols
wrong; the true ring is computed from four thin strips, the GroupNorm
statistics are corrected from them by inclusion-exclusion, and the ring
is written back after the pred conv on the small [N, h, w, 2, 2] tensor.

Activations are NHWC; conv weights are in torch's OIHW layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from countr_tpu_torch.ops import device_constant
from countr_tpu_torch.ops.conv import conv2d_nhwc
from countr_tpu_torch.ops.upsample import _up2x_matrix, up2x_matrix


@functools.lru_cache(maxsize=None)
def _tap_tensor() -> np.ndarray:
    """T[p, t, a]: weight of low-res x[i+a-1] inside conv tap t of
    output phase p, for interior rows of up2x."""
    T = np.zeros((2, 3, 3), np.float32)
    T[0, 0] = [0.75, 0.25, 0.0]  # y[2i-1]
    T[0, 1] = [0.25, 0.75, 0.0]  # y[2i]
    T[0, 2] = [0.0, 0.75, 0.25]  # y[2i+1]
    T[1, 0] = [0.25, 0.75, 0.0]  # y[2i]
    T[1, 1] = [0.0, 0.75, 0.25]  # y[2i+1]
    T[1, 2] = [0.0, 0.25, 0.75]  # y[2i+2]
    return T


def compose_phase_kernel(weight: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] OIHW kernel -> [4*Cout, Cin, 3, 3] composite
    phase kernel, output channels ordered (p, q, cout), built in fp32."""
    T = device_constant(_tap_tensor, (), weight.device, torch.float32)
    kp = torch.einsum("pta,qsb,oits->pqoiab", T, T, weight.float())
    _, _, co, ci, _, _ = kp.shape
    return kp.reshape(4 * co, ci, 3, 3)


def phase_conv2x_core(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None
) -> torch.Tensor:
    """conv3x3(up2x(x)) in FLAT phase layout with zero padding at the low
    resolution: x [N, h, w, Cin] -> [N, h, w, 4*Cout], channels ordered
    (p, q, cout). Wrong on the outermost two high-res rows/cols; pair
    with ring_strips for exact edges. ``bias`` None leaves the bias out
    (for a consumer that adds it itself, ops/fused_gn.py)."""
    ph = conv2d_nhwc(x, compose_phase_kernel(weight), None, padding=1)
    if bias is None:
        return ph
    return ph + bias.repeat(4).to(ph.dtype)


def ring_strips(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """The TRUE outermost two high-res rows/cols of conv3x3(up2x(x)),
    from thin strips of the exact upsample (clamped taps) with the
    conv's high-res zero padding.

    Returns (top, bot, left, right): top/bot [N, 2, 2w, Cout] are
    high-res rows (0, 1) / (2h-2, 2h-1); left/right [N, 2h, 2, Cout]
    are high-res cols (0, 1) / (2w-2, 2w-1) over all rows."""
    n, h, w, cin = x.shape
    wc = up2x_matrix(w, x)
    wr = up2x_matrix(h, x)
    hi, lo = 0.75, 0.25

    def up_cols(rows):  # [N, r, w, C] -> [N, r, 2w, C]
        return torch.einsum("nrwc,wW->nrWc", rows, wc)

    def up_rows(cols):  # [N, h, r, C] -> [N, 2h, r, C]
        return torch.einsum("nhrc,hH->nHrc", cols, wr)

    b_ = bias.to(x.dtype)
    zero_row = x.new_zeros((n, 1, 2 * w, cin))
    ytop = up_cols(torch.stack(
        [x[:, 0], hi * x[:, 0] + lo * x[:, 1], lo * x[:, 0] + hi * x[:, 1]], 1
    ))
    ybot = up_cols(torch.stack(
        [hi * x[:, h - 2] + lo * x[:, h - 1],
         lo * x[:, h - 2] + hi * x[:, h - 1], x[:, h - 1]], 1
    ))
    # rows VALID (explicit zero row), cols SAME
    top = conv2d_nhwc(torch.cat([zero_row, ytop], 1), weight, None, (0, 1)) + b_
    bot = conv2d_nhwc(torch.cat([ybot, zero_row], 1), weight, None, (0, 1)) + b_

    zero_col = x.new_zeros((n, 2 * h, 1, cin))
    yleft = up_rows(torch.stack(
        [x[:, :, 0], hi * x[:, :, 0] + lo * x[:, :, 1],
         lo * x[:, :, 0] + hi * x[:, :, 1]], 2
    ))
    yright = up_rows(torch.stack(
        [hi * x[:, :, w - 2] + lo * x[:, :, w - 1],
         lo * x[:, :, w - 2] + hi * x[:, :, w - 1], x[:, :, w - 1]], 2
    ))
    left = conv2d_nhwc(torch.cat([zero_col, yleft], 2), weight, None, (1, 0)) + b_
    right = conv2d_nhwc(torch.cat([yright, zero_col], 2), weight, None, (1, 0)) + b_
    return top, bot, left, right


@functools.lru_cache(maxsize=None)
def _group_map(c_last: int, c_real: int, num_groups: int) -> np.ndarray:
    """Channel -> group index for a flat layout whose last dim is
    ``c_last`` = (phases *) c_real, grouped over the REAL channel
    (c % c_real) like torch GroupNorm."""
    cs = np.arange(c_last)
    return ((cs % c_real) * num_groups // c_real).astype(np.int64)


def _sums_flat(v: torch.Tensor, c_real: int, g: int):
    """v [N, ..., C_last] -> (sum, sum_sq) [N, G] fp32 per GroupNorm
    group, C_last = reps * c_real with channel c in group c // (c_real/G)."""
    n, c_last = v.shape[0], v.shape[-1]
    v32 = v.float().reshape(n, -1, c_last // c_real, g, c_real // g)
    return v32.sum(dim=(1, 2, 4)), v32.square().sum(dim=(1, 2, 4))


def gn_phase_stats(ph, strips, num_groups: int, c_real: int = 256,
                   eps: float = 1e-5):
    """Corrected GroupNorm statistics for the FLAT phase tensor
    [N, h, w, 4*C]: the ring lines inside ``ph`` are swapped for the true
    strip values by inclusion-exclusion (the four 2x2-block corners are
    in both a row and a col strip). Returns (mean, rstd) [N, G] fp32."""
    s1, s2 = _sums_flat(ph, c_real, num_groups)
    return gn_phase_moments(s1, s2, ph, strips, num_groups, c_real, eps)


def gn_phase_moments(s1, s2, ph, strips, num_groups: int, c_real: int = 256,
                     eps: float = 1e-5, ph_bias=None):
    """(mean, rstd) [N, G] fp32 from the sums ``s1``, ``s2`` [N, G] of the
    whole phase tensor, ring-corrected as ``gn_phase_stats`` does. ``ph``
    supplies the ring lines to take out; ``ph_bias`` [4*C], where given,
    is added to them first (a ``ph`` made without its conv bias)."""
    top, bot, left, right = strips
    n, h, w, _ = ph.shape
    g = num_groups
    count = (2 * h) * (2 * w) * (c_real // g)

    ph_rows = torch.cat([ph[:, :1], ph[:, h - 1:]], 1)
    ph_cols = torch.cat([ph[:, :, :1], ph[:, :, w - 1:]], 2)
    if ph_bias is not None:
        ph_rows, ph_cols = ph_rows + ph_bias, ph_cols + ph_bias
    ph_corn = torch.cat([ph_rows[:, :, :1], ph_rows[:, :, w - 1:]], 2)
    tr_rows = torch.cat([top, bot], 1)          # [N, 4, 2w, C]
    tr_cols = torch.cat([left, right], 2)       # [N, 2h, 4, C]
    tr_corn = torch.cat([tr_rows[:, :, :2], tr_rows[:, :, -2:]], 2)

    for v, sgn in ((ph_rows, -1), (ph_cols, -1), (ph_corn, +1),
                   (tr_rows, +1), (tr_cols, +1), (tr_corn, -1)):
        d1, d2 = _sums_flat(v, c_real, g)
        s1 = s1 + sgn * d1
        s2 = s2 + sgn * d2

    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    return mean, rstd


def gn_phase_apply(v, mean, rstd, scale, bias, c_real: int = 256):
    """Normalize + affine with precomputed per-(N, group) stats on a FLAT
    layout [N, ..., C_last] (the big phase tensor or a strip)."""
    n, c_last = v.shape[0], v.shape[-1]
    gm = device_constant(_group_map, (c_last, c_real, mean.shape[1]), v.device, torch.int64)
    shape = (n,) + (1,) * (v.dim() - 2) + (c_last,)
    mean_c = mean[:, gm].reshape(shape)
    rstd_c = rstd[:, gm].reshape(shape)
    reps = c_last // c_real
    sc = scale.float().repeat(reps)
    bi = bias.float().repeat(reps)
    return ((v.float() - mean_c) * rstd_c * sc + bi).to(v.dtype)


def pred_phase_flat(v, pred_kernel, pred_bias):
    """The 1x1 pred conv on the FLAT phase tensor [N, h, w, 4*C] ->
    [N, h, w, 4] via a block-diagonal [4C, 4] matrix. pred_kernel [C, 1],
    pred_bias [1]."""
    c = pred_kernel.shape[0]
    eye = torch.eye(4, device=v.device)
    blk = torch.einsum("pz,co->pcz", eye, pred_kernel.float())
    blk = blk.reshape(4 * c, 4).to(v.dtype)
    out = torch.einsum("nhwc,cz->nhwz", v, blk)
    return out + pred_bias.to(out.dtype)


def scatter_ring(z: torch.Tensor, zt, zb, zl, zr) -> torch.Tensor:
    """Overwrite the ring of the SMALL post-pred phase tensor z
    [N, h, w, 2, 2] with the true strip values zt/zb [N, 2, 2w], zl/zr
    [N, 2h, 2] (cols after rows; the corner blocks agree exactly)."""
    n, h, w, _, _ = z.shape
    z = z.clone()
    z[:, 0] = zt.reshape(n, 2, w, 2).permute(0, 2, 1, 3)
    z[:, h - 1] = zb.reshape(n, 2, w, 2).permute(0, 2, 1, 3)
    z[:, :, 0] = zl.reshape(n, h, 2, 2)
    z[:, :, w - 1] = zr.reshape(n, h, 2, 2)
    return z


def upsample2x_phase(z: torch.Tensor) -> torch.Tensor:
    """Final 2x bilinear upsample consuming phase layout: z
    [N, h, w, 2, 2] -> [N, 4h, 4w]; the [2h, 4h] band matrix's input
    axis is reindexed (i, p) -> 2i+p."""
    _, h, w, _, _ = z.shape
    ur = device_constant(_up2x_matrix, (2 * h,), z.device, z.dtype).reshape(h, 2, 4 * h)
    uc = device_constant(_up2x_matrix, (2 * w,), z.device, z.dtype).reshape(w, 2, 4 * w)
    out = torch.einsum("nijpq,ipH->njqH", z, ur)
    return torch.einsum("njqH,jqW->nHW", out, uc)
