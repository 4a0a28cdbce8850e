"""Kernel HGN: the density head's conv bias + GroupNorm + ReLU, in Triton,
as two passes over the conv output (statistics; normalise + ReLU), with
the 1x1 pred conv folded into the second pass at the subpixel stage 3.

Replaces no TPU kernel: the JAX package leaves this chain to XLA
(``countr_tpu/ops/norms.py group_norm``; ``countr_tpu/ops/subpixel.py``
``gn_phase_stats``, ``gn_phase_apply``, ``pred_phase_flat``), which fuses
it into one or two passes. Op by op in PyTorch it is ~10 fp32 passes a
stage (casts, mean, sub, square, mul, add, the cast back, ReLU, and the
conv's bias add before them), most of the counting forward's elementwise
time.

What bounds it on the H100: memory. A stage reads its conv output twice
(once for the statistics, once to normalise) and writes its result once,
~10 FLOP an element. At the count build's window batch of 16 (bf16):
stage 0 [16, 24, 24, 256] 4.7 MB a pass, stage 1 [16, 48, 48, 256] 18.9
MB, stage 2 [16, 96, 96, 256] 75.5 MB; stage 3's phase tensor [16, 96,
96, 1024] is read twice (302 MB each) and only the pred conv's [16, 96,
96, 4] output is written. ~0.9 GB a window batch, 0.27 ms at 3.35 TB/s.

What the design does about it. A stage's input is x [N, H, W, P*C]:
NHWC (P = 1) or the flat phase layout (P = 4 phases of the C channels,
ordered (p, q, c)), in NHWC or NCHW memory order, as the conv returned
it (the upsamples' einsums hand the later convs NCHW order; the output
keeps the input's order). A program takes a tile of one sample and one
phase, as a [pixels, groups, C/G] register block, adds the conv bias
there and rounds to the input dtype, as the bias add of ``ops/conv.py``
did, so the convolution runs without its bias. ``tile_plan`` shapes the
tile so that the loads run along the contiguous axis: in NHWC order 32
pixels of all 8 groups (each pixel's 256 channels together), in NCHW
order 256 pixels of one group (a channel's 512 bytes), a program each;
the unit stride is a constexpr (``NCHW``), so that the compiler sees the
contiguous axis, and reductions take that axis first.

- ``_hgn_stats``: each tile's per-group sum and the sum of squares about
  the tile's own mean (fp32); ``_hgn_merge``, one program a sample, merges
  the tiles' partials in a fixed order (Chan's formula: M2 = sum M2_t +
  sum n_t (mean_t - mean)^2), into mean and 1/sqrt(var + eps) or, for
  stage 3's ring correction (``ops/subpixel.py gn_phase_moments``), into
  the sum and the sum of squares. No atomics: the same inputs give the
  same bits, and the passes can be captured in a CUDA graph.
- ``_hgn_apply``: ((v - mean) * rstd) * scale + shift in fp32 (no FMA
  contraction: the rounding of the separate PyTorch ops), ReLU, rounded
  to the input dtype and stored; or, with FOLD, each pixel's C values of
  a phase, so rounded, dotted with the pred kernel in fp32 (a program
  loops over the groups of 64 pixels, accumulating the products, and
  sums them once), rounded, plus the pred bias in the input dtype: the
  [N, h, w, 4] output of ``pred_phase_flat``, and the normalised phase
  tensor is never written.

The wrappers: ``fused_group_norm`` (a stage on NHWC) and
``fused_group_norm_phase`` (stage 3 in phase layout; the ring
correction's strips stay in PyTorch). On a CUDA tensor they launch the
kernels or raise; on a CPU tensor they run ``group_norm_relu_plain`` and
``group_norm_phase_plain``, the same arithmetic in PyTorch (the same
tiles and merges). Neither records a gradient: they refuse a tensor that
requires one while grad mode is on (``models/countr.py density_head``
takes the ATen chain there). ``fused_group_norm.launches`` counts stage
calls on the card: four a density-head forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from countr_tpu_torch.ops.fused_ln import _pow2_at_least
from countr_tpu_torch.ops.subpixel import gn_phase_moments

DTYPES = (torch.bfloat16, torch.float32)
TILE_ELEMS = 8192  # elements a program's tile (statistics, normalising pass)
MERGE_TILES = 256  # tiles' partials a merge program loads at once
FOLD_PIXELS = 64  # pixels a tile of the pred fold in NCHW order

_KERNELS = None


def _hgn_kernels():
    """Build (once) and return the three Triton kernels. ``triton`` is
    imported here, at first launch, so that this module imports without
    it."""
    global _KERNELS, _tile, _normalized, _group_sums, tl
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit  # a module global, so that the kernels below can call it
    def _tile(X, CB, n, t, g0, HW, TPP, s_n, s_ph, s_pix, s_c, CG: tl.constexpr,
              CGP: tl.constexpr, GB: tl.constexpr, BLOCK_R: tl.constexpr,
              NCHW: tl.constexpr):
        # groups g0..g0+GB of tile t of sample n (BLOCK_R pixels of one
        # phase, TPP tiles a phase) as [BLOCK_R, GB, CGP], the conv bias
        # added and rounded to X's dtype, 0 outside the tile. The unit
        # stride (a pixel's in NCHW order, else a channel's) is left out of
        # the arithmetic, so that the compiler sees which axis is
        # contiguous and vectorises the loads along it.
        ph = t // TPP
        pix = (t - ph * TPP) * BLOCK_R + tl.arange(0, BLOCK_R)
        gi = tl.arange(0, GB)
        ci = tl.arange(0, CGP)
        ch = (g0 + gi)[:, None] * CG + ci[None, :]
        chm = (gi[:, None] < GB) & (ci[None, :] < CG)
        m = (pix < HW)[:, None, None] & chm[None, :, :]
        base = n.to(tl.int64) * s_n + ph * s_ph
        if NCHW:
            offs = pix[:, None, None] + ch[None, :, :] * s_c
        else:
            offs = pix[:, None, None] * s_pix + ch[None, :, :]
        x = tl.load(X + base + offs, mask=m, other=0.0).to(tl.float32)
        b = tl.load(CB + ch, mask=chm, other=0.0).to(tl.float32)
        v = (x + b[None, :, :]).to(X.dtype.element_ty).to(tl.float32)
        return tl.where(m, v, 0.0), m, base, offs, pix, ph, ch, chm

    @triton.jit  # a module global too
    def _group_sums(v, NCHW: tl.constexpr):
        # [BLOCK_R, GB, CGP] -> [GB]: the contiguous axis first, which lies
        # across a warp's threads, then the other
        if NCHW:
            return tl.sum(tl.sum(v, axis=0), axis=1)
        return tl.sum(tl.sum(v, axis=2), axis=0)

    @triton.jit
    def _hgn_stats(X, CB, PART, HW, TPP, s_n, s_ph, s_pix, s_c, G: tl.constexpr,
                   CG: tl.constexpr, CGP: tl.constexpr, GB: tl.constexpr,
                   BLOCK_R: tl.constexpr, NCHW: tl.constexpr):
        # grid (tiles, G / GB, N): one tile's GB groups a program
        t = tl.program_id(0)
        g0 = tl.program_id(1) * GB
        n = tl.program_id(2)
        v, m, _, _, _, _, _, _ = _tile(X, CB, n, t, g0, HW, TPP, s_n, s_ph, s_pix, s_c,
                                       CG, CGP, GB, BLOCK_R, NCHW)
        cnt = (tl.minimum(HW - (t % TPP) * BLOCK_R, BLOCK_R) * CG).to(tl.float32)
        s = _group_sums(v, NCHW)  # [GB]
        mean = tl.div_rn(s, tl.zeros_like(s) + cnt)
        d = tl.where(m, v - mean[None, :, None], 0.0)
        m2 = _group_sums(d * d, NCHW)
        gi = tl.arange(0, GB)
        base = (n * tl.num_programs(0) + t) * 2 * G + g0
        tl.store(PART + base + gi, s)
        tl.store(PART + base + G + gi, m2)

    @triton.jit
    def _hgn_merge(PART, OUT, HW, TPP, n_tiles, eps, G: tl.constexpr, CG: tl.constexpr,
                   BLOCK_R: tl.constexpr, BLOCK_T: tl.constexpr, SUMS: tl.constexpr):
        # OUT[n] = (mean, rstd) or, with SUMS, (sum, sum of squares), [2, G],
        # from the n_tiles tiles' (sum, M2) in a fixed order
        n = tl.program_id(0)
        gi = tl.arange(0, G)
        total = (n_tiles // TPP * HW * CG).to(tl.float32)
        acc = tl.zeros([BLOCK_T, G], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK_T, G], dtype=tl.float32)
        for t0 in range(0, n_tiles, BLOCK_T):
            t = t0 + tl.arange(0, BLOCK_T)
            tm = (t < n_tiles)[:, None] & (gi[None, :] < G)
            base = (n * n_tiles + t) * 2 * G
            s = tl.load(PART + base[:, None] + gi[None, :], mask=tm, other=0.0)
            acc += s
            if SUMS:
                cnt = (tl.minimum(HW - (t % TPP) * BLOCK_R, BLOCK_R) * CG).to(tl.float32)[:, None]
                cnt = tl.where(tm, cnt, 1.0)
                m2 = tl.load(PART + base[:, None] + G + gi[None, :], mask=tm, other=0.0)
                acc2 += m2 + s * tl.div_rn(s, cnt)
        s1 = tl.sum(acc, axis=0)
        if SUMS:
            tl.store(OUT + n * 2 * G + gi, s1)
            tl.store(OUT + n * 2 * G + G + gi, tl.sum(acc2, axis=0))
        else:
            mean = tl.div_rn(s1, tl.zeros_like(s1) + total)
            for t0 in range(0, n_tiles, BLOCK_T):
                t = t0 + tl.arange(0, BLOCK_T)
                tm = (t < n_tiles)[:, None] & (gi[None, :] < G)
                cnt = (tl.minimum(HW - (t % TPP) * BLOCK_R, BLOCK_R) * CG).to(tl.float32)[:, None]
                cnt = tl.where(tm, cnt, 1.0)
                base = (n * n_tiles + t) * 2 * G
                s = tl.load(PART + base[:, None] + gi[None, :], mask=tm, other=0.0)
                m2 = tl.load(PART + base[:, None] + G + gi[None, :], mask=tm, other=0.0)
                dm = tl.div_rn(s, cnt) - mean[None, :]
                acc2 += tl.where(tm, m2 + cnt * dm * dm, 0.0)
            var = tl.div_rn(tl.sum(acc2, axis=0), tl.zeros_like(s1) + total)
            rstd = tl.div_rn(tl.zeros_like(s1) + 1.0, tl.sqrt_rn(var + eps))
            tl.store(OUT + n * 2 * G + gi, mean)
            tl.store(OUT + n * 2 * G + G + gi, rstd)

    @triton.jit  # a module global too
    def _normalized(X, CB, ST, SC, SH, n, t, g0, HW, TPP, s_n, s_ph, s_pix, s_c,
                    G: tl.constexpr, CG: tl.constexpr, CGP: tl.constexpr, GB: tl.constexpr,
                    BLOCK_R: tl.constexpr, NCHW: tl.constexpr):
        # relu(((v - mean) * rstd) * scale + shift) of _tile's block, in X's dtype
        v, m, base, offs, pix, ph, ch, chm = _tile(X, CB, n, t, g0, HW, TPP, s_n, s_ph, s_pix,
                                                   s_c, CG, CGP, GB, BLOCK_R, NCHW)
        gi = tl.arange(0, GB)
        mean = tl.load(ST + n * 2 * G + g0 + gi)
        rstd = tl.load(ST + n * 2 * G + G + g0 + gi)
        sc = tl.load(SC + ch, mask=chm, other=0.0)
        sh = tl.load(SH + ch, mask=chm, other=0.0)
        y = (v - mean[None, :, None]) * rstd[None, :, None]
        y = y * sc[None, :, :] + sh[None, :, :]
        return tl.maximum(y, 0.0).to(X.dtype.element_ty), m, base, offs, ch, chm

    @triton.jit
    def _hgn_apply(X, CB, ST, SC, SH, PK, PB, Y, HW, TPP, P, s_n, s_ph, s_pix, s_c,
                   G: tl.constexpr, CG: tl.constexpr, CGP: tl.constexpr, GB: tl.constexpr,
                   BLOCK_R: tl.constexpr, NCHW: tl.constexpr, FOLD: tl.constexpr):
        # grid (tiles, G / GB, N), Y in X's strides; with FOLD, grid (tiles,
        # 1, N), each program all G groups of its tile, Y [N, HW, P] (the
        # pred conv's output)
        t = tl.program_id(0)
        n = tl.program_id(2)
        if FOLD:
            # the products summed over the groups elementwise, then over
            # each pixel's channels once
            acc = tl.zeros([BLOCK_R, GB, CGP], dtype=tl.float32)
            for g0 in range(0, G, GB):
                y, m, _, _, ch, chm = _normalized(X, CB, ST, SC, SH, n, t, g0, HW, TPP, s_n,
                                                  s_ph, s_pix, s_c, G, CG, CGP, GB, BLOCK_R,
                                                  NCHW)
                pk = tl.load(PK + ch, mask=chm, other=0.0).to(tl.float32)
                acc += tl.where(m, y.to(tl.float32) * pk[None, :, :], 0.0)
            z = tl.sum(tl.sum(acc, axis=2), axis=1)
            ph = t // TPP
            pix = (t - ph * TPP) * BLOCK_R + tl.arange(0, BLOCK_R)
            pb = tl.load(PB).to(tl.float32)
            z = (z.to(X.dtype.element_ty).to(tl.float32) + pb).to(Y.dtype.element_ty)
            tl.store(Y + n.to(tl.int64) * HW * P + pix * P + ph, z, mask=pix < HW)
        else:
            y, m, base, offs, _, _ = _normalized(X, CB, ST, SC, SH, n, t, tl.program_id(1) * GB,
                                                 HW, TPP, s_n, s_ph, s_pix, s_c, G, CG, CGP,
                                                 GB, BLOCK_R, NCHW)
            tl.store(Y + base + offs, y, mask=m)

    _KERNELS = (triton, _hgn_stats, _hgn_merge, _hgn_apply)
    return _KERNELS


def _nchw(x: torch.Tensor) -> bool:
    """Whether x [N, H, W, C] lies in NCHW order (and not NHWC)."""
    return not x.is_contiguous() and x.permute(0, 3, 1, 2).is_contiguous()


def tile_plan(x: torch.Tensor, c: int, num_groups: int, fold: bool = False):
    """(pixels a tile, groups a program) for x [N, H, W, P*C]: the
    statistics' tiles (the kernel's and the plain version's) and the
    normalising pass's. In NHWC order (each pixel's channels lie
    together) all groups of TILE_ELEMS / C pixels, 32 at C 256; in NCHW
    order (each channel's pixels lie together) one group of TILE_ELEMS /
    (C/G) pixels, 256 at C 256, a channel's 512 bytes in bf16, a program
    for each group; with the pred fold, whose dot needs every group of a
    pixel, one program loops over them in tiles of 64 pixels."""
    if not _nchw(x):
        return max(1, TILE_ELEMS // _pow2_at_least(c)), num_groups
    if fold:
        return FOLD_PIXELS, 1
    return max(1, TILE_ELEMS // _pow2_at_least(c // num_groups)), 1


# ---------------------------------------------------------------- plain

def _biased(x: torch.Tensor, conv_bias: torch.Tensor) -> torch.Tensor:
    """fp32 values of x + conv_bias, the sum rounded to x's dtype."""
    return (x + conv_bias.to(x.dtype)).float()


def _tile_partials(v: torch.Tensor, g: int, rows: int):
    """Per tile of ``rows`` pixels of one phase of v [N, P, HW, C] fp32,
    tiles in the kernel's order: (sum, M2 about the tile's mean)
    [N, P*T, G] and each tile's element count [P*T]. A tile's group is
    summed as one contiguous run (a tree, as the kernel's reductions
    are), whatever v's memory order."""
    n, p, hw, c = v.shape
    t = -(-hw // rows)
    vp = F.pad(v, (0, 0, 0, t * rows - hw)).reshape(n, p, t, rows, g, c // g)
    vp = vp.transpose(3, 4).reshape(n, p, t, g, rows * (c // g))
    valid = (torch.arange(t * rows, device=v.device) < hw).reshape(t, rows)
    cnt = (valid.sum(dim=1) * (c // g)).float()
    valid = valid.repeat_interleave(c // g, dim=1).reshape(1, 1, t, 1, rows * (c // g))
    s = vp.sum(dim=-1)
    d = torch.where(valid, vp - (s / cnt[:, None])[..., None], 0.0)
    m2 = d.square().sum(dim=-1)
    return s.reshape(n, p * t, g), m2.reshape(n, p * t, g), cnt.repeat(p)


def group_stats_plain(x: torch.Tensor, conv_bias: torch.Tensor, num_groups: int,
                      eps: float = 1e-5, sums: bool = False) -> torch.Tensor:
    """The statistics pass and its merge in plain PyTorch: [N, 2, G] fp32
    of x + conv_bias, x [N, H, W, P*C] (P phases of the C channels of
    ``conv_bias``, in groups of C/G), (mean, rstd) or, with ``sums``,
    (sum, sum of squares), from the tiles' partials merged as the kernel
    merges them."""
    n, h, w, pc = x.shape
    c = conv_bias.shape[0]
    v = _biased(x, conv_bias.repeat(pc // c)).reshape(n, h * w, pc // c, c).transpose(1, 2)
    s, m2, cnt = _tile_partials(v, num_groups, tile_plan(x, c, num_groups)[0])
    if sums:
        return torch.stack((s.sum(dim=1), (m2 + s * (s / cnt[:, None])).sum(dim=1)), 1)
    total = float(h * w * pc // num_groups)
    mean = s.sum(dim=1) / total
    dm = s / cnt[:, None] - mean[:, None]
    var = (m2 + cnt[:, None] * dm * dm).sum(dim=1) / total
    return torch.stack((mean, torch.reciprocal(torch.sqrt(var + eps))), 1)


def _normalize_relu(v, mean, rstd, scale, shift, g: int, dtype) -> torch.Tensor:
    n, r, c = v.shape
    vg = v.reshape(n, r, g, c // g)
    y = (vg - mean[:, None, :, None]) * rstd[:, None, :, None]
    y = y.reshape(n, r, c) * scale.float() + shift.float()
    return F.relu(y).to(dtype)


def group_norm_relu_plain(x, conv_bias, scale, shift, num_groups: int, eps: float = 1e-5):
    """The kernels' arithmetic in plain PyTorch: relu(GroupNorm(x +
    conv_bias)) of x [N, H, W, C], in x's dtype."""
    n, h, w, c = x.shape
    mean, rstd = group_stats_plain(x, conv_bias, num_groups, eps).unbind(1)
    v = _biased(x, conv_bias).reshape(n, h * w, c)
    y = _normalize_relu(v, mean, rstd, scale, shift, num_groups, x.dtype)
    return y.reshape(x.shape)


def group_norm_phase_plain(ph, strips, conv_bias, scale, shift, num_groups: int,
                           pred_kernel, pred_bias, eps: float = 1e-5):
    """The kernels' arithmetic in plain PyTorch at the subpixel stage 3:
    ``fused_group_norm_phase``'s (z [N, h, w, 4], mean, rstd)."""
    n, h, w, c4 = ph.shape
    c = c4 // 4
    s1, s2 = group_stats_plain(ph, conv_bias, num_groups, eps, sums=True).unbind(1)
    mean, rstd = gn_phase_moments(s1, s2, ph, strips, num_groups, c, eps,
                                  ph_bias=conv_bias.repeat(4).to(ph.dtype))
    v = _biased(ph, conv_bias.repeat(4)).reshape(n, h * w * 4, c)
    y = _normalize_relu(v, mean, rstd, scale, shift, num_groups, ph.dtype)
    z = (y.float() @ pred_kernel.reshape(c).to(ph.dtype).float()).to(ph.dtype)
    return (z + pred_bias.to(ph.dtype)).reshape(n, h, w, 4), mean, rstd


# --------------------------------------------------------------- kernels

def _check(x, conv_bias, scale, shift, num_groups: int, c: int) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"fused_group_norm: x must be bfloat16 or float32, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"fused_group_norm: x must be [N, H, W, C], not {tuple(x.shape)}")
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"fused_group_norm: {c} channels in {num_groups} groups")
    for name, p in (("conv_bias", conv_bias), ("scale", scale), ("shift", shift)):
        if p.shape != (c,) or p.device != x.device:
            raise ValueError(f"fused_group_norm: {name} must be [{c}] on x's device")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, conv_bias, scale, shift)):
        raise ValueError("fused_group_norm: records no gradient; a tensor requires one")


def _layout(x: torch.Tensor, c: int):
    """(phases, HW, strides in elements of a sample, a phase, a pixel and
    a channel) of x [N, H, W, P*C], laid out NHWC or NCHW (a conv output
    on the card may be either); raises for any other layout."""
    n, h, w, pc = x.shape
    if not (x.is_contiguous() or x.permute(0, 3, 1, 2).is_contiguous()):
        raise ValueError("fused_group_norm: x must be dense in NHWC or NCHW order, "
                         f"not strides {x.stride()}")
    sn, sh, sw, sc = x.stride()
    return pc // c, h * w, sn, c * sc, sw if w > 1 else sh, sc


def group_stats(x: torch.Tensor, conv_bias: torch.Tensor, num_groups: int,
                eps: float = 1e-5, sums: bool = False) -> torch.Tensor:
    """The statistics pass and its merge on the card: ``group_stats_plain``
    of x [N, H, W, P*C]. Counts no launch (a stage call does)."""
    triton, stats, merge, _ = _hgn_kernels()
    c = conv_bias.shape[0]
    p, hw, *strides = _layout(x, c)
    n, g, cg = x.shape[0], num_groups, c // num_groups
    rows, gb = tile_plan(x, c, g)
    tpp = triton.cdiv(hw, rows)
    part = torch.empty((n, p * tpp, 2, g), device=x.device, dtype=torch.float32)
    out = torch.empty((n, 2, g), device=x.device, dtype=torch.float32)
    stats[(p * tpp, g // gb, n)](x, conv_bias.to(x.dtype).contiguous(), part, hw, tpp, *strides,
                        G=g, CG=cg, CGP=_pow2_at_least(cg), GB=gb, BLOCK_R=rows,
                        NCHW=_nchw(x), num_warps=8)
    merge[(n,)](part, out, hw, tpp, p * tpp, eps, G=g, CG=cg, BLOCK_R=rows,
                BLOCK_T=MERGE_TILES, SUMS=sums, num_warps=4)
    return out


def _apply(x, conv_bias, st, scale, shift, y, num_groups: int, pred=None) -> None:
    triton, _, _, apply = _hgn_kernels()
    c = conv_bias.shape[0]
    p, hw, *strides = _layout(x, c)
    g, cg = num_groups, c // num_groups
    rows, gb = tile_plan(x, c, g, fold=pred is not None)
    tpp = triton.cdiv(hw, rows)
    pk, pb = pred if pred is not None else (x, x)
    apply[(p * tpp, 1 if pred is not None else g // gb, x.shape[0])](
        x, conv_bias.to(x.dtype).contiguous(), st, scale.float().contiguous(),
        shift.float().contiguous(), pk, pb, y, hw, tpp, p, *strides, G=g, CG=cg,
        CGP=_pow2_at_least(cg), GB=gb, BLOCK_R=rows, NCHW=_nchw(x), FOLD=pred is not None,
        num_warps=4 if pred is not None else 8, enable_fp_fusion=False)


def fused_group_norm(x: torch.Tensor, conv_bias: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """relu(GroupNorm(x + conv_bias)) of x [N, H, W, C] (a conv output
    without its bias), statistics per (sample, group of C/G channels),
    in x's dtype: the kernels on a CUDA tensor, the plain version on a
    CPU tensor."""
    c = x.shape[-1]
    _check(x, conv_bias, scale, shift, num_groups, c)
    if x.device.type == "cpu":
        return group_norm_relu_plain(x, conv_bias, scale, shift, num_groups, eps)
    st = group_stats(x, conv_bias, num_groups, eps)
    y = torch.empty_like(x)  # x's strides: NHWC or NCHW order
    _apply(x, conv_bias, st, scale, shift, y, num_groups)
    fused_group_norm.launches += 1
    return y


def fused_group_norm_phase(ph: torch.Tensor, strips, conv_bias: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor, num_groups: int,
                           pred_kernel: torch.Tensor, pred_bias: torch.Tensor,
                           eps: float = 1e-5):
    """The subpixel head's stage 3 after its conv: GroupNorm + ReLU + the
    1x1 pred conv on the flat phase tensor ph [N, h, w, 4*C] (made
    without the conv bias, ``phase_conv2x_core(x, w, None)``), the
    statistics ring-corrected from ``strips`` (``ring_strips``, with the
    bias). ``pred_kernel`` [C] (or [C, 1]) in ph's dtype, ``pred_bias``
    [1]. Returns (z [N, h, w, 4] in ph's dtype, phases ordered (p, q);
    mean; rstd [N, G] fp32): the kernels on a CUDA tensor, the plain
    version on a CPU tensor."""
    n, h, w, c4 = ph.shape
    c = conv_bias.shape[0]
    if c4 != 4 * c:
        raise ValueError(f"fused_group_norm_phase: ph must be [N, h, w, {4 * c}]")
    _check(ph, conv_bias, scale, shift, num_groups, c)
    if pred_kernel.numel() != c or pred_kernel.dtype != ph.dtype or pred_bias.numel() != 1:
        raise ValueError(f"fused_group_norm_phase: pred_kernel must be [{c}] in {ph.dtype}, "
                         "pred_bias [1]")
    if ph.device.type == "cpu":
        return group_norm_phase_plain(ph, strips, conv_bias, scale, shift, num_groups,
                                      pred_kernel, pred_bias, eps)
    sums = group_stats(ph, conv_bias, num_groups, eps, sums=True)
    mean, rstd = gn_phase_moments(sums[:, 0], sums[:, 1], ph, strips, num_groups, c, eps,
                                  ph_bias=conv_bias.repeat(4).to(ph.dtype))
    z = torch.empty((n, h, w, 4), device=ph.device, dtype=ph.dtype)
    _apply(ph, conv_bias, torch.stack((mean, rstd), 1), scale, shift, z, num_groups,
           pred=(pred_kernel.reshape(c).contiguous(), pred_bias.to(ph.dtype).contiguous()))
    fused_group_norm.launches += 1
    return z, mean, rstd


fused_group_norm.launches = 0
