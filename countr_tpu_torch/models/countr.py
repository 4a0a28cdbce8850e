"""CounTR counting model (counterpart of ``countr_tpu/models/countr.py``):
frozen ViT encoder + exemplar CNN + cross-attention interaction decoder +
density regression head (reference: models_mae_cross.py:18-207).

The module tree has the reference SupervisedMAE state_dict layout
(``blocks.{i}``, ``decoder_proj{k}.0``, ``decoder_blocks.{i}``,
``decode_head{k}.{0,1,3}``, ``pos_embed`` ...), so a released ``.pth``
loads with ``load_state_dict(strict=True)``. Public functions take and
return NHWC tensors, as the JAX package does.

forward contract:
  imgs  [B, 384, 384, 3] float in [0,1]
  boxes [B, 3, 64, 64, 3] exemplar crops (slots beyond shot_num ignored)
  -> density [B, 384, 384] fp32, count = density.sum()/60
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from countr_tpu_torch.config import CounTRConfig
from countr_tpu_torch.models.vit import (
    Block, LayerNorm, Mlp, SelfAttention, PatchEmbed, dense,
    fused_attn_branch, use_fused_branch,
)
from countr_tpu_torch.ops.attention import cross_attention_smallk, multi_head_attention
from countr_tpu_torch.ops.conv import conv2d_nhwc
from countr_tpu_torch.ops.fused_gn import DTYPES as HGN_DTYPES
from countr_tpu_torch.ops.fused_gn import fused_group_norm, fused_group_norm_phase
from countr_tpu_torch.ops.norms import group_norm, instance_norm
from countr_tpu_torch.ops.posembed import get_2d_sincos_pos_embed
from countr_tpu_torch.ops.subpixel import (
    gn_phase_apply, gn_phase_stats, phase_conv2x_core, pred_phase_flat,
    ring_strips, scatter_ring, upsample2x_phase,
)
from countr_tpu_torch.ops.upsample import upsample2x_bilinear


class CrossAttention(nn.Module):
    """Separate wq/wk/wv cross-attention: image tokens query exemplar
    tokens (reference: models_crossvit.py:96-128)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.wq = nn.Linear(dim, dim)
        self.wk = nn.Linear(dim, dim)
        self.wv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        q = dense(x, self.wq, self.dtype)
        k = dense(y, self.wk, self.dtype)
        v = dense(y, self.wv, self.dtype)
        if y.shape[1] <= 8:
            out = cross_attention_smallk(q, k, v, self.num_heads)
        else:
            out = multi_head_attention(q, k, v, self.num_heads)
        return dense(out, self.proj, self.dtype)


class CrossAttentionBlock(nn.Module):
    """self-attn -> cross-attn -> MLP, each pre-norm residual; only the
    query side is normalised before cross-attention
    (reference: models_crossvit.py:130-156). The self-attention branch
    takes kernel B2, or its core B3/B4, behind the same gates as the
    encoder Block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = False, fused_block: bool = True,
                 approx_gelu: bool = False):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.fused_block = fused_block
        self.norm0 = LayerNorm(dim, ln_eps, dtype)
        self.selfattn = SelfAttention(dim, num_heads, dtype, use_kernels)
        self.norm1 = LayerNorm(dim, ln_eps, dtype)
        self.attn = CrossAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, ln_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, approx_gelu)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if use_fused_branch(self.use_kernels, self.fused_block, self.dtype, x):
            x = fused_attn_branch(x, self.norm0, self.selfattn)
        else:
            x = x + self.selfattn(self.norm0(x))
        x = x + self.attn(self.norm1(x), y)
        return x + self.mlp(self.norm2(x))


def exemplar_encoder(x: torch.Tensor, convs, dtype: torch.dtype) -> torch.Tensor:
    """4-stage CNN embedding [N, 64, 64, 3] exemplar crops to [N, C]
    tokens (reference: models_mae_cross.py:47-71): conv3x3 +
    InstanceNorm (affine-free) + ReLU, 2x2 max-pool after the first three
    stages, global average pool after the last."""
    x = x.to(dtype)
    for i, conv in enumerate(convs):
        x = F.relu(instance_norm(conv2d_nhwc(x, conv.weight, conv.bias, 1)))
        if i < 3:
            n, h, w, c = x.shape
            x = x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
        else:
            x = x.mean(dim=(1, 2))
    return x


def _head_stage(x: torch.Tensor, stage: nn.Sequential, dtype, records_grad: bool) -> torch.Tensor:
    """conv3x3 + GroupNorm(8) + ReLU of one density-head stage: with HGN
    (ops/fused_gn.py) after a bias-free conv where no gradient is recorded
    and the dtype is one it takes; else the ATen chain."""
    conv, gn = stage[0], stage[1]
    hgn = not records_grad and dtype in HGN_DTYPES
    x = conv2d_nhwc(x.to(dtype), conv.weight, None if hgn else conv.bias, 1)
    if hgn:
        return fused_group_norm(x, conv.bias, gn.weight, gn.bias, gn.num_groups, gn.eps)
    return F.relu(group_norm(x, gn.weight, gn.bias, gn.num_groups, gn.eps))


def density_head(x: torch.Tensor, stages, dtypes, subpixel: bool) -> torch.Tensor:
    """Token grid [B, 24, 24, C] -> density [B, 384, 384]: 4x {conv3x3 +
    GroupNorm(8) + ReLU + bilinear 2x}, the 1x1 pred conv upsampled last
    (reference: models_mae_cross.py:80-100, :184-198). ``stages`` are the
    four ``decode_head{k}`` Sequentials (conv, GN, ReLU[, pred]);
    ``dtypes`` the compute dtype of stage0..3 and of the pred conv with
    the final upsample (``CounTRConfig.head_dtypes``).

    ``subpixel`` fuses the last 2x upsample into conv3 as a phase-space
    conv and keeps GN/ReLU/pred/final upsample in phase layout
    (ops/subpixel.py); numerically equivalent to the reference form. It
    runs in one dtype, ``dtypes[0]``.

    Where no gradient is recorded (grad mode off, or no input requiring
    one), each stage's bias + GroupNorm + ReLU, and at the subpixel stage 3
    the pred conv too, run as HGN's two passes (ops/fused_gn.py); a
    training step keeps the ATen chain, which autograd differentiates."""
    records_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for s in stages for p in s.parameters()))
    for idx in range(3):
        x = _head_stage(x, stages[idx], dtypes[idx], records_grad)
        if idx < 2 or not subpixel:
            x = upsample2x_bilinear(x)
    pred = stages[3][3]
    if not subpixel:
        x = _head_stage(x, stages[3], dtypes[3], records_grad)
        x = conv2d_nhwc(x.to(dtypes[4]), pred.weight, pred.bias, 0)
        return upsample2x_bilinear(x)[..., 0]

    dtype = dtypes[0]
    n, h, w, _ = x.shape
    conv3, gn3 = stages[3][0], stages[3][1]
    width = conv3.weight.shape[0]
    pk = pred.weight.reshape(1, width).t()  # [width, 1]
    xd = x.to(dtype)
    hgn = not records_grad and dtype in HGN_DTYPES
    ph = phase_conv2x_core(xd, conv3.weight, None if hgn else conv3.bias)
    strips = ring_strips(xd, conv3.weight, conv3.bias)
    if hgn:
        z4, mean, rstd = fused_group_norm_phase(ph, strips, conv3.bias, gn3.weight, gn3.bias,
                                                gn3.num_groups, pk.to(dtype), pred.bias,
                                                gn3.eps)
    else:
        mean, rstd = gn_phase_stats(ph, strips, gn3.num_groups, c_real=width)
        yb = F.relu(gn_phase_apply(ph, mean, rstd, gn3.weight, gn3.bias, c_real=width))
        z4 = pred_phase_flat(yb, pk.to(dtype), pred.bias)
    zs = [
        (F.relu(gn_phase_apply(s, mean, rstd, gn3.weight, gn3.bias, c_real=width))
         @ pk.to(dtype) + pred.bias.to(dtype))[..., 0]
        for s in strips
    ]
    z = scatter_ring(z4.reshape(n, h, w, 2, 2), *zs)
    return upsample2x_phase(z)


class CounTR(nn.Module):
    """The counting model. ``shot_num`` is a Python int (0..3)."""

    def __init__(self, cfg: CounTRConfig):
        super().__init__()
        self.cfg = cfg
        enc_dt = cfg.encoder_dtype or cfg.dtype
        dec_dt = cfg.decoder_dtype or cfg.dtype
        self.enc_dtype, self.dec_dtype = enc_dt, dec_dt
        # The fast-mode kernels and tanh GELU follow the stage dtype, as
        # in the JAX package (models/countr.py:296-304).
        bf = torch.bfloat16
        enc_k = cfg.use_pallas_attention and enc_dt == bf
        dec_k = cfg.use_pallas_attention and dec_dt == bf
        dec_fused = (cfg.fused_attn_block if cfg.fused_attn_block_decoder is None
                     else cfg.fused_attn_block_decoder)
        d, dd = cfg.embed_dim, cfg.decoder_embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, d, enc_dt)
        self.blocks = nn.ModuleList([
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.ln_eps, enc_dt,
                  use_kernels=enc_k, fused_block=cfg.fused_attn_block,
                  approx_gelu=cfg.approx_gelu and enc_dt == bf)
            for _ in range(cfg.depth)
        ])
        self.norm = LayerNorm(d, cfg.ln_eps, enc_dt)
        self.decoder_embed = nn.Linear(d, dd)
        self.shot_token = nn.Parameter(torch.zeros(dd))
        widths = (64, 128, 256, dd)
        cins = (cfg.in_chans, 64, 128, 256)
        for k in range(4):
            setattr(self, f"decoder_proj{k + 1}", nn.Sequential(
                nn.Conv2d(cins[k], widths[k], 3, padding=1)))
        self.decoder_blocks = nn.ModuleList([
            CrossAttentionBlock(dd, cfg.decoder_num_heads, cfg.mlp_ratio,
                                cfg.ln_eps, dec_dt, use_kernels=dec_k,
                                fused_block=dec_fused,
                                approx_gelu=cfg.approx_gelu and dec_dt == bf)
            for _ in range(cfg.decoder_depth)
        ])
        self.decoder_norm = LayerNorm(dd, cfg.ln_eps, dec_dt)
        hw = cfg.head_width
        for k in range(4):
            layers = [nn.Conv2d(dd if k == 0 else hw, hw, 3, padding=1),
                      nn.GroupNorm(8, hw), nn.ReLU()]
            if k == 3:
                layers.append(nn.Conv2d(hw, 1, 1))
            setattr(self, f"decode_head{k}", nn.Sequential(*layers))
        # Fixed sin-cos position embeddings, stored as the reference does
        # (reference: models_mae_cross.py:30,42,111-115).
        g = cfg.grid_size
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(d, g))[None])
        self.register_buffer("decoder_pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(dd, g))[None])

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        """ViT encoder: [B, 384, 384, 3] -> [B, 576, D]."""
        x = self.patch_embed(imgs)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def encode_exemplars(self, boxes: torch.Tensor, shot_num: int) -> torch.Tensor:
        """[B, 3, 64, 64, 3] -> [B, max(shot_num, 1), C] exemplar tokens;
        shot_num == 0 uses the learned shot token."""
        b = boxes.shape[0]
        dd = self.cfg.decoder_embed_dim
        if shot_num == 0:
            return self.shot_token.to(self.dec_dtype).expand(b, 1, dd)
        sel = boxes[:, :shot_num].to(self.dec_dtype)
        flat = sel.reshape(b * shot_num, *boxes.shape[2:])
        convs = [getattr(self, f"decoder_proj{k}")[0] for k in (1, 2, 3, 4)]
        return exemplar_encoder(flat, convs, self.dec_dtype).reshape(b, shot_num, dd)

    def decode_grid(self, latent: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Interaction decoder given exemplar tokens ``y`` [B, n_shot, C]
        -> the density head's input token grid [B, 24, 24, C]."""
        x = dense(latent, self.decoder_embed, self.dec_dtype)
        x = x + self.decoder_pos_embed.to(x.dtype)
        for blk in self.decoder_blocks:
            x = blk(x, y.to(x.dtype))
        x = self.decoder_norm(x)
        b, _, c = x.shape
        g = self.cfg.grid_size
        return x.reshape(b, g, g, c)

    def head(self, grid: torch.Tensor, dtypes=None) -> torch.Tensor:
        """The density head on a token grid -> density [B, 384, 384] fp32,
        at the config's stage dtypes, or at ``dtypes`` (5 entries)."""
        stages = [getattr(self, f"decode_head{k}") for k in range(4)]
        return density_head(grid, stages, dtypes or self.cfg.head_dtypes,
                            self.cfg.subpixel_head).float()

    def decode_tokens(self, latent: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Interaction decoder + density head given exemplar tokens
        ``y`` [B, n_shot, C] -> density [B, 384, 384] fp32."""
        return self.head(self.decode_grid(latent, y))

    def forward_tokens(self, imgs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Forward with precomputed exemplar tokens (the batched-window
        inference path). A frozen encoder runs under ``no_grad``: JAX's
        stop_gradient, and the reference's torch.no_grad encoder
        (models_mae_cross.py:204-205), so autograd keeps none of its
        activations."""
        with torch.no_grad() if self.cfg.freeze_encoder else contextlib.nullcontext():
            latent = self.encode(imgs)
        return self.decode_tokens(latent, y)

    def forward(self, imgs: torch.Tensor, boxes: torch.Tensor,
                shot_num: int = 3) -> torch.Tensor:
        return self.forward_tokens(imgs, self.encode_exemplars(boxes, shot_num))
