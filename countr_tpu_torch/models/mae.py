"""MAE pre-training model, no cls token (counterpart of
``countr_tpu/models/mae.py``; reference MaskedAutoencoderViTNoCT,
models_mae_noct.py:11-204): random masking by a stable argsort of
uniform noise, the ViT encoder over the visible tokens, a light decoder
that reconstructs every patch.

The module tree has the reference state_dict layout (``patch_embed``,
``blocks.{i}``, ``norm``, ``decoder_embed``, ``mask_token``,
``decoder_blocks.{i}``, ``decoder_norm``, ``decoder_pred``, and the fixed
``pos_embed``/``decoder_pos_embed``), so a reference ``.pth`` loads with
``load_state_dict(strict=True)``. Its blocks are the port's ``Block``
behind the same gates as the JAX package's: in the bf16 fast mode B1 for
the LayerNorms, and B2 (backward through B3/B4) or B3/B4 for attention.

The reference's quirk is kept: the loss averages over ALL patches
(models_mae_noct.py:193-195); ``masked_loss`` selects the standard MAE
loss over the masked patches.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from countr_tpu_torch.config import MAEConfig
from countr_tpu_torch.models.vit import Block, LayerNorm, PatchEmbed, dense
from countr_tpu_torch.ops.posembed import get_2d_sincos_pos_embed


def patchify(imgs: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, L, p*p*C] in (ph, pw, c) pixel order
    (reference: models_mae_noct.py:82-94)."""
    b, h, w, c = imgs.shape
    gh, gw = h // p, w // p
    x = imgs.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


def unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, L, p*p*C] -> [B, H, W, C] (reference: models_mae_noct.py:96-108)."""
    b, l, d = x.shape
    g = int(l ** 0.5)
    c = d // (p * p)
    x = x.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * p, g * p, c)


def random_masking(
    x: torch.Tensor, mask_ratio: float, noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample random masking by argsort of uniform noise [B, L]
    (reference: models_mae_noct.py:110-135). ``noise`` is given, or drawn
    from ``generator`` on its device. The sorts are stable, as JAX's.

    Returns (x_masked [B, len_keep, D], mask [B, L] in x's dtype with
    1 = removed, ids_restore [B, L])."""
    b, l, d = x.shape
    len_keep = int(l * (1 - mask_ratio))
    if noise is None:
        dev = generator.device if generator is not None else x.device
        noise = torch.rand((b, l), generator=generator, device=dev)
    noise = noise.to(x.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(b, len_keep, d))
    mask = torch.ones((b, l), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


class MaskedAutoencoderViT(nn.Module):
    """The MAE model. ``forward(imgs, noise=None, generator=None)`` ->
    (loss, pred [B, L, p*p*3], mask [B, L]) at ``cfg.mask_ratio``."""

    def __init__(self, cfg: MAEConfig, masked_loss: bool = False):
        super().__init__()
        self.cfg = cfg
        self.masked_loss = masked_loss
        dt = cfg.dtype
        kernels = cfg.use_pallas_attention and dt == torch.bfloat16
        d, dd = cfg.embed_dim, cfg.decoder_embed_dim

        def blocks(dim, heads, n):
            return nn.ModuleList([
                Block(dim, heads, cfg.mlp_ratio, cfg.ln_eps, dt, use_kernels=kernels,
                      fused_block=cfg.fused_attn_block, approx_gelu=cfg.approx_gelu)
                for _ in range(n)
            ])

        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, d, dt)
        self.blocks = blocks(d, cfg.num_heads, cfg.depth)
        self.norm = LayerNorm(d, cfg.ln_eps, dt)
        self.decoder_embed = nn.Linear(d, dd)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd))
        self.decoder_blocks = blocks(dd, cfg.decoder_num_heads, cfg.decoder_depth)
        self.decoder_norm = LayerNorm(dd, cfg.ln_eps, dt)
        self.decoder_pred = nn.Linear(dd, cfg.patch_size ** 2 * cfg.in_chans)
        g = cfg.grid_size
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(d, g))[None])
        self.register_buffer("decoder_pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(dd, g))[None])

    def encode(self, imgs: torch.Tensor, mask_ratio: float, noise=None, generator=None):
        """Patchify, add the position embedding, mask, run the encoder
        (reference: models_mae_noct.py:137-152). Returns (latent, mask,
        ids_restore)."""
        x = self.patch_embed(imgs)
        x = x + self.pos_embed.to(x.dtype)
        x, mask, ids_restore = random_masking(x, mask_ratio, noise, generator)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x), mask, ids_restore

    def decode(self, x: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        """Append mask tokens, unshuffle, decode, predict pixels
        (reference: models_mae_noct.py:154-175)."""
        x = dense(x, self.decoder_embed, self.cfg.dtype)
        b, n_vis, c = x.shape
        l = ids_restore.shape[1]
        mask_tokens = self.mask_token.to(x.dtype).expand(b, l - n_vis, c)
        x = torch.cat([x, mask_tokens], dim=1)
        x = torch.gather(x, 1, ids_restore[:, :, None].expand(b, l, c))
        x = x + self.decoder_pos_embed.to(x.dtype)
        for blk in self.decoder_blocks:
            x = blk(x)
        return dense(self.decoder_norm(x), self.decoder_pred, self.cfg.dtype)

    def loss(self, imgs: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Per-patch MSE in fp32 (reference: models_mae_noct.py:177-198)."""
        target = patchify(imgs, self.cfg.patch_size).float()
        if self.cfg.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        per_patch = torch.square(pred.float() - target).mean(dim=-1)
        if self.masked_loss:
            m = mask.float()
            return (per_patch * m).sum() / m.sum()
        return per_patch.mean()

    def forward(self, imgs: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """imgs [B, H, W, 3] in [0, 1]; the masking noise [B, L] is given or
        drawn from ``generator``. Returns (loss, pred, mask)
        (reference: models_mae_noct.py:200-204)."""
        latent, mask, ids_restore = self.encode(imgs, self.cfg.mask_ratio, noise, generator)
        pred = self.decode(latent, ids_restore)
        return self.loss(imgs, pred, mask), pred, mask
