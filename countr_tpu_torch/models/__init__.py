"""Model registry (counterpart of ``countr_tpu/models/__init__.py``)."""

from __future__ import annotations

import dataclasses

import torch

from countr_tpu_torch import disable_tf32, resolve_device
from countr_tpu_torch.config import COUNTR_PRESETS, MAE_PRESETS, pretrain_overrides
from countr_tpu_torch.models.countr import CounTR
from countr_tpu_torch.models.init import init_countr_, init_mae_
from countr_tpu_torch.models.mae import MaskedAutoencoderViT


def build_countr(
    name: str = "mae_vit_base6_patch16", *, device=None, seed: int = 0,
    training: bool = False, **overrides,
) -> CounTR:
    """Build a preset (with config overrides), initialised at random from
    ``torch.Generator().manual_seed(seed)``, on ``device`` (None = the
    CUDA card; raises when there is none), in eval mode, or in train mode
    with ``training``. The training build's overrides, which keep the
    forward-only fused half-block B2 off, are
    ``config.fast_mode_overrides(dtype, training=True)``."""
    dev = resolve_device(device)
    cfg = COUNTR_PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.computes_fp32:
        disable_tf32()
    model = CounTR(cfg)
    init_countr_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).train(training)


def build_mae(
    name: str = "mae_vit_base_patch16", *, dtype: str = "bf16",
    fused_attn_block: bool = False, device=None, seed: int = 0, masked_loss: bool = False,
    **overrides,
) -> MaskedAutoencoderViT:
    """Build an MAE preset in the ``dtype`` mode of the pretrain CLI
    (``config.pretrain_overrides``: in bf16 the kernels B1 and B3/B4, tanh
    GELU, B2 off), or with ``fused_attn_block=True`` the config's own
    default (B2 on, its backward through B3/B4); further config
    ``overrides`` on top; ``masked_loss`` as in ``MaskedAutoencoderViT``.
    Initialised at random from
    ``torch.Generator().manual_seed(seed)``, on ``device`` (None = the
    CUDA card; raises when there is none), in train mode."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        MAE_PRESETS[name], **{**pretrain_overrides(dtype, fused_attn_block), **overrides})
    if cfg.dtype == torch.float32:
        disable_tf32()
    model = MaskedAutoencoderViT(cfg, masked_loss=masked_loss)
    init_mae_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).train()


__all__ = ["CounTR", "MaskedAutoencoderViT", "build_countr", "build_mae"]
