"""Model registry (counterpart of ``countr_tpu/models/__init__.py``)."""

from __future__ import annotations

import dataclasses

import torch

from countr_tpu_torch import disable_tf32, resolve_device
from countr_tpu_torch.config import COUNTR_PRESETS
from countr_tpu_torch.models.countr import CounTR
from countr_tpu_torch.models.init import init_countr_


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
    if cfg.dtype == torch.float32:
        disable_tf32()
    model = CounTR(cfg)
    init_countr_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).train(training)


__all__ = ["CounTR", "build_countr"]
