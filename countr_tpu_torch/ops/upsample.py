"""2x bilinear upsampling with torch ``align_corners=False`` semantics, and
the general bilinear resize (counterpart of ``countr_tpu/ops/upsample.py``:
``upsample2x_bilinear``, ``resize_bilinear``).

The density head's four 2x upsamples (reference: models_mae_cross.py:
189-196) are one small contraction per spatial axis against an exact,
edge-clamped 2-tap weight matrix (entries 0.25/0.75, exact in bf16 and
fp32), on NHWC tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from countr_tpu_torch.ops import device_constant


@functools.lru_cache(maxsize=None)
def _up2x_matrix(n: int) -> np.ndarray:
    """[n, 2n] bilinear weight matrix: out = x @ W doubles the axis.

    Output sample 2i   = 0.25*x[i-1] + 0.75*x[i]   (clamped at edges)
    Output sample 2i+1 = 0.75*x[i]   + 0.25*x[i+1]
    """
    w = np.zeros((n, 2 * n), np.float32)
    for o in range(2 * n):
        i = o // 2
        if o % 2 == 0:
            taps = ((i - 1, 0.25), (i, 0.75))
        else:
            taps = ((i, 0.75), (i + 1, 0.25))
        for src, wt in taps:
            w[min(max(src, 0), n - 1), o] += wt
    return w


def up2x_matrix(n: int, like: torch.Tensor) -> torch.Tensor:
    """``_up2x_matrix(n)`` as a tensor of ``like``'s dtype and device,
    made once per (n, device, dtype)."""
    return device_constant(_up2x_matrix, (n,), like.device, like.dtype)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of NHWC input, align_corners=False exact."""
    _, h, w, _ = x.shape
    y = torch.einsum("nhwc,hH->nHwc", x, up2x_matrix(h, x))
    return torch.einsum("nHwc,wW->nHWc", y, up2x_matrix(w, x))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """General bilinear resize of NHWC input: half-pixel centers, no
    antialias (the JAX package's ``jax.image.resize(..., "bilinear",
    antialias=False)``, which equals F.interpolate's align_corners=False
    bilinear, up or down), in ``x``'s dtype."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)
