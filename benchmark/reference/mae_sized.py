"""The MAE pretraining reference (``reference/mae.py``) at a model's own
image size: the data path crops the 384-side stored image as
``FSC_pretrain.py`` does (RandomResizedCrop's draw in that frame) and
resizes the crop to the configuration's ``img_size`` (378 for ViT-H/14,
whose 14-px patches do not tile 384). It imports nothing of the program
under test.

- ``MAE``, ``build``, ``store_layout``, ``adamw``, ``warmup_cosine``:
  ``reference/mae.py``'s, which are generic in the patch size, the image
  size and the widths.
- ``crop``: ``reference/mae.py``'s crop (a crop of the image whose smaller
  side is 384, resized by an antialiased bicubic filter, a = -0.5, PIL's,
  in float32, flipped when asked, clamped to [0, 1]), resized to ``size``
  instead of 384."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.mae import MAE, adamw, build, store_layout, warmup_cosine  # noqa: F401


def crop(stored: np.ndarray, transposed: bool, top: int, left: int, h: int, w: int,
         flip: bool, device, size: int) -> torch.Tensor:
    """The sample [3, size, size] of a stored image (rows 384): the crop
    resized by the antialiased bicubic filter, back in the original
    orientation, flipped left-right when asked."""
    x = torch.from_numpy(np.array(stored[top:top + h, left:left + w]))
    x = x.to(device).permute(2, 0, 1).float()[None] / 255.0
    x = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=False,
                      antialias=True)[0]
    if transposed:
        x = x.transpose(1, 2)
    if flip:
        x = x.flip(2)
    return x.clamp(0.0, 1.0)
