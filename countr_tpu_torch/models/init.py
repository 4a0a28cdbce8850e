"""Weight initialisers matching the reference's init scheme (counterpart
of ``countr_tpu/models/init.py``), drawn from an explicit
``torch.Generator``.

- Linear layers: xavier-uniform weights, zero bias (reference:
  models_mae_cross.py:126-134); the patch-embed conv is xavier'd as the
  flattened [D, 3*p*p] linear map (reference: models_mae_cross.py:117-119).
- Conv layers keep torch Conv2d defaults: uniform weights and bias with
  bound 1/sqrt(fan_in) (kaiming_uniform(a=sqrt(5))).
- LayerNorm / GroupNorm: ones and zeros; CounTR's shot token and the
  MAE's mask token: normal(0.02) (reference: models_mae_noct.py:74).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)


def xavier_uniform_(weight: torch.Tensor, gen: torch.Generator) -> None:
    fan_out = weight.shape[0]
    fan_in = weight[0].numel()
    _uniform_(weight, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def _init_modules_(model: nn.Module, gen: torch.Generator) -> None:
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear) or name == "patch_embed.proj":
            xavier_uniform_(mod.weight, gen)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Conv2d):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            _uniform_(mod.weight, bound, gen)
            _uniform_(mod.bias, bound, gen)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def init_countr_(model: nn.Module, gen: torch.Generator) -> None:
    """Initialise a CounTR model's parameters in place (on the CPU)."""
    _init_modules_(model, gen)
    _normal_(model.shot_token, 0.02, gen)


def init_mae_(model: nn.Module, gen: torch.Generator) -> None:
    """Initialise an MAE model's parameters in place (on the CPU)."""
    _init_modules_(model, gen)
    _normal_(model.mask_token, 0.02, gen)
