"""The weights of a run, made on the card from the run's seed in one draw,
in the reference's parameter layout (the authors' state_dict names), held
in float32 and, for a model served in bfloat16, made in that type: every
value one that bfloat16 holds exactly, so that the program and the
reference compute with the same weights.

The scheme follows the authors' initialisation in kind, with biases and
norm affines drawn too, so that a fault on a bias or a norm's path shows
in the check: linear and patch-embedding weights xavier-uniform,
convolution weights uniform with bound 1/sqrt(fan_in), biases uniform
with bound 0.05, norm scales 1 +- 0.2, learned tokens uniform +-0.035
(about the authors' normal(0.02))."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def spec(module: nn.Module) -> Dict[str, tuple]:
    """name -> (shape, kind) of every parameter of ``module`` (a model
    built on the meta device)."""
    kinds = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                kind = "norm_" + pname
            elif pname == "bias":
                kind = "bias"
            elif isinstance(mod, nn.Conv2d) and mname.endswith("patch_embed.proj"):
                kind = "xavier"
            elif isinstance(mod, nn.Conv2d):
                kind = "conv"
            elif isinstance(mod, nn.Linear):
                kind = "xavier"
            else:
                kind = "token"
            kinds[name] = (tuple(p.shape), kind)
    return kinds


def _bound(shape, kind) -> tuple:
    """(scale, offset) of the uniform [-1, 1) draw."""
    if kind == "xavier":
        fan_out, fan_in = shape[0], math.prod(shape[1:])
        return math.sqrt(6.0 / (fan_in + fan_out)), 0.0
    if kind == "conv":
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if kind == "norm_weight":
        return 0.2, 1.0
    if kind in ("bias", "norm_bias"):
        return 0.05, 0.0
    return 0.035, 0.0


def make(specs: Dict[str, tuple], seed: int, device, served=None) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, from one uniform draw of a
    ``torch.Generator`` on that device seeded with ``seed``; with
    ``served`` (a dtype) every value rounded to that type."""
    total = sum(math.prod(shape) for shape, _ in specs.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, off = {}, 0
    for name, (shape, kind) in specs.items():
        n = math.prod(shape)
        scale, offset = _bound(shape, kind)
        out[name] = flat[off:off + n].view(shape).mul_(scale).add_(offset)
        off += n
    if served is not None:
        flat.copy_(flat.to(served))
    return out


def load_into(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``model``'s parameters by name; every parameter
    of the model has to be there and every entry has to be used."""
    params = dict(model.named_parameters())
    if set(params) != set(state):
        missing = sorted(set(state) - set(params))[:5]
        extra = sorted(set(params) - set(state))[:5]
        raise KeyError(f"parameter layouts differ: reference only {missing}, program only {extra}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, reference "
                                 f"{tuple(state[name].shape)}")
            p.copy_(state[name])
