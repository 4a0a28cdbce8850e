"""Normalization ops on tensors, NHWC layouts (counterpart of
``countr_tpu/ops/norms.py``).

Statistics are fp32 whatever the input dtype (float64 for a float64
input), normalised with ``1 / sqrt(var + eps)``, and the result is cast
back to the input dtype.
"""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mean).square().mean(dim=dims, keepdim=True)
    return (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last dim. x: [..., C]; scale/bias: [C]."""
    y = _normalize(x, -1, eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm on NHWC input: statistics per (sample, group) over
    (H, W, C/G), as torch.nn.GroupNorm on the NCHW equivalent."""
    n, h, w, c = x.shape
    xg = x.reshape(n, h, w, num_groups, c // num_groups)
    y = _normalize(xg, (1, 2, 4), eps).reshape(n, h, w, c)
    return (y * scale.float() + bias.float()).to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm (affine=False) on NHWC input: per (sample, channel)
    statistics over (H, W)."""
    return _normalize(x, (1, 2), eps).to(x.dtype)
