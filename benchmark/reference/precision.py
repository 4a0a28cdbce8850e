"""The precision of the plain references: float32 with TF32 off, or the
control's float8 (e4m3) operands for every matrix product and
convolution, with per-tensor scales and float32 accumulation: the step
below the bfloat16 that the configurations state, which a later change
might be tempted to take.

``operand(t)`` is what every product of a reference applies to each of
its two operands. Under autograd the rounding passes the gradient
straight through, so the control's backward sees float8 forward values."""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
_MODE = {"name": "fp32"}


def set_tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def mode(name: str):
    """Within it the references compute in ``name``: "fp32" or "fp8"."""
    if name not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {name!r}")
    prev = _MODE["name"]
    _MODE["name"] = name
    set_tf32_off()
    try:
        yield
    finally:
        _MODE["name"] = prev


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q.to(t.dtype) - t).detach()


def operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a product of the current precision reads it."""
    return _fp8(t) if _MODE["name"] == "fp8" else t
