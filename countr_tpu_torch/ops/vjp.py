"""The backward of a kernel whose TPU counterpart differentiates its
plain formula: the VJP of the kernel's plain version, recomputed from
the inputs saved by the forward (B5 and B6; the JAX package's custom
VJPs at pallas_block.py:310-318 and :522-529 run ``jax.vjp`` over the
XLA composition the same way). B1's backward has kernels of its own
(``ops/fused_ln.py``)."""

from __future__ import annotations

import torch


def recompute_vjp(fn, saved, needs, g, *static):
    """Gradients of ``fn(*saved, *static)`` for the output cotangent
    ``g``, one per saved tensor: a tensor where ``needs`` (the Function's
    ``ctx.needs_input_grad``) asks for it, else None."""
    inputs = [t.detach().requires_grad_(bool(need)) for t, need in zip(saved, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    if not wanted:
        return tuple(None for _ in inputs)
    with torch.enable_grad():
        y = fn(*inputs, *static)
        grads = iter(torch.autograd.grad(y, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
