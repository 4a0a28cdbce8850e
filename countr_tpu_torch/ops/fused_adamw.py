"""The AdamW update of a ``TrainState`` as one Triton kernel launch over
every trainable parameter.

Replaces no Pallas kernel: the JAX package leaves optax's AdamW to XLA,
which fuses each leaf's update into loops of its own. It replaces torch's
capturable ``foreach`` AdamW, whose division of each tensor by a 0-d
tensor leaves foreach's fast route (one broadcast kernel per parameter),
and whose other passes write every moment and a temporary for sqrt(v)
back to device memory in between.

What bounds it on the H100: memory. Per parameter it reads the gradient,
the parameter and both moments (16 bytes) and writes the parameter and
both moments (12 bytes), 28 bytes for ~15 fp32 operations: at mae_base's
111,654,912 trainable parameters 3.126 GB, 0.933 ms at 3.35 TB/s.

What the design does about that: one pass, everything between the loads
and the stores in registers, no temporary. The gradient and both moments
are flat fp32 buffers (``AdamWSegments``: each parameter at an offset
rounded up to 32 elements, so every segment starts on a 128-byte line);
the parameters stay where they are, reached through a table of chunks
built once: for each chunk of up to BLOCK elements of a parameter, its
distance from the first parameter's address, its offset in the flat
buffers and its length. A persistent grid of a few programs per SM
strides over the table; a whole chunk moves in 16-byte vectors, a
parameter's ragged last chunk is masked. The step count and the learning
rate are device scalars that the kernel reads, so a CUDA graph holds the
launch as it is and replays it at every update.

Per element, in fp32, torch's single-tensor AdamW in its order of
operations: p *= 1 - lr * wd (``weight_decay`` below the flat offset
``decay_end``, 0 from there); m = lerp(m, g, 1 - beta1); v = beta2 * v +
(1 - beta2) * g^2; p -= lr / (1 - beta1^t) * m / (sqrt(v) / sqrt(1 -
beta2^t) + eps), t the step count after this update's increment.

``fused_adamw`` launches the kernel on CUDA buffers and runs
``adamw_plain`` (the same arithmetic in PyTorch, over the same layout) on
CPU buffers. ``fused_adamw.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

BLOCK = 4096  # elements a chunk
WARPS = 8
PROGRAMS_PER_SM = 4
FLAT_ALIGN = 32  # elements: each segment's offset in the flat buffers

_KERNEL = None


def _adamw_kernel():
    """Build (once) and return the Triton kernel. ``triton`` is imported
    here, at first launch, so that this module imports without it."""
    global _KERNEL, tl, libdevice
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    try:
        from triton.language.extra import libdevice
    except ImportError:
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def _update(P, G, M, V, mask, scale, step_size, bc2_sqrt, beta1c, beta2, beta2c, eps,
                BLOCK: tl.constexpr):
        cols = tl.arange(0, BLOCK)
        g = tl.load(G + cols, mask=mask, other=0.0)
        p = tl.load(P + cols, mask=mask, other=0.0)
        m = tl.load(M + cols, mask=mask, other=0.0)
        v = tl.load(V + cols, mask=mask, other=0.0)
        p = p * scale
        m = m + beta1c * (g - m)
        v = v * beta2 + beta2c * (g * g)
        denom = tl.div_rn(tl.sqrt_rn(v), bc2_sqrt) + eps
        p = p - step_size * tl.div_rn(m, denom)
        tl.store(P + cols, p, mask=mask)
        tl.store(M + cols, m, mask=mask)
        tl.store(V + cols, v, mask=mask)

    @triton.jit
    def _adamw(BASE, TABLE, G, M, V, STEP, LR, n_chunks, decay_end, weight_decay,
               beta1, beta2, beta1c, beta2c, eps, BLOCK: tl.constexpr, ALIGN: tl.constexpr):
        t = tl.load(STEP)
        lr = tl.load(LR)
        step_size = tl.div_rn(lr, 1.0 - libdevice.pow(beta1, t))
        bc2_sqrt = tl.sqrt_rn(1.0 - libdevice.pow(beta2, t))
        cols = tl.arange(0, BLOCK)
        for c in range(tl.program_id(0), n_chunks, tl.num_programs(0)):
            # offsets in units of ALIGN elements: a multiple of 4 is 16 bytes
            prel = tl.load(TABLE + 3 * c) * ALIGN
            off = tl.load(TABLE + 3 * c + 1) * ALIGN
            n = tl.load(TABLE + 3 * c + 2)
            scale = 1.0 - lr * tl.where(off < decay_end, weight_decay, 0.0)
            if n == BLOCK:
                _update(BASE + prel, G + off, M + off, V + off, cols < BLOCK, scale, step_size,
                        bc2_sqrt, beta1c, beta2, beta2c, eps, BLOCK)
            else:
                _update(BASE + prel, G + off, M + off, V + off, cols < n, scale, step_size,
                        bc2_sqrt, beta1c, beta2, beta2c, eps, BLOCK)

    _KERNEL = (triton, _adamw)
    return _KERNEL


class AdamWSegments:
    """Where each parameter's gradient and moments lie in the flat fp32
    buffers: ``offsets[i]`` for ``params[i]``, each rounded up to
    FLAT_ALIGN elements, ``length`` in all; the first ``decay_count``
    parameters take weight decay (``decay_end``: the flat offset where the
    others start). On a CUDA device also the kernel's chunk table, built
    here from the parameters' addresses: the parameters must stay where
    they are (an in-place copy, ``load_state_dict`` or a checkpoint
    restore, keeps them there)."""

    def __init__(self, params, decay_count: int):
        self.params = list(params)
        if not self.params:
            raise ValueError("AdamWSegments: no parameters")
        self.device = self.params[0].device
        for p in self.params:
            if p.dtype != torch.float32 or not p.is_contiguous() or p.device != self.device:
                raise ValueError("AdamWSegments: the parameters must be contiguous float32 "
                                 f"tensors on one device; got {p.dtype} {tuple(p.shape)} on "
                                 f"{p.device}")
        self.offsets, off = [], 0
        for p in self.params:
            self.offsets.append(off)
            off += -(-p.numel() // FLAT_ALIGN) * FLAT_ALIGN
        self.length = off
        self.decay_end = self.offsets[decay_count] if decay_count < len(self.params) else off
        self.table = self.align = None
        if self.device.type == "cuda":
            self.table, self.align = self._chunk_table()

    def views(self, flat: torch.Tensor) -> list:
        """Each parameter's segment of ``flat``, in the parameter's shape."""
        return [flat[o:o + p.numel()].view(p.shape) for p, o in zip(self.params, self.offsets)]

    def _chunk_table(self):
        """[chunks, 3] int64: each chunk's distance from the first
        parameter's address and its offset in the flat buffers, both in
        units of ``align`` elements (4 where every parameter starts on 16
        bytes, so that whole chunks move in 16-byte vectors; else 1), and
        its length. Also returns ``align``."""
        base = self.params[0].data_ptr()
        align = 4 if all(p.data_ptr() % 16 == 0 for p in self.params) else 1
        rows = []
        for p, o in zip(self.params, self.offsets):
            rel, n = (p.data_ptr() - base) // 4, p.numel()
            rows += [((rel + s) // align, (o + s) // align, min(BLOCK, n - s))
                     for s in range(0, n, BLOCK)]
        return torch.tensor(rows, dtype=torch.int64).to(self.device), align


@torch.no_grad()
def adamw_plain(seg: AdamWSegments, grads, exp_avg, exp_avg_sq, step, lr, *, beta1: float,
                beta2: float, eps: float, weight_decay: float) -> None:
    """The kernel's update in plain PyTorch over the same flat buffers and
    segments (``step``, a 0-d tensor, already counts this update; ``lr`` a
    float or a 0-d tensor). No host synchronisation: it can be captured."""
    step_size = lr / (1 - torch.pow(beta1, step))
    bc2_sqrt = torch.sqrt(1 - torch.pow(beta2, step))
    exp_avg.lerp_(grads, 1 - beta1)
    exp_avg_sq.mul_(beta2).addcmul_(grads, grads, value=1 - beta2)
    update = exp_avg / (exp_avg_sq.sqrt() / bc2_sqrt).add_(eps)
    for p, o in zip(seg.params, seg.offsets):
        flat = p.view(-1)
        if o < seg.decay_end:
            flat.mul_(1 - lr * weight_decay)
        flat.sub_(step_size * update[o:o + p.numel()])


def _check(seg: AdamWSegments, grads, exp_avg, exp_avg_sq, step, lr) -> None:
    for name, t in (("grads", grads), ("exp_avg", exp_avg), ("exp_avg_sq", exp_avg_sq)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous() \
                or t.numel() != seg.length or t.device != seg.device:
            raise ValueError(f"fused_adamw: {name} must be a contiguous float32 [{seg.length}] "
                             f"tensor on {seg.device}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    scalars = (("step", step), ("lr", lr)) if seg.device.type == "cuda" else (("step", step),)
    for name, t in scalars:
        if not torch.is_tensor(t) or t.dim() != 0 or t.dtype != torch.float32 \
                or t.device != seg.device:
            raise ValueError(f"fused_adamw: {name} must be a 0-d float32 tensor on "
                             f"{seg.device}")


@torch.no_grad()
def fused_adamw(seg: AdamWSegments, grads, exp_avg, exp_avg_sq, step, lr, *, beta1: float,
                beta2: float, eps: float, weight_decay: float) -> None:
    """One AdamW update of ``seg.params`` in place, from the flat
    gradient ``grads`` and moments ``exp_avg`` / ``exp_avg_sq`` (laid out
    by ``seg``; the moments are updated in place). ``step`` is the 0-d
    step count, already counting this update; ``lr`` the learning rate, a
    0-d tensor on the card (a float too on the CPU). The kernel on a CUDA
    device, ``adamw_plain`` on the CPU; anything else raises."""
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_adamw: unsupported device {seg.device}")
    _check(seg, grads, exp_avg, exp_avg_sq, step, lr)
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if seg.device.type == "cpu":
        adamw_plain(seg, grads, exp_avg, exp_avg_sq, step, lr, **hyper)
        return
    triton, kernel = _adamw_kernel()
    n_chunks = seg.table.shape[0]
    sms = torch.cuda.get_device_properties(seg.device).multi_processor_count
    grid = (min(n_chunks, PROGRAMS_PER_SM * sms),)
    kernel[grid](seg.params[0], seg.table, grads, exp_avg, exp_avg_sq, step, lr, n_chunks,
                 seg.decay_end, weight_decay, beta1, beta2, 1 - beta1, 1 - beta2, eps,
                 BLOCK=BLOCK, ALIGN=seg.align, num_warps=WARPS)
    fused_adamw.launches += 1


fused_adamw.launches = 0
