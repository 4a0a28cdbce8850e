"""Device-side counting pipeline (counterpart of
``countr_tpu/engine/device_pipeline.py``): window extraction, stitching
and the count and TTN readout on the card.

Each image of a set is uploaded ONCE (uint8 when the source is 8-bit),
from pinned host memory; windows are cut from it on the card, their
densities are stitched on the card with the precomputed per-window
column weights, and two scalars per density row come back (the count and
the TTN statistic). Density maps move to the host only on request.

Shapes are bucketed as in the JAX package: images go in a flat pixel
pool [384, Wt, 3], windows in chunks of the batch or a graduated tail
bucket, so the window forward runs at a handful of shapes. On the card
each shape is one CUDA graph (engine/graphs.py ``GraphedForward``), the
counterpart of the JAX package's ``jax.jit`` of the forward; on the CPU
the forward runs eagerly.

The planner (``width_bucket``, ``stream_chunks``, ``chunk_plan``) is
plain Python; the device stages are plain torch ops, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from countr_tpu_torch.config import DENSITY_SCALE, WINDOW
from countr_tpu_torch.utils.profiling import span

WIDTH_BUCKETS = (384, 448, 512, 576, 640, 768, 1024, 1536, 2304, 4608)
MAP_KEYS = ("ix0", "ix1", "wx1", "iy0", "iy1", "wy1")


def width_bucket(w: int) -> int:
    for b in WIDTH_BUCKETS:
        if w <= b:
            return b
    return ((w + 511) // 512) * 512


def stream_chunks(n_plain: int, n: int, b: int, multiple: int = 1):
    """(i, j, bk) spans over the full window stream (plain windows
    [0, n_plain), then resampled [n_plain, n)): at most one chunk
    straddles the boundary, and a set pays one graduated tail."""
    for off, bk in chunk_plan(n, b, multiple):
        yield off, min(off + bk, n), bk


# The window counts a tail chunk is padded to: ``chunk_plan`` picks from
# them and ``forward_buckets`` captures a graph for each, so the two agree.
TAIL_BUCKETS = (4, 8, 16, 24)


def chunk_plan(n: int, b: int, multiple: int = 1):
    """(offset, batch_bucket) chunks covering n windows: full chunks of
    b, then ONE tail bucket from ``TAIL_BUCKETS``, rounded up to
    ``multiple`` and capped at b (b itself when none fits)."""
    out = []
    i = 0
    while i + b <= n:
        out.append((i, b))
        i += b
    tail = n - i
    if tail > 0:
        for s in TAIL_BUCKETS:
            if tail <= s and s <= b and s % max(multiple, 1) == 0:
                out.append((i, s))
                break
        else:
            out.append((i, b))
    return out


def forward_buckets(b: int, multiple: int = 1):
    """Every window count ``chunk_plan`` can give the forward at batch
    ``b``: b, and the tail buckets that fit under it (those ``multiple``
    divides, as ``chunk_plan`` picks them)."""
    return sorted({b, *(s for s in TAIL_BUCKETS if s <= b and s % multiple == 0)})


def _to_unit(win: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 / 255, after the gather (the pool stays one
    byte a pixel); float pixels -> float32."""
    if win.dtype == torch.uint8:
        return win.float() / 255.0
    return win.float()


def extract_windows(images: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Flat pixel pool [384, Wt, C] (uint8 or float) -> [B, 384, 384, C]
    float32 windows; ``starts`` [B] are absolute pool columns."""
    cols = starts.long()[:, None] + torch.arange(WINDOW, device=images.device)
    return _to_unit(images[:, cols].permute(1, 0, 2, 3)).contiguous()


def extract_windows_resampled(images, ix0, ix1, wx1, iy0, iy1, wy1) -> torch.Tensor:
    """Window extraction fused with the grid-mode bilinear resample: each
    output pixel is a separable 2-tap lerp over source pixels, columns
    first, with the taps and weights [B, 384] from the host (cv2
    INTER_LINEAR half-pixel maps; column taps are absolute pool columns).
    -> [B, 384, 384, C] float32."""
    c0 = _to_unit(images[:, ix0.long()].permute(1, 0, 2, 3))  # [B, rows, 384, C]
    c1 = _to_unit(images[:, ix1.long()].permute(1, 0, 2, 3))
    row = c0 + (c1 - c0) * wx1[:, None, :, None]
    b = torch.arange(row.shape[0], device=row.device)[:, None]
    r0 = row[b, iy0.long()]
    r1 = row[b, iy1.long()]
    return r0 + (r1 - r0) * wy1[:, :, None, None]


def accumulate(density, dens, owners, starts, wcols) -> torch.Tensor:
    """Stitch window densities into per-row maps, in place, in window
    order: density[owners[i], :, starts[i]:starts[i] + 384] +=
    dens[i] * wcols[i]. ``density`` [R, 384, Wb], ``dens`` [B, 384, 384],
    ``wcols`` [B, 384] on the device; ``owners`` and ``starts`` are the
    plan's host integers, so the loop reads nothing back from the device.
    One read-modify-write per window, in a fixed order: the same bits on
    every call (no atomics over overlapping windows). Returns
    ``density``."""
    for i, (o, s) in enumerate(zip(np.asarray(owners).tolist(), np.asarray(starts).tolist())):
        density[o, :, s:s + WINDOW].addcmul_(dens[i], wcols[i][None, :])
    return density


@contextlib.contextmanager
def fp32_products():
    """Matrix products in full fp32 (no TF32), as the JAX package's
    Precision.HIGHEST."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def finalize(density: torch.Tensor, rects: torch.Tensor, rect_valid: torch.Tensor):
    """Per density row, the count and the sum over its exemplar rects
    (y1, x1, y2, x2), inclusive bounds, each over DENSITY_SCALE: the TTN
    statistic before the /3 (reference: FSC_test_cross(few-shot).py:
    353-359). ``rects`` [R, K, 4] int, ``rect_valid`` [R, K] float.

    One pass over the density: the column sums of every rect's columns
    and of all columns (for the count) as one batched product with 0/1
    column masks, then the rect rows summed; fp32 products."""
    r, h, wb = density.shape
    k = rects.shape[1]
    y1, x1, y2, x2 = rects.unbind(-1)
    cols = torch.arange(wb, device=density.device, dtype=rects.dtype)
    rows = torch.arange(h, device=density.device, dtype=rects.dtype)
    colmask = ((cols >= x1[..., None]) & (cols <= x2[..., None])).to(density.dtype)
    rowmask = ((rows >= y1[..., None]) & (rows <= y2[..., None])).to(density.dtype)
    masks = torch.cat([colmask, density.new_ones((r, 1, wb))], 1)  # [R, K+1, wb]
    with fp32_products():
        colsums = torch.einsum("rhw,rkw->rkh", density, masks)  # [R, K+1, h]
        counts = colsums[:, k, :].sum(-1) / DENSITY_SCALE
        esum = (torch.einsum("rkh,rkh->rk", colsums[:, :k, :], rowmask)
                * rect_valid).sum(-1) / DENSITY_SCALE
    return counts, esum


def _chunk_windows(images, plan: dict, dev: dict, i: int, j: int, bk: int) -> torch.Tensor:
    """The windows [i, j) of a set's stream, extracted by the route their
    kind takes (plain slices, resampled gathers, or both for the one
    straddling chunk) and zero-padded to the forward bucket ``bk``.
    ``dev`` holds the plan's arrays on the device."""
    n_plain = plan["n_plain"]
    q = max(0, min(j, n_plain) - i)  # plain members
    r = (j - i) - q  # resampled members
    parts = []
    if q:
        parts.append(extract_windows(images, dev["abs_start"][i:i + q]))
    if r:
        lo = max(i, n_plain) - n_plain
        parts.append(extract_windows_resampled(images, *(dev[k][lo:lo + r] for k in MAP_KEYS)))
    if bk > j - i:
        parts.append(parts[0].new_zeros((bk - (j - i), *parts[0].shape[1:])))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def stitch_set(forward, images, y_all, plan: dict, dev: dict, n_den_rows: int,
               den_width: int, batch_windows: int, multiple: int = 1) -> torch.Tensor:
    """Every chunk of a set through ``forward(windows, y)`` and stitched:
    -> density [n_den_rows, 384, den_width] fp32. Padded forward slots
    take image 0's exemplar tokens, as in the JAX package, and are not
    stitched. Every chunk's window count is a multiple of ``multiple``
    (the devices a sharded forward splits it over)."""
    density = torch.zeros((n_den_rows, WINDOW, den_width), dtype=torch.float32,
                          device=images.device)
    n = plan["img_owner"].shape[0]
    for i, j, bk in stream_chunks(plan["n_plain"], n, batch_windows, multiple):
        owners = dev["img_owner"][i:j]
        if bk > j - i:
            owners = torch.cat([owners, owners.new_zeros(bk - (j - i))])
        with span("count.forward"):
            dens = forward(_chunk_windows(images, plan, dev, i, j, bk), y_all[owners])
        with span("count.stitch"):
            accumulate(density, dens, plan["den_owner"][i:j], plan["den_start"][i:j],
                       dev["wcol"][i:j])
    return density


class DevicePipeline:
    """One set at a time through the device stages. On a CUDA device the
    window forward is ``GraphedForward``; on the CPU it runs eagerly.

    ``devices`` (the lead, ``device``, first): the JAX package's
    ``DevicePipeline(mesh=...)`` in one process. The model is copied to
    each other device once (``parallel.mesh.replicate_to_mesh``; again
    when the lead's weights change), each window chunk is split into
    equal parts, one per device, each part forwarded by its device's own
    forward (one ``GraphedForward`` per device and bucket), and the parts'
    densities gathered on the lead device for the stitch. Every chunk is
    a multiple of the device count, so ``batch_windows`` must be one: it
    raises otherwise, where the JAX package warns and runs on one device
    (``countr_tpu/engine/device_pipeline.py:429-438``)."""

    def __init__(self, model, device: torch.device, devices=None, batch_windows: int = 16,
                 debug_nans: bool = False):
        self.model = model
        self.device = device
        self.devices = (device,)
        if devices:
            lead, *rest = (torch.device(d) for d in devices)
            if (lead.type, lead.index or 0) != (device.type, device.index or 0):
                raise ValueError(f"the lead device {lead} must be {device}")
            self.devices += tuple(rest)
        n = len(self.devices)
        if batch_windows % n:
            raise ValueError(f"batch_windows {batch_windows} is not a multiple of the "
                             f"{n} devices it is split over")
        self.replicas = [model]
        if n > 1:
            from countr_tpu_torch.parallel.mesh import Mesh, replicate_to_mesh

            self.replicas = replicate_to_mesh(Mesh(self.devices), model)
            self._weights = self._signature()
        self.graphed = device.type == "cuda" and not debug_nans
        self.forwards = [_device_forward(m, d, debug_nans)
                         for m, d in zip(self.replicas, self.devices)]
        self.forward = self.forwards[0] if n == 1 else self._sharded_forward
        self._in_flight: list = []  # (event, pinned host buffers) per upload batch

    def _signature(self) -> tuple:
        return tuple((t.data_ptr(), t._version) for t in self.model.state_dict().values())

    def _sharded_forward(self, windows: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The forward of one chunk split over the devices, gathered on the
        lead device in the chunk's order."""
        sig = self._signature()
        if sig != self._weights:
            for replica in self.replicas[1:]:
                replica.load_state_dict(self.model.state_dict())
            self._weights = sig
        n = len(self.devices)
        parts = [f(w.to(d), yy.to(d)) for f, d, w, yy in
                 zip(self.forwards, self.devices, windows.chunk(n), y.chunk(n))]
        return torch.cat([p.to(self.device) for p in parts])

    def upload(self, arrays) -> list:
        """Host arrays (numpy or CPU tensors) -> device tensors. To a card:
        staged in pinned memory and copied without blocking the host; the
        pinned buffers are held until an event after their copies has
        completed."""
        with span("count.upload"):
            ts = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                  for a in arrays]
            if self.device.type != "cuda":
                return [t.to(self.device) for t in ts]
            self._in_flight = [(ev, bufs) for ev, bufs in self._in_flight if not ev.query()]
            pinned = [t.pin_memory() for t in ts]
            out = [t.to(self.device, non_blocking=True) for t in pinned]
            event = torch.cuda.Event()
            event.record()
            self._in_flight.append((event, pinned))
            return out

    @torch.inference_mode()
    def run(
        self,
        images_np: np.ndarray,  # [384, Wt, 3] flat pixel pool (uint8/f32)
        y_all: torch.Tensor,  # [U, ny, C] exemplar tokens per image, on the device
        plan: dict,  # window plan (see below)
        rects_np: np.ndarray,  # [R, K, 4] per DENSITY row
        rect_valid_np: np.ndarray,  # [R, K]
        n_den_rows: int,  # R: density rows (9 per grid image, 1 otherwise)
        batch_windows: int,
        want_density: bool,
        den_width: int,  # Wb: density-map column bucket (max true width)
    ):
        """Returns (counts [R], esum [R], density [R, 384, Wb] or None) as
        DEVICE tensors (callers read them after dispatching further sets).

        ``plan`` arrays, one entry per window, PLAIN windows first:
          img_owner [N] int32 — image index (exemplar-token gather)
          den_owner [N] int32 — density row the output blends into
          den_start [N] int32 — column offset in the density row
          abs_start [n_plain] int32 — absolute pool column of the window
          wcol [N, 384] f32   — stitch weights
          n_plain: int        — windows [0, n_plain) are plain slices;
                                the rest carry resample maps
          ix0/ix1/wx1/iy0/iy1/wy1 [N - n_plain, 384] — 2-tap bilinear
                                maps (absolute pool columns) for
                                grid-mode crop windows
        """
        keys = [k for k in plan if k != "n_plain"]
        images, rects, valid, *arrays = self.upload(
            [images_np, rects_np, rect_valid_np] + [plan[k] for k in keys])
        dev = dict(zip(keys, arrays))
        density = stitch_set(self.forward, images, y_all, plan, dev, n_den_rows, den_width,
                             batch_windows, len(self.devices))
        with span("count.finalize"):
            counts, esum = finalize(density, rects, valid)
        return counts, esum, (density if want_density else None)


def _device_forward(model, device: torch.device, debug_nans: bool = False):
    """The window forward on ``device``: ``GraphedForward`` on a card,
    eager on the CPU; with ``debug_nans`` eager everywhere, and the first
    window batch whose density holds a NaN raises ``FloatingPointError``
    (``nan_checked``)."""
    if debug_nans:
        return nan_checked(model.forward_tokens)
    if device.type == "cuda":
        from countr_tpu_torch.engine.graphs import GraphedForward

        return GraphedForward(model)
    return model.forward_tokens


def nan_checked(forward):
    """``forward(windows, y)`` that raises ``FloatingPointError`` naming
    the window batch (counted from 1) whose density holds a NaN: the
    counting CLIs' ``--debug_nans``."""
    calls = [0]

    def checked(windows: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        calls[0] += 1
        den = forward(windows, y)
        if not bool(torch.isfinite(den).all()):
            raise FloatingPointError(f"--debug_nans: NaN in the density of window batch "
                                     f"{calls[0]}")
        return den

    return checked
