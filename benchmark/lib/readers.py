"""What the per-layer readers (``metrics/<name>.py``) share. Each takes
the driver's record of a traced run and returns a number, or None where
it finds nothing to read; it never returns 0 for a share of a roofline or
of a peak."""

from __future__ import annotations

import importlib

from benchmark.lib import peaks
from benchmark.lib.trace import kernel_seconds


def idle_share(layer: dict):
    """Per cent of the traced window in which no operation ran on the
    device (the union of the trace's device intervals)."""
    tr = layer.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(layer: dict):
    """Per cent of the bf16 dense peak: the model operations of the work
    the window did outside its traced stretch, over those seconds by the
    host's clock (the profiler's own host time stays out)."""
    if not layer.get("untraced_flops") or not layer.get("untraced_s", 0) > 0:
        return None
    return 100.0 * layer["untraced_flops"] / layer["untraced_s"] / peaks.BF16_FLOPS


def roofline(layer: dict, kernel: str):
    """Per cent of the roofline of kernel ``kernel`` ("B1".."B4"): the sum
    over its launches in the traced window of the least time their shapes
    allow, over the device seconds of the kernel's trace names. None
    where the launches the driver counted from the plan disagree with the
    program's launch counters, or the trace holds none of its kernels."""
    tr = layer.get("trace")
    launches = (layer.get("launches") or {}).get(kernel)
    if not tr or not launches:
        return None
    counted = (layer.get("launches_counted") or {}).get(kernel)
    if counted is not None and counted != sum(launches.values()):
        return None
    work = importlib.import_module(f"benchmark.work.kernels.{kernel.lower()}")
    least = sum(n * peaks.least_seconds(work.flops(*shape), work.nbytes(*shape))
                for shape, n in launches.items())
    secs, n = kernel_seconds(tr, work.TRACE_NAMES)
    if secs <= 0 or n == 0:
        return None
    return 100.0 * least / secs
