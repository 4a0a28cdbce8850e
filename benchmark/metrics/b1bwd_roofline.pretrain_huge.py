"""Per cent of B1bwd's roofline (B1's backward) in a ViT-H/14 training step: the
least time its launches' shapes allow (`work/kernels/b1bwd.py`) over its
device time in the trace. Every LayerNorm forward of a pretraining step
has one backward, so the plan's B1 launches are B1bwd's; None where the
program's B1bwd counter disagrees with them, or where it has none."""

from benchmark.lib.readers import roofline


def read(layer):
    launches = (layer.get("launches") or {}).get("B1")
    if not launches or (layer.get("launches_counted") or {}).get("B1bwd") is None:
        return None
    return roofline(dict(layer, launches={**layer["launches"], "B1bwd": launches}), "B1bwd")
