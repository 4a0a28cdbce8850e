"""Per cent of kernel B4's roofline at head dim 80 in a ViT-H/14
training step: the least time its hd-80 launches' shapes allow
(`work/kernels/b4h80.py`) over the device time of its two hd-80 passes
in the trace."""

from benchmark.lib.readers import roofline


def read(layer):
    return roofline(layer, "B4h80")
