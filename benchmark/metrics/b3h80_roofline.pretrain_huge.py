"""Per cent of kernel B3's roofline at head dim 80 in a ViT-H/14
training step: the least time its hd-80 launches' shapes allow
(`work/kernels/b3h80.py`) over the device time of its hd-80 kernels in
the trace."""

from benchmark.lib.readers import roofline


def read(layer):
    return roofline(layer, "B3h80")
