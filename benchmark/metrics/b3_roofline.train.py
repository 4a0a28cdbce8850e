"""Per cent of kernel B3's roofline in a training step: the least time
its launches' shapes allow (`work/kernels/b3.py`) over its device time
in the trace."""

from benchmark.lib.readers import roofline


def read(layer):
    return roofline(layer, "B3")
