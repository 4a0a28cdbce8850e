"""Per cent of kernel B1's roofline on the counting path: the least time
its launches' shapes allow (`work/kernels/b1.py`) over its device time
in the trace."""

from benchmark.lib.readers import roofline


def read(layer):
    return roofline(layer, "B1")
