"""Per cent of kernel B4's roofline in a ViT-H/14 training step, over
all of its launches: the encoder's at head dim 80 and the decoder's at
head dim 32 (`work/kernels/b4.py`), the least time their shapes allow
over the device time of all B4 kernels in the trace."""

from benchmark.lib.readers import roofline


def read(layer):
    return roofline(layer, "B4")
