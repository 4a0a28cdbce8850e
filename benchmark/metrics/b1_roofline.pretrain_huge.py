"""Per cent of kernel B1's roofline in a ViT-H/14 training step: the
least time its launches' shapes allow (`work/kernels/b1.py`; [11648,
1280] in the encoder, [23328, 512] in the decoder) over its device time
in the trace."""

from benchmark.lib.readers import roofline


def read(layer):
    return roofline(layer, "B1")
