"""Per cent of the H100's bf16 dense peak (989 TFLOP/s) in ViT-H/14
pretraining: the reference architecture's operations
(`work/models/mae.py`) for the work the window did outside its traced
stretch, over those seconds by the host's clock."""

from benchmark.lib.readers import mfu


def read(layer):
    return mfu(layer)
