"""Per cent of the traced window of ViT-H/14 pretraining in which the
device ran nothing: 1 - (union of the device's operation intervals in
the torch.profiler trace) / window."""

from benchmark.lib.readers import idle_share


def read(layer):
    return idle_share(layer)
