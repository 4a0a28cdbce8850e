"""Per cent of the traced stretch in which the device ran nothing while
the host ran a ViT-H/14 training step's own part: idle time under the
program's ``train.step``, ``graph.*`` and ``train.log`` spans, the
innermost open, over the stretch's seconds."""

from benchmark.lib.program_spans import TRAIN_ANCHOR, idle_share_under


def read(layer):
    return idle_share_under(layer, TRAIN_ANCHOR, ("train.step", "train.log"), ("graph.",))
