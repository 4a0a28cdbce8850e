"""Per cent of the traced stretch in which the device ran nothing while
ViT-H/14's training loop waited for its next batch: idle time under the
program's ``data.next`` spans (``device_prefetch``'s wait), over the
stretch's seconds."""

from benchmark.lib.program_spans import TRAIN_ANCHOR, idle_share_under


def read(layer):
    return idle_share_under(layer, TRAIN_ANCHOR, ("data.next",))
