"""Per cent of the traced stretch in which the device ran nothing while
the counting engine launched work: idle time under the program's
``count.upload``, ``count.exemplars``, ``count.forward``,
``count.stitch``, ``count.finalize`` and ``graph.*`` spans, the innermost
open, over the stretch's seconds."""

from benchmark.lib.program_spans import COUNT_ANCHOR, idle_share_under


def read(layer):
    return idle_share_under(layer, COUNT_ANCHOR, ("count.upload", "count.exemplars",
                                                  "count.forward", "count.stitch",
                                                  "count.finalize"), ("graph.",))
