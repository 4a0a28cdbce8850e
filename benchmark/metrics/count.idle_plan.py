"""Per cent of the traced stretch in which the device ran nothing while
the counting engine planned: idle time under the program's
``count.plan_sets`` (set packing) and ``count.plan_set`` (a set's numpy
assembly) spans, the innermost open, over the stretch's seconds."""

from benchmark.lib.program_spans import COUNT_ANCHOR, idle_share_under


def read(layer):
    return idle_share_under(layer, COUNT_ANCHOR, ("count.plan_sets", "count.plan_set"))
