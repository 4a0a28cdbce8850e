"""Per cent of the traced stretch in which the device ran nothing while
the counting engine read results back or sat in ``count_batch`` outside
its phases: idle time under the program's ``count.collect`` spans and
``count.batch``'s self time (the innermost open), over the stretch's
seconds."""

from benchmark.lib.program_spans import COUNT_ANCHOR, idle_share_under


def read(layer):
    return idle_share_under(layer, COUNT_ANCHOR, ("count.collect", "count.batch"))
