"""Share of the traced window in which the card ran no kernel, memcpy or
memset (the union of the profiler's device intervals; rank 0 over
several cards), in %."""

from portbench.core.readers import idle_percent


def read(run):
    return idle_percent(run)
