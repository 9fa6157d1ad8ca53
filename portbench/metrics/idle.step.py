"""The device's idle share in the profiled step whose idle the
``idle.<layer>`` metrics split (``core/spans.py``, phase 2), in %: the
sum of those metrics."""

from portbench.core import spans


def read(run):
    out = spans.idle(run)
    if not out or not out['window_s']:
        return None
    return (1 - out['busy_s'] / out['window_s']) * 100
