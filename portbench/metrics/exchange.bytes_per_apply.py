"""Bytes rank 0 sends in the pairwise exchange a matvec (the program's
counters ``transport.exchange.bytes`` over ``apply.calls``, over the run:
the warm-up cycle and the window's, the same cycle)."""

from portbench.core import spans


def read(run):
    counts = spans.counters()
    if not counts or not counts.get('apply.calls'):
        return None
    return counts.get('transport.exchange.bytes', 0) / counts['apply.calls']
