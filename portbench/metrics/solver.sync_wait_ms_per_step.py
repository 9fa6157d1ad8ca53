"""Host ms a step blocked on the device in the solvers' device-to-host
reads (the program's span ``solver.sync``), in a step with the program's
spans alone (``core/spans.py``)."""

from portbench.core import spans


def read(run):
    seconds = spans.span_seconds(run, 'solver.sync')
    return None if seconds is None else seconds * 1e3
