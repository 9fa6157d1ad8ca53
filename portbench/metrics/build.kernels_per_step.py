"""Operator kernels built in a step (the program's counter
``build.kernels``), counted in a step with the program's spans alone
(``core/spans.py``)."""

from portbench.core import spans


def read(run):
    out = spans.host(run)
    return None if out is None else out['counters'].get('build.kernels', 0)
