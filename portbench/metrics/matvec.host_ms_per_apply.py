"""Host ms of one apply (the program's span ``apply``: enqueueing one
matvec) in a step with the program's spans alone (``core/spans.py``)."""

from portbench.core import spans


def read(run):
    out = spans.host(run)
    if out is None or 'apply' not in out['spans']:
        return None
    rec = out['spans']['apply']
    return rec['host_s'] / rec['n'] * 1e3
