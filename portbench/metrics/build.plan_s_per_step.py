"""Host seconds a step in the sector engine's host build (the program's
span ``build.sector_plan``), in a step with the program's spans alone
(``core/spans.py``)."""

from portbench.core import spans


def read(run):
    return spans.span_seconds(run, 'build.sector_plan')
