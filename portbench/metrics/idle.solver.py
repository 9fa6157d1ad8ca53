"""Share of a profiled step's window (``core/spans.py``, phase 2) in which
the device idled while the host was in the layer this file is named after
(its innermost program span's), in %."""

import os

from portbench.core import spans

LAYER = os.path.basename(__file__).split('.')[1]


def read(run):
    return spans.idle_percent(run, LAYER)
