"""The least time of one H x on an H100 (portbench/core/roofline.py) over
the device time of one apply inside a solve, in %."""

from portbench.core.readers import matvec_roofline


def read(run):
    return matvec_roofline(run)
