"""Device ms a step in NCCL kernels on rank 0: the program's exchange and
all-reduces (the harness's own agreement on the window's end left out)."""

from portbench.core.readers import nccl_ms_per_step


def read(run):
    return nccl_ms_per_step(run)
