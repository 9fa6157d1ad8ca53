"""Host seconds a step in the harness's own build_mat call, ending at a
device sync."""

from portbench.core.readers import per_step


def read(run):
    return per_step(run, 'build_s')
