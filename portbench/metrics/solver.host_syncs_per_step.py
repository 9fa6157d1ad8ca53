"""Host syncs a step: the port's last_solve_stats['host_syncs'] (a program
counter)."""

from portbench.core.readers import per_step


def read(run):
    return per_step(run, 'host_syncs')
