"""Matvecs a step: the port's last_solve_stats['matvecs'], summed over the
step's solves (a program counter)."""

from portbench.core.readers import per_step


def read(run):
    return per_step(run, 'matvecs')
