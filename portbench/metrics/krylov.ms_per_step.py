"""Device ms a step inside the solves and outside their matvecs: the Krylov
basis and the solver's vector operations (on rank 0 over several cards)."""

from portbench.core.readers import device_ms_per_step


def read(run):
    return device_ms_per_step(run, 'krylov')
