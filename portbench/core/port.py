"""Everything the harness asks of the port, through its public API:
``operators``, ``subspaces``, ``states``, ``computations`` and ``config``
(``parallel.multihost`` joins the launcher's group at the first use, and
``switch`` starts the ranks, in ``harness``). The traced run also wraps
one function of the port from here, ``ops.apply.OperatorKernel.apply``
(every matvec), in a ``record_function`` range; if the port renames it,
nothing is wrapped and the metrics that need matvec ranges read None.
"""

import functools

from . import trace


def start(precision, L, device=None):
    """Initialize the port's configuration for one run (joining the
    launcher's process group, if any)."""
    from dynamite_tpu_torch import config
    if device is not None:
        config.device = device
    config.initialize(precision=precision)
    config.L = L


def operator(terms):
    """The port's Operator of a term list, built from its Pauli matrices."""
    from dynamite_tpu_torch import operators as ops
    letters = {'X': ops.sigmax, 'Y': ops.sigmay, 'Z': ops.sigmaz}
    return ops.op_sum(
        coeff * ops.op_product([letters[p](site) for site, p in sites])
        for coeff, sites in terms)


def state(**kwargs):
    from dynamite_tpu_torch.states import State
    return State(**kwargs)


def space(spec, L):
    """The port's subspace of a configuration's ``space`` entry."""
    from dynamite_tpu_torch import subspaces
    if spec['kind'] == 'full':
        return subspaces.Full(L)
    if spec['kind'] == 'spinconserve':
        return subspaces.SpinConserve(L, spec['k'])
    raise ValueError(f'unknown space {spec["kind"]!r}')


COUNTS = ('matvecs', 'host_syncs')


def add_solve_counts(record):
    """Add the last solve's counters (``computations.last_solve_stats``:
    matvecs, host syncs) to a step's record; a counter the port did not
    fill is left out."""
    from dynamite_tpu_torch import computations
    for key in COUNTS:
        if key in computations.last_solve_stats:
            record[key] = (record.get(key, 0)
                           + computations.last_solve_stats[key])


def wrap_matvecs():
    """Open a ``portbench.matvec`` range around every matvec of the port
    for the rest of the process (before any operator is built, since the
    Krylov loops keep the bound method). Returns whether it could."""
    from torch.profiler import record_function
    try:
        from dynamite_tpu_torch.ops.apply import OperatorKernel
        plain = OperatorKernel.apply
    except (ImportError, AttributeError):
        return False

    @functools.wraps(plain)
    def apply(self, x):
        with record_function(trace.MATVEC):
            return plain(self, x)

    OperatorKernel.apply = apply
    return True
