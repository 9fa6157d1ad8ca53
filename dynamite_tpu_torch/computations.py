"""
High-level computations: time evolution and eigensolving.

Reference analog: src/dynamite/computations.py (there, thin wrappers over
SLEPc MFN/EPS; here, wrappers over the torch Krylov solvers in
dynamite_tpu_torch.solvers).
"""

import time
from contextlib import contextmanager

import numpy as np

from . import config
from .solvers.expmv import expmv, initial_tstep
from .solvers.eigs import eigsolve_trlanczos, ritz_vectors
from .solvers.krylov import check_workspace_fits

DEFAULT_NCV_EVOLVE = 30

#: Per-phase wall times and iteration counters of the most recent evolve() /
#: eigsolve() call — the analog of the reference's PETSc ``-log_view``
#: diagnostics. Keys: phase wall times (``*_s``), solver counters
#: (substeps, matvecs, host_syncs, restarts).
last_solve_stats = {}


@contextmanager
def _phase(stats, key):
    t0 = time.perf_counter()
    yield
    stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0


def evolve(H, state, t, result=None, tol=None, ncv=None, algo=None,
           max_its=None):
    r"""Evolve a state under the Schrodinger equation:
    :math:`\Psi_t = e^{-iHt}\Psi_0`.

    Parameters mirror the reference's evolve (computations.py:10-126);
    ``algo`` is accepted for compatibility (the Krylov/Expokit stepping
    scheme is always used). ``t`` may be complex for imaginary-time
    evolution.
    """
    state.assert_initialized()
    config._initialize()

    H.establish_L()

    if not H.has_subspace(state.subspace, state.subspace):
        raise ValueError('Hamiltonian and state are defined on different '
                         'subspaces.')

    from .states import State
    if result is None:
        result = State(L=H.L, subspace=state.subspace)
    elif state.subspace != result.subspace:
        raise ValueError('input and result states are on different '
                         'subspaces.')

    if t == 0.0:
        state.copy(result)
        return result

    if ncv is None:
        ncv = DEFAULT_NCV_EVOLVE
    if tol is None:
        tol = 1e-7

    stats = {}
    with _phase(stats, 'build_s'):
        kernel = H.get_mat(subspaces=(state.subspace, state.subspace))
    m = min(ncv, len(state))
    check_workspace_fits(len(state), m, state.data.device, state.data.dtype,
                         'evolve')
    kops = kernel.krylov_ops(m)

    # the matrix infinity norm (computed on the device, cached on the
    # operator) for the Expokit stepping heuristic — a much tighter bound
    # than sum_t |c_t|, which overestimates ||H|| by up to the term count
    # and shrinks the initial substeps accordingly
    with _phase(stats, 'norm_s'):
        anorm = H.infinity_norm(subspaces=(state.subspace, state.subspace))

    with _phase(stats, 'solve_s'):
        result.data = expmv(kops, state.data, -1j * t, anorm, ncv=ncv,
                            tol=tol, max_its=max_its, stats=stats)
    result.set_initialized()
    global last_solve_stats
    last_solve_stats = stats
    return result


def eigsolve(H, getvecs=False, nev=1, which='lowest', target=None, tol=None,
             subspace=None, max_its=None, ncv=None):
    r"""Solve for a subset of the Hamiltonian's eigenpairs.

    Parameters mirror the reference (computations.py:128-292). ``which`` is
    one of 'lowest', 'highest' or 'exterior'. Interior eigenvalues
    (``target=``) are not ported yet.
    """
    H.establish_L()

    if subspace is None:
        subspace = H.subspace
    elif not H.has_subspace(subspace):
        raise ValueError('Requested subspace has not been added to operator.')

    config._initialize()

    if which in ('smallest', 'largest'):
        import warnings
        warnings.warn('values "smallest" and "largest" for eigsolve '
                      'parameter "which" are deprecated, and have been '
                      'replaced by "lowest" and "highest" respectively.',
                      DeprecationWarning, stacklevel=2)
        which = {'smallest': 'lowest', 'largest': 'highest'}[which]

    if target is not None or which == 'target':
        raise NotImplementedError('interior eigenvalues (target=) are not '
                                  'ported yet (ROADMAP.md queue 1, item 11)')

    kernel = H.get_mat(subspaces=(subspace, subspace))
    dim = subspace.get_dimension()

    if ncv is None:
        ncv = min(dim - 1 if dim > 2 else dim, max(2 * nev + 10, 20))
    ncv = min(ncv, dim)

    dtype = config.real_dtype
    device = config.device
    check_workspace_fits(dim, ncv, device, dtype, 'eigsolve')
    kops = kernel.krylov_ops(ncv)

    stats = {}
    with _phase(stats, 'solve_s'):
        evals, S, V = eigsolve_trlanczos(
            kops, dim, dtype, device, nev=nev, which=which, tol=tol,
            max_restarts=max_its, stats=stats)
    global last_solve_stats
    last_solve_stats = stats

    if not getvecs:
        return np.asarray(evals, dtype=float)

    from .states import State
    evecs = []
    for vec in ritz_vectors(S, V):
        v = State(L=H.L, subspace=subspace)
        v.data = vec
        v.set_initialized()
        evecs.append(v)
    return np.asarray(evals, dtype=float), evecs


def get_tstep(ncv, nrm, tol=1e-7):
    """Length of an Expokit substep (reference: computations.py:511-519)."""
    return initial_tstep(ncv, nrm, tol)


def estimate_compute_time(t, ncv, nrm, tol=1e-7):
    """Estimated cost of an expmv solve in units of matvecs."""
    tstep = get_tstep(ncv, nrm, tol)
    return ncv * np.ceil(t / tstep)
