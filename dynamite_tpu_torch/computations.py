"""
High-level computations: time evolution, eigensolving, reduced density
matrices and entanglement entropies.

Reference analog: src/dynamite/computations.py (there, thin wrappers over
SLEPc MFN/EPS; here, wrappers over the torch Krylov solvers in
dynamite_tpu_torch.solvers).

With a process group up (``parallel.multihost.initialize``), every rank
calls these together on its own rows; the solvers' reductions are
all-reduced, so every rank takes the same host decisions (and raises
``MaxIterationsError`` or ``ConvergenceError`` together) and counts the
same iterations. A solve that completes leaves rank 0's
``last_solve_stats`` on every rank, its wall times included.
"""

import time
import warnings
from contextlib import contextmanager

import numpy as np
import torch

from . import config, tracing
from .ops import cvec
from .ops import msc as msc_tools
from .parallel import multihost
from .solvers.eigs import eigsolve_trlanczos, ritz_vectors
from .solvers.expmv import (ConvergenceError, MaxIterationsError, expmv,
                             initial_tstep)
from .solvers.krylov import (KrylovOps, check_workspace_fits, combine,
                             counting_syncs, gram, host)
from .solvers.minres import minres_solver

DEFAULT_NCV_EVOLVE = 30

#: Per-phase wall times and iteration counters of the most recent evolve() /
#: eigsolve() call — the analog of the reference's PETSc ``-log_view``
#: diagnostics. Keys: phase wall times (``*_s``, host seconds of the spans
#: ``solver.<phase>``), solver counters (substeps, matvecs, restarts), and
#: host_syncs, the counter ``solver.syncs`` over the solve
#: (:mod:`.tracing`).
last_solve_stats = {}


@contextmanager
def _maybe_profile(name):
    """Wrap a solve in a torch.profiler trace when ``config.profile_dir`` is
    set: CPU activity, and the card's when ``config.device`` is CUDA; one
    Chrome/TensorBoard trace per call, ``{name}_rank{r}.{ns}.pt.trace.json``
    in that directory (so ranks never overwrite each other). The port's
    spans (:mod:`.tracing`) are on while it records, so the trace names
    them (``dynamite.solve.evolve``, ``dynamite.apply``, ...). With it
    unset nothing is imported or written.

    A user feature, not a measurement: the profiler's own cost is in the
    solve's times, and it can drop kernel launches from its record."""
    profile_dir = config.profile_dir
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if config.device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(
        profile_dir, worker_name=f'{name}_rank{multihost.rank()}')
    was_on = tracing.enabled()
    tracing.enable()
    try:
        with profile(activities=activities, on_trace_ready=handler):
            yield
    finally:
        if not was_on:
            tracing.disable()


@contextmanager
def _phase(stats, key):
    """The span ``solver.<phase>`` of the ``<phase>_s`` key, whose host
    seconds it adds to ``stats[key]``."""
    t0 = time.perf_counter()
    with tracing.span('solver.' + key[:-2]):
        yield
    stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0


def _shared_stats(stats):
    """Rank 0's stats on every rank (the counters agree already, the wall
    times not)."""
    with tracing.span('solver.stats'):
        return multihost.broadcast_object(stats)


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
    with _maybe_profile('evolve'), tracing.span('solve.evolve'):
        with _phase(stats, 'build_s'):
            kernel = H.get_mat(subspaces=(state.subspace, state.subspace))
        m = min(ncv, len(state))
        check_workspace_fits(len(state), m, state.data.device,
                             state.data.dtype, 'evolve')
        kops = kernel.krylov_ops(m)

        # the matrix infinity norm (computed on the device, cached on the
        # operator) for the Expokit stepping heuristic — a much tighter
        # bound than sum_t |c_t|, which overestimates ||H|| by up to the
        # term count and shrinks the initial substeps accordingly
        with _phase(stats, 'norm_s'):
            anorm = H.infinity_norm(
                subspaces=(state.subspace, state.subspace))

        with _phase(stats, 'solve_s'):
            result.data = expmv(kops, state.data, -1j * t, anorm, ncv=ncv,
                                tol=tol, max_its=max_its, stats=stats)
        result.set_initialized()
        global last_solve_stats
        last_solve_stats = _shared_stats(stats)
    return result


def eigsolve(H, getvecs=False, nev=1, which='lowest', target=None, tol=None,
             subspace=None, max_its=None, ncv=None, target_method=None,
             inner_its=None, inner_tol=None):
    r"""Solve for a subset of the Hamiltonian's eigenpairs.

    Parameters mirror the reference (computations.py:128-292). ``which`` is
    one of 'lowest', 'highest', 'exterior', or 'target' (with ``target``
    set).

    For interior eigenvalues (``target=``), ``target_method`` selects the
    matrix-free strategy: 'shift_invert' (default: Lanczos on
    (H-target)^{-1}, each apply an inner MINRES solve bounded by
    ``inner_its``, default :func:`default_inner_its`, and ``inner_tol``,
    default 1e-10 in double precision and 1e-5 in single; a
    ``RuntimeWarning`` names any inner solve that stops above
    ``inner_tol``) or 'fold' (Lanczos on (H-target)^2, no inner solve but a
    squared condition number). See :func:`_eigsolve_target`.
    """
    H.establish_L()

    if subspace is None:
        subspace = H.subspace
    elif not H.has_subspace(subspace):
        raise ValueError('Requested subspace has not been added to operator.')

    config._initialize()

    if which in ('smallest', 'largest'):
        warnings.warn('values "smallest" and "largest" for eigsolve '
                      'parameter "which" are deprecated, and have been '
                      'replaced by "lowest" and "highest" respectively.',
                      DeprecationWarning, stacklevel=2)
        which = {'smallest': 'lowest', 'largest': 'highest'}[which]

    if target is not None:
        which = 'target'
    elif which == 'target':
        raise ValueError("which='target' requires the target "
                         'parameter')

    with _maybe_profile('eigsolve'), tracing.span('solve.eigsolve'):
        kernel = H.get_mat(subspaces=(subspace, subspace))
        dim = subspace.get_dimension()

        if which == 'target':
            return _eigsolve_target(H, dim, nev, target, tol, getvecs,
                                    max_its, ncv, subspace, target_method,
                                    inner_its, inner_tol)

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
        last_solve_stats = _shared_stats(stats)

        if not getvecs:
            return np.asarray(evals, dtype=float)
        return (np.asarray(evals, dtype=float),
                _ritz_states(H, subspace, S, V))


def _eigsolve_target(H, dim, nev, target, tol, getvecs, max_its, ncv,
                     subspace, method, inner_its, inner_tol):
    """Interior eigenvalues near ``target``.

    The reference does this with SLEPc shift-invert and a MUMPS direct
    solve, which it refuses for matrix-free (shell) operators. Here every
    operator is matrix-free, so the inverse is applied iteratively
    (method='shift_invert': outer Lanczos on (H-target)^{-1}, each apply
    an inner MINRES solve), or avoided (method='fold': Lanczos on
    (H-target)^2, whose lowest eigenvalues are the ones closest to the
    target; robust, but it squares the condition number, so it needs far
    more iterations on dense mid-spectrum problems).

    Both methods produce nev + 4 candidate states; the eigenpairs come from
    a Rayleigh-Ritz step on H itself, so the returned eigenvalues are
    accurate even when the inner solves are loose.

    ``last_solve_stats`` is filled as the solve goes, so a solve that
    raises (``MaxIterationsError``) leaves its counters there: the outer
    applies and restarts, the MINRES solves and iterations, the extract's
    applies, ``matvecs`` (every H apply: the MINRES iterations, or the
    folded applies, plus the extract's) and the host syncs (the counter
    ``solver.syncs`` over the solve).
    """
    if method is None:
        method = 'shift_invert'
    if method not in ('shift_invert', 'fold'):
        raise ValueError("target_method must be 'shift_invert' or 'fold' "
                         f'(got {method!r})')

    nev_f = min(dim, nev + 4)
    if ncv is None:
        if method == 'fold':
            ncv = min(dim - 1 if dim > 2 else dim, max(2 * nev_f + 25, 40))
        else:
            ncv = min(dim - 1 if dim > 2 else dim, max(2 * nev_f + 10, 20))
    ncv = min(ncv, dim)
    dtype = config.real_dtype
    device = config.device
    check_workspace_fits(dim, ncv, device, dtype, 'eigsolve')

    global last_solve_stats
    outer, inner, extract = {}, {}, {}
    last_solve_stats = stats = {'method': method}
    try:
        with tracing.span('solve.target'), counting_syncs(stats):
            with _phase(stats, 'candidates_s'):
                if method == 'shift_invert':
                    states = _target_candidates_shift_invert(
                        H, dim, nev_f, target, tol, max_its, ncv, subspace,
                        dtype, device, inner_its, inner_tol, outer, inner)
                else:
                    states = _target_candidates_fold(
                        H, dim, nev_f, target, tol, max_its, ncv, subspace,
                        dtype, device, outer)
            with _phase(stats, 'extract_s'):
                result = _rayleigh_ritz_extract(H, states, target, nev,
                                                getvecs, stats=extract)
    finally:
        stats.update(_target_stats(method, outer, inner, extract))
    stats.update(_shared_stats(stats))
    return result


def _target_stats(method, outer, inner, extract):
    """The flat ``last_solve_stats`` of a target solve from its parts."""
    outer_applies = outer.get('matvecs', 0)
    minres_its = inner.get('iterations', 0)
    return {
        'outer_applies': outer_applies,
        'restarts': outer.get('restarts', 0),
        'verify_cycles': outer.get('verify_cycles', 0),
        'outer_residual_estimate': outer.get('residual_estimate'),
        'minres_solves': inner.get('solves', 0),
        'minres_iterations': minres_its,
        'minres_max_iterations': inner.get('max_iterations', 0),
        'minres_max_rel_residual': inner.get('max_rel_residual'),
        'minres_unconverged': inner.get('unconverged', 0),
        'extract_applies': extract.get('applies', 0),
        'matvecs': (minres_its if method == 'shift_invert'
                    else outer_applies) + extract.get('applies', 0),
    }


def default_inner_its(dim):
    """The default cap on each inner MINRES solve: 10 dim iterations.

    Mid-spectrum, the shifted operator's condition number grows with the
    dimension (the level spacing shrinks as 1/dim), and so do the
    iterations MINRES needs. For the MBL example's Hamiltonian (seed 7) at
    the middle of its spectrum, float64, the default inner_tol, one solve
    from a random right-hand side took 2.0, 2.5, 3.0 and 3.3 dim at L=10,
    12, 14 and 16 (dim 252 to 12,870), and its eigsolve's largest solve
    3.0 dim at L=14 (10,402 iterations); localized(12) 2.5 dim. The JAX
    package's min(2 dim, 2000) stops those solves short, and the outer
    Lanczos then converges to wrong levels (ROADMAP.md queue 3). A solve
    that still stops at the cap makes eigsolve warn."""
    return 10 * dim


def _target_candidates_shift_invert(H, dim, nev_f, target, tol, max_its,
                                    ncv, subspace, dtype, device, inner_its,
                                    inner_tol, outer, inner):
    """Candidate states from Lanczos on (H - target)^{-1}: the largest-
    magnitude eigenvalues of the inverse are the ones closest to the
    target, so O(10) outer iterations suffice, at the price of an inner
    MINRES solve per outer apply. ``outer`` and ``inner`` collect the
    Lanczos and MINRES counters."""
    if inner_its is None:
        inner_its = default_inner_its(dim)
    if inner_tol is None:
        inner_tol = 1e-10 if dtype == torch.float64 else 1e-5
    # the outer residual tolerance lives on the (H-target)^{-1} eigenvalue
    # scale; the final accuracy comes from the Rayleigh-Ritz step on H
    outer_tol = tol if tol is not None else \
        (1e-8 if dtype == torch.float64 else 1e-5)

    kernel = H.get_mat(subspaces=(subspace, subspace))
    inverse_apply = minres_solver(kernel.apply, shift=float(target),
                                  maxiter=inner_its, rtol=inner_tol,
                                  stats=inner)
    _theta, S, V = eigsolve_trlanczos(
        KrylovOps(inverse_apply, ncv), dim, dtype, device, nev=nev_f,
        which='exterior', tol=outer_tol, max_restarts=max_its, stats=outer)
    if inner['unconverged']:
        warnings.warn(
            f"eigsolve(target={target}): {inner['unconverged']} of "
            f"{inner['solves']} inner MINRES solves stopped above "
            f'inner_tol={inner_tol:g} (largest relative residual '
            f"{inner['max_rel_residual']:.3g}) at inner_its={inner_its}; "
            'the interior eigenvalues may be wrong: raise inner_its',
            RuntimeWarning, stacklevel=4)
    return _ritz_states(H, subspace, S, V)


def _folded_msc(H, target):
    """The MSC of (H - target)^2, built symbolically: squaring leaves exact
    cancellations as ~1e-17 float residue, dropped below 1e-12 of the
    largest coefficient so that the conservation check still sees H's
    symmetry."""
    H.reduce_msc()
    shifted = msc_tools.msc_sum(
        [H.msc, msc_tools.msc_from_arrays([0], [0], [-target])])
    folded = msc_tools.combine_terms(msc_tools.msc_product([shifted, shifted]))
    if len(folded):
        folded = msc_tools.truncate(
            folded, 1e-12 * float(np.abs(folded['coeffs']).max()))
    return folded


def _target_candidates_fold(H, dim, nev_f, target, tol, max_its, ncv,
                            subspace, dtype, device, outer):
    """Candidate states from Lanczos on the folded operator (H - target)^2,
    which runs through the same engines as H (the XOR kernel on Full and
    Parity). ``outer`` collects the Lanczos counters."""
    from .operators import Operator

    folded_msc = _folded_msc(H, target)
    folded = Operator(msc=folded_msc)
    folded._subspaces = list(H.get_subspace_list())
    folded.allow_projection = H.allow_projection
    fkernel = folded.get_mat(subspaces=(subspace, subspace))

    # folding squares the condition number, so tight residuals on
    # (H-target)^2 are unreachable; a loose outer tolerance is enough
    # because the Rayleigh-Ritz step on H itself recovers the accuracy
    fold_tol = tol if tol is not None else \
        (1e-6 if dtype == torch.float64 else 1e-4)
    scale = float(np.sum(np.abs(folded_msc['coeffs']))) \
        if len(folded_msc) else 1.0

    _evals_sq, S, V = eigsolve_trlanczos(
        fkernel.krylov_ops(ncv), dim, dtype, device, nev=nev_f,
        which='lowest', tol=fold_tol, max_restarts=max_its, stats=outer,
        tol_scale=scale)
    return _ritz_states(H, subspace, S, V)


def _ritz_states(H, subspace, S, V):
    """The Ritz vectors sum_k S[k, i] V[k] as States."""
    from .states import State
    states = []
    for vec in ritz_vectors(S, V):
        v = State(L=H.L, subspace=subspace)
        v.data = vec
        v.set_initialized()
        states.append(v)
    return states


def _streamed_grams(kernel, V, stats):
    """The Rayleigh-Ritz Grams over the basis b = (V, W), W = H V, for the
    (n, 2, dim) candidates V: A = <b_k|H b_l> and B = <b_k|b_l>, as host
    complex128 (2n, 2n) arrays, and W. Each z_j = H w_j is reduced into
    column j of V^H HW and W^H HW and dropped, so 2n + 1 vectors are held at
    once; one host fetch for every product. Adds ``applies`` and
    ``host_syncs`` to ``stats``."""
    n = V.shape[0]
    W = torch.empty_like(V)
    for j in range(n):
        W[j] = kernel.apply(V[j])
    VZ, WZ = ([], []), ([], [])
    for j in range(n):
        z = kernel.apply(W[j])[None]
        for cols, X in ((VZ, V), (WZ, W)):
            re, im = gram(X, z)
            cols[0].append(re[:, 0])
            cols[1].append(im[:, 0])
        del z
    parts = [gram(V, V), gram(V, W), gram(W, V), gram(W, W),
             [torch.stack(c, dim=1) for c in VZ],
             [torch.stack(c, dim=1) for c in WZ]]
    with counting_syncs(stats):
        flat = host(torch.stack([p for pair in parts for p in pair]))
    VV, VW, WV, WW, VZ, WZ = (flat[2 * k] + 1j * flat[2 * k + 1]
                              for k in range(6))
    stats['applies'] = stats.get('applies', 0) + 2 * n
    return (np.block([[VW, VZ], [WW, WZ]]), np.block([[VV, VW], [WV, WW]]),
            W)


def _rayleigh_ritz_extract(H, states, target, nev, getvecs, stats=None):
    """Rayleigh-Ritz of H within span{v_i, H v_i} of the n candidate
    states; returns the nev eigenvalues closest to the target (and the
    vectors, with ``getvecs``).

    The basis is enriched with H v_i because the shift-invert and folded
    operators have *degenerate* wanted eigenvalues whenever the target sits
    mid-gap (the pair equidistant from it folds onto one eigenvalue), and a
    single Lanczos sequence returns only one mixed vector per degenerate
    level; H separates the mixture, so the enriched span holds both.

    The JAX package's Grams, entry for entry (:func:`_streamed_grams`).
    The candidates move into one (n, 2, dim) tensor V, each State then
    viewing its row, so their old storage is freed; with W = H V and one
    z = H w at a time, the extract holds 2n + 1 vectors (the nev
    eigenvectors it returns come on top). The reduced problem is solved on
    the host with the JAX package's canonical-orthogonalization cut.
    ``stats`` collects ``applies`` and ``host_syncs``.
    """
    if stats is None:
        stats = {}
    subspace = states[0].subspace
    n = len(states)
    V = torch.empty((n,) + tuple(states[0].data.shape),
                    dtype=states[0].data.dtype, device=states[0].data.device)
    for i, state in enumerate(states):
        V[i] = state.data
        state.data = V[i]
    A, B, W = _streamed_grams(H.get_mat(subspaces=(subspace, subspace)), V,
                              stats)

    # canonical orthogonalization: drop the near-null directions of the
    # (generally rank-deficient) enriched basis, then a standard Hermitian
    # eigenproblem in the reduced space
    s, U = np.linalg.eigh((B + B.conj().T) / 2)
    keep = s > max(1e-10 * s.max(), 0)
    T = U[:, keep] / np.sqrt(s[keep])
    A_r = T.conj().T @ ((A + A.conj().T) / 2) @ T
    theta, C_r = np.linalg.eigh((A_r + A_r.conj().T) / 2)
    C = T @ C_r

    order = np.argsort(np.abs(theta - target))[:nev]
    evals = np.asarray(theta[order], dtype=float)
    if not getvecs:
        return evals

    from .states import State
    evecs = []
    for idx in order:
        c = torch.as_tensor(C[:, idx], device=V.device)
        cr = c.real.to(V.dtype)
        ci = c.imag.to(V.dtype)
        out = State(L=H.L, subspace=subspace)
        out.data = combine(V, cr[:n], ci[:n])
        out.data += combine(W, cr[n:], ci[n:])
        out.set_initialized()
        # State.normalize, with its norm read as the solvers read
        with counting_syncs(stats):
            nrm = float(host(cvec.norm(out.data)))
        out.data = cvec.scale_real(out.data, 1.0 / nrm)
        evecs.append(out)
    return evals, evecs


def _check_keep(state, keep):
    """The validated ``keep`` as an int64 array (the JAX package's checks,
    in its order)."""
    state.assert_initialized()
    if not state.subspace.product_state_basis:
        raise ValueError('reduced density matrices currently only supported '
                         'for product state basis subspace types.')
    keep = np.asarray(keep, dtype=np.int64).reshape(-1)
    if keep.size == 0:
        return keep
    if np.any(keep[1:] <= keep[:-1]):
        raise ValueError('keep array must be strictly increasing')
    if np.any(keep < 0):
        raise ValueError(f'spin index less than zero. keep: {keep}')
    if np.any(keep >= state.L):
        raise ValueError('spin index greater than spin chain length minus '
                         f'one. keep: {keep}')
    return keep


def reduced_density_matrix(state, keep):
    """Trace out all spins except those in ``keep`` (a strictly increasing
    list of spin indices); returns the 2**len(keep) density matrix as a
    host complex128 numpy array, computed on the state's device
    (:mod:`.ops.rdm`: a permuted reshape and two GEMMs on Full/Parity, one
    GEMM per kept Hamming weight on SpinConserve)."""
    keep = _check_keep(state, keep)
    if keep.size == 0:
        return np.array([[1]], dtype=np.complex128)
    from .ops.rdm import rdm_device
    return rdm_device(state, keep)


def _spectrum(state, keep):
    """The RDM's eigenvalues, taken on the device (block by block on
    SpinConserve)."""
    keep = _check_keep(state, keep)
    if keep.size == 0:
        return np.ones(1)
    from .ops.rdm import rdm_spectrum
    return rdm_spectrum(state, keep)


def _entropy_of(w):
    """-sum w log w over the positive eigenvalues w."""
    log = np.zeros(w.shape)
    np.log(w, where=w > 0, out=log)
    return -np.sum(w * log)


def _renyi_of(w, alpha):
    """The Renyi entropy of a spectrum, for alpha other than 1."""
    if alpha == 0:
        return np.log(np.sum(w > 1e-10))
    if alpha == 'inf':
        return -np.log(np.max(w))
    return 1 / (1 - alpha) * np.log(np.sum(w ** alpha))


def entanglement_entropy(state, keep):
    """Bipartite Von Neumann entanglement entropy across the cut defined by
    ``keep``, from the RDM's spectrum on the device. Equals
    ``dm_entanglement_entropy(reduced_density_matrix(state, keep))``."""
    return _entropy_of(_spectrum(state, keep))


def dm_entanglement_entropy(dm):
    """Von Neumann entropy of a density matrix."""
    return _entropy_of(np.linalg.eigvalsh(dm))


def renyi_entropy(state, keep, alpha, method='eigsolve'):
    """Renyi entropy of the reduced density matrix on ``keep``: with
    ``method='eigsolve'`` from its spectrum on the device, with
    'matrix_power' from the host matrix."""
    if method != 'eigsolve':
        return dm_renyi_entropy(reduced_density_matrix(state, keep), alpha,
                                method)
    w = _spectrum(state, keep)
    if alpha == 1:
        return _entropy_of(w)
    return _renyi_of(w, alpha)


def dm_renyi_entropy(dm, alpha, method='eigsolve'):
    """Renyi entropy H_alpha = log(Tr rho^alpha) / (1 - alpha), with the
    alpha in {0, 1, 'inf'} limits handled."""
    if alpha == 1:
        return dm_entanglement_entropy(dm)
    if alpha in (0, 'inf'):
        return _renyi_of(np.linalg.eigvalsh(dm), alpha)

    if method == 'matrix_power':
        if alpha != int(alpha):
            raise TypeError('alpha must be an integer for matrix_power '
                            'method.')
        trace = np.trace(np.linalg.matrix_power(dm, int(alpha))).real
    elif method == 'eigsolve':
        return _renyi_of(np.linalg.eigvalsh(dm), alpha)
    else:
        raise ValueError('Valid methods are "eigsolve" and "matrix_power"')

    return 1 / (1 - alpha) * np.log(trace)


def get_tstep(ncv, nrm, tol=1e-7):
    """Length of an Expokit substep (reference: computations.py:511-519)."""
    return initial_tstep(ncv, nrm, tol)


def estimate_compute_time(t, ncv, nrm, tol=1e-7):
    """Estimated cost of an expmv solve in units of matvecs."""
    tstep = get_tstep(ncv, nrm, tol)
    return ncv * np.ceil(t / tstep)
