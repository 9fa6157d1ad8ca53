"""
Thick-restart Lanczos eigensolver (the Hermitian specialization of
Krylov-Schur) — the reimplementation of SLEPc's EPS used by the reference
(reference call site: computations.py:128-292).

Host code orchestrates restarts; each restart cycle runs the Lanczos steps on
the device (see solvers.krylov). The projected problem (a small real
symmetric arrowhead+tridiagonal matrix) is solved on the host with numpy.
"""

import numpy as np
import torch

from ..ops import draw
from ..parallel import mesh
from . import krylov
from .expmv import MaxIterationsError


def random_start(dim, dtype, device, seed=0):
    """Normalized random start vector: this rank's (2, local_dim) rows of a
    space of dimension ``dim``, each row drawn from (seed, row) alone
    (:func:`..ops.draw.normal_rows`) and normalized over all ranks, its pad
    rows 0 (``parallel.mesh``). The vector is the same at any world size."""
    w = draw.normal_rows(seed, dim, dtype, device)
    return w / krylov.norm(w)


def eigsolve_trlanczos(kops, dim, dtype, device, nev=1, which='lowest',
                       tol=None, max_restarts=None, seed=0, v0=None,
                       stats=None, tol_scale=None):
    """Solve for ``nev`` eigenvalues of the Hermitian operator.

    Parameters
    ----------
    kops : KrylovOps
        Krylov building blocks (m = ncv).
    dim : int
        The space dimension.
    dtype : torch.dtype
        Real dtype of the state representation.
    device : torch.device
    nev : int
        Number of eigenpairs wanted.
    which : str
        'lowest' | 'highest' | 'exterior' (largest magnitude).
    tol : float, optional
        Residual tolerance relative to the eigenvalue scale.
    max_restarts : int, optional
    v0 : (2, dim) array or tensor, optional
        Start vector (normalized here); a seeded random one by default.
        With a process group up, each rank takes its rows of it.

    Returns
    -------
    (evals, eigvec_coeffs, V) where evals is (nconv,) float64 and
    eigvec_coeffs @ V gives the eigenvectors; use :func:`ritz_vectors`.
    """
    m = kops.m
    if nev >= m:
        raise ValueError(f'ncv ({m}) must be larger than nev ({nev})')
    if tol is None:
        tol = 1e-9 if dtype == torch.float64 else 1e-6
    if max_restarts is None:
        max_restarts = 1000

    if v0 is None:
        v0 = random_start(dim, dtype, device, seed=seed)
    else:
        if not isinstance(v0, torch.Tensor):
            v0 = torch.from_numpy(np.array(v0))
        v0 = mesh.local_rows(v0, dim).to(device=device, dtype=dtype)
        v0 = v0 / krylov.norm(v0)

    if stats is None:
        stats = {}
    stats.update(restarts=0, matvecs=0, host_syncs=0, verify_cycles=0)

    # number of Ritz pairs retained through a restart
    p = min(m - 1, max(nev + 5, (m + nev) // 2))

    V, alpha, beta = kops.lanczos(v0)
    stats['matvecs'] += m
    alpha_h = krylov.host(alpha)
    beta_h = krylov.host(beta)

    # projected matrix: tridiagonal on the first cycle
    M = _tridiag(alpha_h, beta_h)
    beta_res = beta_h[m - 1]

    # A single-vector Krylov space sees exactly one direction of each
    # degenerate eigenspace, so converged[:nev] alone cannot certify
    # multiplicities. Once the wanted pairs converge we therefore run
    # *verification cycles*: restart keeping only the converged (locked)
    # Ritz vectors, inject a fresh random direction orthogonal to them, and
    # iterate again. Any missed copy has O(1) overlap with the injected
    # vector and surfaces immediately; we return only when the spectrum is
    # stable under injection (the role SLEPc's Krylov-Schur locking plays
    # for the reference).
    verified_vals = None

    for restart in range(max_restarts):
        theta, S = np.linalg.eigh(M)
        order = _ordering(theta, which)
        theta = theta[order]
        S = S[:, order]

        # residual estimate per Ritz pair: |beta_m * (last component)|
        resid = np.abs(beta_res * S[m - 1, :])
        # convergence is relative to the eigenvalue, floored at tol_scale
        scale = np.maximum(np.abs(theta),
                           tol_scale if tol_scale is not None else 1e-30)
        converged = resid <= tol * scale
        # the largest relative residual estimate of the wanted pairs at the
        # last check (what a solve that runs out of restarts leaves)
        stats['residual_estimate'] = float(np.max(resid[:nev] / scale[:nev]))

        if np.all(converged[:nev]):
            nconv = nev
            while nconv < m and converged[nconv]:
                nconv += 1
            cur = theta[:nev].copy()
            vtol = 10 * tol * np.maximum(
                np.abs(cur), tol_scale if tol_scale is not None else 1e-30)
            if verified_vals is not None and \
                    np.all(np.abs(cur - verified_vals) <= vtol):
                stats['nconv'] = nconv
                return theta[:nconv], S[:, :nconv], V

            # ---- verification restart: lock converged pairs, inject a
            # fresh random direction ----
            verified_vals = cur
            p_v = min(nconv, m - 2)
            C = np.zeros((m + 1, m + 1))
            C[:p_v, :m] = S[:, :p_v].T
            V = krylov.recombine_basis(
                V, torch.as_tensor(C, dtype=dtype, device=device))
            w = random_start(dim, dtype, device,
                             seed=seed + 7919 * (stats['verify_cycles'] + 1))
            V[p_v] = krylov.orthonormalize_against(V[:p_v], w)

            V, alpha, beta = kops.lanczos_restarted(V, p_v)
            alpha_h = krylov.host(alpha)
            beta_h = krylov.host(beta)
            stats['verify_cycles'] += 1
            stats['matvecs'] += m - p_v
            stats['host_syncs'] += 2

            # locked pairs are eigen-directions up to tol: their coupling
            # to the injected direction is below the convergence floor, so
            # the projected matrix is block diagonal(theta_locked) (+)
            # tridiagonal(active)
            M = np.zeros((m, m))
            M[:p_v, :p_v] = np.diag(theta[:p_v])
            for j in range(p_v, m):
                M[j, j] = alpha_h[j]
            for j in range(p_v, m - 1):
                M[j, j + 1] = beta_h[j]
                M[j + 1, j] = beta_h[j]
            beta_res = beta_h[m - 1]
            continue

        # ---- thick restart ----
        C = np.zeros((m + 1, m + 1))
        C[:p, :m] = S[:, :p].T           # retained Ritz vectors
        C[p, m] = 1.0                    # the residual direction v_m
        V = krylov.recombine_basis(
            V, torch.as_tensor(C, dtype=dtype, device=device))

        V, alpha, beta = kops.lanczos_restarted(V, p)
        alpha_h = krylov.host(alpha)
        beta_h = krylov.host(beta)
        stats['restarts'] += 1
        stats['matvecs'] += m - p
        stats['host_syncs'] += 2  # recombine upload + alpha/beta fetch

        M = np.zeros((m, m))
        M[:p, :p] = np.diag(theta[:p])
        spike = beta_res * S[m - 1, :p]
        M[:p, p] = spike
        M[p, :p] = spike
        for j in range(p, m):
            M[j, j] = alpha_h[j]
        for j in range(p, m - 1):
            M[j, j + 1] = beta_h[j]
            M[j + 1, j] = beta_h[j]
        beta_res = beta_h[m - 1]

    raise MaxIterationsError(
        'eigensolver reached maximum number of restarts without converging. '
        'Try increasing max_its, ncv, or loosening tol '
        f'(current tol: {tol})')


def ritz_vectors(S, V):
    """Assemble Ritz vectors sum_k S[k, i] V[k] on the device; returns a
    list of (2, dim) tensors."""
    C = torch.zeros((S.shape[1], V.shape[0]), dtype=V.dtype, device=V.device)
    C[:, :S.shape[0]] = torch.as_tensor(S.T, dtype=V.dtype, device=V.device)
    return list(krylov.recombine_basis(V, C))


def _tridiag(alpha, beta):
    m = len(alpha)
    M = np.diag(alpha)
    for j in range(m - 1):
        M[j, j + 1] = beta[j]
        M[j + 1, j] = beta[j]
    return M


def _ordering(theta, which):
    if which == 'lowest':
        return np.argsort(theta)
    if which == 'highest':
        return np.argsort(-theta)
    if which == 'exterior':
        return np.argsort(-np.abs(theta))
    raise ValueError(f"invalid value for 'which': {which}")
