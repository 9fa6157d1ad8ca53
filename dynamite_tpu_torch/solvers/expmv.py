"""
Krylov matrix exponential: y = exp(scale * A) v for Hermitian matrix-free A
and complex ``scale`` (-i*t for real time evolution, real for imaginary
time).

Expokit-style algorithm (the reference delegates this to SLEPc MFN with type
'expokit'; reference: computations.py:89-112, step heuristic
computations.py:511-528): substeps of adaptively-chosen length, each one a
Lanczos factorization (device) followed by a small dense expm of the
augmented tridiagonal projection (host scipy) and a basis combine (device).
Local error is estimated from the augmented-matrix trick of Expokit
(Sidje 1998), controlling the substep size.
"""

import numpy as np
import scipy.linalg
import torch

from . import krylov


class ConvergenceError(Exception):
    pass


class MaxIterationsError(ConvergenceError):
    pass


def initial_tstep(ncv, anorm, tol):
    """A-priori substep length (same heuristic the reference exposes as
    computations.get_tstep)."""
    anorm = max(anorm, 1e-300)
    f = ((ncv + 1) / 2.72) ** (ncv + 1) * np.sqrt(2 * np.pi * (ncv + 1))
    t = ((1 / anorm) * (f * tol) / (4.0 * anorm)) ** (1 / ncv)
    s = 10.0 ** (np.floor(np.log10(t)) - 1)
    return np.ceil(t / s) * s


def expmv(kops, v, scale, anorm, ncv=30, tol=1e-7, max_its=None,
          stats=None):
    """Compute exp(scale * A) @ v.

    Parameters
    ----------
    kops : solvers.krylov.KrylovOps
        Krylov building blocks for the Hermitian operator
        (``OperatorKernel.krylov_ops(ncv)``).
    v : (2, dim) tensor
    scale : complex
        The exponent scale (e.g. -1j*t).
    anorm : float
        An estimate (upper bound is fine) of ||A||, used for stepping.
    ncv : int
        Krylov subspace dimension per substep.
    tol : float
        Requested local error tolerance (per unit time, Expokit-style).
    max_its : int, optional
        Maximum number of substeps.
    stats : dict, optional
        Filled with solver counters: substeps, rejected_steps, matvecs,
        host_syncs (ONE per substep: the input norm, the tridiagonal
        coefficients and the residual-direction norm come back together).

    Returns
    -------
    (2, dim) tensor
    """
    scale = complex(scale)
    t_total = abs(scale)
    if t_total == 0:
        return v
    direction = scale / t_total

    if tol is None:
        tol = 1e-7
    if max_its is None:
        max_its = 100000

    m = kops.m
    gamma = 0.9
    delta = 1.2
    max_growth = 5.0

    t_step = min(t_total, initial_tstep(m, max(anorm, 1e-16), tol))

    if stats is None:
        stats = {}
    stats.update(substeps=0, rejected_steps=0, matvecs=0, host_syncs=0)

    w = v
    t_now = 0.0
    n_steps = 0
    rndoff = anorm * np.finfo(np.float64).eps

    while t_now < t_total:
        if n_steps >= max_its:
            raise MaxIterationsError(
                'expmv reached the maximum number of substeps without '
                'completing; try increasing max_its or ncv')
        n_steps += 1

        tau = min(t_total - t_now, t_step)

        V, host = kops.lanczos_step(w)
        alpha_h, beta_h = host[:m], host[m:2 * m]
        beta, avnorm = float(host[2 * m]), float(host[2 * m + 1])
        stats['host_syncs'] += 1
        stats['matvecs'] += m + 1
        if beta == 0:
            return w

        # detect happy breakdown: the Krylov space closed early
        tiny = max(1e-14 * max(anorm, 1.0), 1e-300)
        breakdown = np.nonzero(beta_h[:m - 1] < tiny)[0]
        k_eff = int(breakdown[0]) + 1 if breakdown.size else m
        happy = breakdown.size > 0

        # inner adaptive loop: shrink tau until the local error passes
        while True:
            T_aug = _augmented_matrix(alpha_h, beta_h, k_eff, happy)
            F = scipy.linalg.expm(direction * tau * T_aug)

            if happy:
                err_loc = tiny
                mx = k_eff
            else:
                err1 = abs(beta * F[m, 0])
                err2 = abs(beta * F[m + 1, 0]) * avnorm
                if err1 > 10 * err2:
                    err_loc = err2
                elif err1 > err2:
                    err_loc = err1 * err2 / (err1 - err2)
                else:
                    err_loc = err1
                err_loc = max(err_loc, rndoff)
                mx = m + 1

            if err_loc <= delta * tau * tol:
                break
            stats['rejected_steps'] += 1
            tau_new = gamma * tau * (tau * tol / err_loc) ** (1 / m)
            if not np.isfinite(tau_new) or tau_new >= tau:
                tau_new = tau / 2
            tau = tau_new
            if tau < 1e-14 * t_total:
                raise ConvergenceError('expmv substep underflow; the '
                                       'operator norm may be inaccurate')

        coeffs = np.zeros(m + 1, dtype=np.complex128)
        coeffs[:mx] = beta * F[:mx, 0]
        cr = torch.as_tensor(coeffs.real, dtype=v.dtype, device=v.device)
        ci = torch.as_tensor(coeffs.imag, dtype=v.dtype, device=v.device)
        w = krylov.combine(V, cr, ci)

        t_now += tau
        stats['substeps'] += 1
        if not happy:
            t_step = gamma * tau * (tau * tol / err_loc) ** (1 / m)
            t_step = min(t_step, max_growth * tau)

    return w


def _augmented_matrix(alpha, beta, k_eff, happy):
    """The (m+2)x(m+2) Expokit augmented matrix: the tridiagonal projection
    plus two phi-function columns for local error estimation."""
    m = len(alpha)
    T = np.zeros((m + 2, m + 2), dtype=np.float64)
    k = k_eff if happy else m
    for j in range(k):
        T[j, j] = alpha[j]
    for j in range(k - 1):
        T[j, j + 1] = beta[j]
        T[j + 1, j] = beta[j]
    if not happy:
        T[m, m - 1] = beta[m - 1]
        T[m + 1, m] = 1.0
    return T
