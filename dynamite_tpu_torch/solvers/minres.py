"""
MINRES for shifted Hermitian systems (A - sigma) x = b — the inner solve of
the shift-invert ``target=`` eigensolver (the JAX package's
``solvers/minres.py``).

A Hermitian complex operator on the (2, dim) stacked-real planes is a real
symmetric operator on the planes viewed as one real vector of length
2*dim, so the classical real MINRES recurrence (Paige & Saunders 1975)
applies with plain elementwise inner products.

The vectors stay on the device. The recurrence's scalars live on the host,
in the working dtype (numpy scalars, as the JAX loop carries them in the
array dtype): each iteration reads its two reductions, alpha and ||y||^2,
in one host sync, then runs the Givens step and the JAX loop's exit test
(itn < maxiter, phibar > rtol*beta1, beta > eps*beta1) on the host before
the next iteration. So the loop stops at the iteration the JAX
``lax.while_loop`` stops at, and nothing past the exit touches x (a
breakdown, beta <= eps * beta1, ends the loop before ``r2 / beta`` is
formed). With a process group up, the reductions are summed over ranks, so
every rank takes the same decisions.
"""

import numpy as np
import torch

from ..ops import cvec
from .krylov import host


def minres_solver(matvec, shift=0.0, maxiter=None, rtol=None, stats=None):
    """Build ``solve(b) ~= (A - shift)^{-1} b``.

    Parameters
    ----------
    matvec : callable
        (2, dim) -> new (2, dim) Hermitian apply (each rank's rows under a
        process group).
    shift : float
        The real shift sigma.
    maxiter : int, optional
        Iteration cap (the loop exits earlier once the residual test
        passes). Default 300.
    rtol : float, optional
        Relative residual target ||b - (A-sigma)x|| <= rtol * ||b||, on the
        recurrence's estimate. Default 1e-10.
    stats : dict, optional
        Accumulates over the solves: ``solves``; ``iterations`` (one matvec
        each) and ``max_iterations`` (of one solve); ``host_syncs``;
        ``max_rel_residual``, the largest phibar / beta1 at a solve's exit;
        ``unconverged``, the solves that exited with the residual test
        unmet (phibar > rtol * beta1: at the cap, or on a breakdown).

    Each solve also adds its iterations to ``minres_solver.iterations``.

    Returns
    -------
    callable mapping a (2, dim) tensor to a new one.
    """
    if maxiter is None:
        maxiter = 300
    if rtol is None:
        rtol = 1e-10
    if stats is None:
        stats = {}
    for key in ('solves', 'iterations', 'max_iterations', 'host_syncs',
                'unconverged'):
        stats.setdefault(key, 0)
    stats.setdefault('max_rel_residual', 0.0)

    def solve(b):
        real = np.float64 if b.dtype == torch.float64 else np.float32
        sigma = float(real(shift))
        eps = np.finfo(real).eps
        zero = real(0)

        beta1 = np.sqrt(real(host(cvec.rdot(b, b))))
        x = torch.zeros_like(b)
        r1 = r2 = b
        w = torch.zeros_like(b)
        w2 = torch.zeros_like(b)
        itn, beta, oldb = 0, beta1, zero
        dbar, eps_k, phibar, cs, sn = zero, zero, beta1, real(-1), zero
        syncs = 1
        while (itn < maxiter and phibar > real(rtol) * beta1
               and beta > eps * beta1):
            # Lanczos step on the shifted operator
            v = r2 / float(beta)
            y = matvec(v)
            if sigma:
                y.sub_(v, alpha=sigma)
            if itn >= 1:
                y.sub_(r1, alpha=float(beta / (oldb if oldb > 0 else 1)))
            alfa = cvec.rdot(v, y)
            y.addcmul_(r2, alfa / float(beta), value=-1)
            alfa, beta_sq = host(torch.stack([alfa, cvec.rdot(y, y)]))
            syncs += 1
            alfa = real(alfa)
            beta_next = np.sqrt(real(beta_sq))

            # fold the new tridiagonal column through the previous Givens
            # rotation, then compute the next one
            oldeps = eps_k
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            eps_k = sn * beta_next
            dbar = -cs * beta_next
            gamma = np.sqrt(gbar * gbar + beta_next * beta_next)
            gamma = np.maximum(gamma, eps * np.maximum(beta1, real(1)))
            cs = gbar / gamma
            sn = beta_next / gamma
            phi = cs * phibar
            phibar = sn * phibar

            # search-direction and solution updates
            w_next = torch.add(v, w2, alpha=-float(oldeps))
            w_next.sub_(w, alpha=float(delta)).div_(float(gamma))
            x.add_(w_next, alpha=float(phi))

            itn += 1
            r1, r2 = r2, y
            w2, w = w, w_next
            oldb, beta = beta, beta_next
        minres_solver.iterations += itn
        stats['solves'] += 1
        stats['iterations'] += itn
        stats['max_iterations'] = max(stats['max_iterations'], itn)
        stats['host_syncs'] += syncs
        stats['unconverged'] += int(phibar > real(rtol) * beta1)
        if beta1 > 0:
            stats['max_rel_residual'] = max(stats['max_rel_residual'],
                                            float(phibar / beta1))
        return x

    return solve


minres_solver.iterations = 0
