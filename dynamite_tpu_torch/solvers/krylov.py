"""
Lanczos factorization — the shared core of both the eigensolver and the
Krylov exponential.

Builds V_{m+1}, alpha_{1..m}, beta_{1..m} with

    A V_m = V_m T_m + beta_m v_{m+1} e_m^T

for a Hermitian matrix-free ``matvec``, with full (two-pass classical
Gram-Schmidt) reorthogonalization — the numerical strategy needed to match
SLEPc's Krylov accuracy (reference north star: eigenvalues to 1e-10).

The Krylov basis lives on the device as a (m+1, 2, dim) stacked-real tensor.
Inner products against the active basis rows are one skinny matmul, and so
is the combine; they run in full precision (TF32 is off, see
``_Config._initialize``). alpha/beta stay on the device until the whole
factorization is done, so a factorization costs one host sync.
"""

import torch


def workspace_bytes(dim, ncv, real_bytes):
    """Bytes the Lanczos iteration keeps resident: the (ncv+1, 2, dim)
    basis plus two work vectors."""
    return (ncv + 3) * 2 * dim * real_bytes


def check_workspace_fits(dim, ncv, device, dtype, context):
    """Warn when the Krylov basis will not fit in the free device memory,
    with the ncv-vs-memory tradeoff spelled out."""
    if device.type != 'cuda':
        return
    free, _total = torch.cuda.mem_get_info(device)
    need = workspace_bytes(dim, ncv, torch.empty((), dtype=dtype)
                           .element_size())
    if need > 0.9 * free:
        import warnings
        warnings.warn(
            f'{context}: the ncv={ncv} Krylov basis needs '
            f'{need / 1e9:.1f} GB but only {free / 1e9:.1f} GB of device '
            'memory is free — reduce ncv (more, shorter restarts)',
            RuntimeWarning, stacklevel=3)


def _basis_dots(V, w):
    """Complex inner products <V_k | w> for every row k of V.
    V: (n, 2, dim); w: (2, dim). Returns (re, im) of shape (n,)."""
    n = V.shape[0]
    D = (V.reshape(n * 2, V.shape[-1]) @ w.T).reshape(n, 2, 2)
    re = D[:, 0, 0] + D[:, 1, 1]
    im = D[:, 0, 1] - D[:, 1, 0]
    return re, im


def combine(V, cr, ci):
    """sum_k (cr_k + i ci_k) V_k over the rows of V. Returns (2, dim)."""
    n = V.shape[0]
    C = torch.stack([torch.stack([cr, -ci], dim=1),
                     torch.stack([ci, cr], dim=1)]).reshape(2, n * 2)
    return C @ V.reshape(n * 2, V.shape[-1])


def _orthogonalize(V, w):
    """One pass of classical Gram-Schmidt of w against the rows of V.
    Returns (w_orth, (re, im) coefficients)."""
    re, im = _basis_dots(V, w)
    return w - combine(V, re, im), (re, im)


def norm(w):
    return torch.linalg.vector_norm(w)


def _normalized(w):
    n = norm(w)
    return w / torch.where(n > 0, n, torch.ones_like(n))


def lanczos_restarted(matvec, V, n_locked, m):
    """Continue a Lanczos factorization after a thick restart.

    V: (m+1, 2, dim) whose rows 0..n_locked hold the retained Ritz vectors
    plus the residual direction at row n_locked; it is filled in place.
    Runs steps n_locked..m-1, orthogonalizing against everything retained.

    Returns (V, alpha, beta) with alpha/beta of shape (m,), only valid in
    [n_locked, m); beta[m-1] is the residual norm.
    """
    alpha = torch.zeros(m, dtype=V.dtype, device=V.device)
    beta = torch.zeros(m, dtype=V.dtype, device=V.device)
    for j in range(n_locked, m):
        w = matvec(V[j])
        # two-pass CGS against the active basis {v_0..v_j}: the first pass
        # extracts alpha_j (the <v_j|w> component is real for a Hermitian
        # matvec), the second cleans up roundoff
        active = V[:j + 1]
        w, (re1, _) = _orthogonalize(active, w)
        w, _ = _orthogonalize(active, w)
        b_j = norm(w)
        V[j + 1] = w / torch.where(b_j > 0, b_j, torch.ones_like(b_j))
        alpha[j] = re1[j]
        beta[j] = b_j
    return V, alpha, beta


def lanczos(matvec, v0, m):
    """Run m Lanczos steps from the normalized start vector v0 (2, dim).

    Returns
    -------
    V : (m+1, 2, dim)  — orthonormal Krylov basis
    alpha : (m,)       — tridiagonal diagonal
    beta : (m,)        — tridiagonal off-diagonal; beta[m-1] is the residual
                         norm (A V relation above)
    """
    V = torch.zeros((m + 1,) + tuple(v0.shape), dtype=v0.dtype,
                    device=v0.device)
    V[0] = v0
    return lanczos_restarted(matvec, V, 0, m)


def recombine_basis(V, C):
    """New basis rows Y_p = sum_k C[p, k] V[k] (real coefficients, e.g. the
    eigenvectors of the tridiagonal projection in a thick restart)."""
    n = V.shape[0]
    return (C @ V.reshape(n, -1)).reshape(C.shape[0], *V.shape[1:])


def orthonormalize_against(V, w):
    """Two-pass Gram-Schmidt of w against the rows of V, then normalize —
    used to inject a fresh random direction into a restart
    (degenerate-spectrum verification, solvers/eigs.py)."""
    w, _ = _orthogonalize(V, w)
    w, _ = _orthogonalize(V, w)
    return _normalized(w)


def lanczos_step(matvec, w, m):
    """One expmv substep worth of device work: normalize w, run the m-step
    Lanczos factorization, and compute ||A v_m|| for the Expokit
    second-order error term. Returns (V, coeffs) with coeffs the host
    float64 array [alpha (m), beta (m), ||w||, ||A v_m||] — one device sync
    per substep."""
    beta0 = norm(w)
    V, alpha, beta = lanczos(matvec, _normalized(w), m)
    avnorm = norm(matvec(V[m]))
    coeffs = torch.cat([alpha, beta, beta0[None], avnorm[None]])
    return V, host(coeffs)


class KrylovOps:
    """Krylov building blocks bound to one matvec and one subspace
    dimension m (cached on the OperatorKernel)."""

    def __init__(self, matvec, m):
        self.m = m
        self.matvec = matvec

    def lanczos(self, v):
        return lanczos(self.matvec, v, self.m)

    def lanczos_restarted(self, V, p):
        return lanczos_restarted(self.matvec, V, p, self.m)

    def lanczos_step(self, w):
        return lanczos_step(self.matvec, w, self.m)


def host(t):
    """A device tensor as a float64 numpy array (one device sync)."""
    return t.to('cpu', torch.float64).numpy()
