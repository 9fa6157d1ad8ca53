"""The lowest and highest eigenvalues of a Hermitian operator by Lanczos
with full reorthogonalization, for the plain reference.

No restart: the basis grows in blocks until the wanted Ritz values at both
ends have residual estimates |beta_k s_k| below ``tol`` of their size (at
least 1), which puts each eigenvalue within about tol**2 / gap of the
truth. Nothing here imports the port.
"""

import numpy as np
import torch

BLOCK = 128


def extremal_eigenvalues(apply, dim, nev, dtype, device, seed=0, tol=1e-11,
                         max_steps=3000, check_every=10):
    """(lowest nev ascending, highest nev descending) as float64 arrays."""
    gen = torch.Generator(device=device).manual_seed(seed)
    real = dtype if not dtype.is_complex else (
        torch.float64 if dtype == torch.complex128 else torch.float32)
    v = torch.randn(dim, generator=gen, dtype=real, device=device)
    if dtype.is_complex:
        v = torch.complex(v, torch.randn(dim, generator=gen, dtype=real,
                                         device=device))
    v /= torch.linalg.vector_norm(v)
    blocks = []
    alpha, beta = [], []

    def basis_rows(n):
        out, left = [], n
        for b in blocks:
            out.append(b[:min(left, BLOCK)])
            left -= BLOCK
            if left <= 0:
                break
        return out

    def store(j, w):
        if j % BLOCK == 0:
            blocks.append(torch.empty((BLOCK, dim), dtype=dtype,
                                      device=device))
        blocks[j // BLOCK][j % BLOCK] = w

    store(0, v)
    steps = min(max_steps, dim)
    for j in range(steps):
        w = apply(blocks[j // BLOCK][j % BLOCK])
        # two passes of classical Gram-Schmidt against every basis row; the
        # first pass's coefficient on v_j is alpha_j = <v_j | A v_j>
        for sweep in range(2):
            for i, rows in enumerate(basis_rows(j + 1)):
                c = rows.conj() @ w
                w = w - c @ rows
                if sweep == 0 and i == j // BLOCK:
                    alpha.append(float(c[j % BLOCK].real))
        b = float(torch.linalg.vector_norm(w))
        beta.append(b)
        done = j + 1 == steps or b == 0
        if not done and (j + 1) % check_every == 0 and j + 1 >= 2 * nev:
            done = _converged(alpha, beta, nev, tol)
        if done:
            break
        store(j + 1, w / b)
    theta = np.linalg.eigvalsh(_tridiagonal(alpha, beta))
    return theta[:nev].copy(), theta[::-1][:nev].copy()


def _tridiagonal(alpha, beta):
    k = len(alpha)
    T = np.diag(np.asarray(alpha, dtype=np.float64))
    for i in range(k - 1):
        T[i, i + 1] = T[i + 1, i] = beta[i]
    return T


def _converged(alpha, beta, nev, tol):
    theta, S = np.linalg.eigh(_tridiagonal(alpha, beta))
    resid = np.abs(beta[-1] * S[-1, :])
    scale = np.maximum(np.abs(theta), 1.0)
    ok = resid <= tol * scale
    return bool(np.all(ok[:nev]) and np.all(ok[-nev:]))
