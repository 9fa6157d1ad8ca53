"""exp(scale * A) v by the Taylor series, for the plain reference.

The interval is cut into substeps of |scale| * bound <= MAX_STEP_NORM,
``bound`` a bound on the 2-norm of A (``pauli.one_norm_bound``); each
substep sums terms until one falls below ``tol`` of the vector's norm past
the series' peak. In float64 the sum is then exact to rounding (the
largest term is MAX_STEP_NORM**3 / 3! < 11 times the vector).
Nothing here imports the port.
"""

import math

import torch

MAX_STEP_NORM = 4.0


def expm_apply(apply, v, scale, bound, tol=1e-17):
    """exp(scale * A) v, ``apply(x)`` = A x."""
    scale = complex(scale)
    steps = max(1, math.ceil(abs(scale) * bound / MAX_STEP_NORM))
    h = scale / steps
    for _ in range(steps):
        total = v.clone()
        term = v
        v_norm = float(torch.linalg.vector_norm(v))
        k = 0
        while True:
            k += 1
            term = apply(term) * (h / k)
            total += term
            small = float(torch.linalg.vector_norm(term)) <= tol * v_norm
            if small and k > abs(h) * bound:
                break
            if k > 200:
                raise RuntimeError('Taylor series did not converge')
        v = total
    return v
