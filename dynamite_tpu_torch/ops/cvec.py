"""
Complex vector arithmetic over stacked-real tensors.

A complex vector of dimension N is stored as a real tensor of shape (2, N):
row 0 = real part, row 1 = imaginary part — the JAX package's layout, kept
so that the Krylov code ports line for line and the tests compare like with
like. Scalars come back as 0-d tensors; callers convert with ``float``.

With a process group up, each rank holds its rows of every vector, and the
reductions (:func:`vdot`, :func:`rdot`, :func:`norm_squared`, :func:`norm`)
take this rank's part, then sum over ranks in one device all-reduce.
"""

import numpy as np
import torch

from ..parallel import multihost


def vdot(x, y):
    """<x|y> with x conjugated. Returns (re, im) 0-d tensors."""
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    re = torch.dot(xr, yr) + torch.dot(xi, yi)
    im = torch.dot(xr, yi) - torch.dot(xi, yr)
    if multihost.world_size() > 1:
        re, im = multihost.allreduce_sum_(torch.stack([re, im]))
    return re, im


def rdot(x, y):
    """sum(x * y) over both planes: the real inner product of the planes as
    one real vector (the real part of <x|y>). A 0-d tensor."""
    return multihost.allreduce_sum_(torch.dot(x.reshape(-1), y.reshape(-1)))


def norm_squared(x):
    return multihost.allreduce_sum_(torch.sum(x * x))


def norm(x):
    if multihost.world_size() == 1:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(norm_squared(x))


def scale_real(x, a):
    return x * a


def scale_complex(x, ar, ai):
    xr, xi = x[0], x[1]
    return torch.stack([ar * xr - ai * xi, ar * xi + ai * xr])


def axpby(ar, ai, x, br, bi, y):
    """alpha*x + beta*y with complex scalars alpha=(ar,ai), beta=(br,bi)."""
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return torch.stack([ar * xr - ai * xi + br * yr - bi * yi,
                        ar * xi + ai * xr + br * yi + bi * yr])


def add(x, y):
    return x + y


def sub(x, y):
    return x - y


def shift(x, cr, ci):
    """Add the complex scalar (cr, ci) to every element."""
    out = x.clone()
    out[0] += cr
    out[1] += ci
    return out


def mul_elementwise(x, y):
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return torch.stack([xr * yr - xi * yi, xr * yi + xi * yr])


def mask_rows(x, keep):
    """Zero the elements where ``keep`` is 0 (real mask broadcast over
    re/im)."""
    return x * keep[None, :].to(x.dtype)


def from_numpy(vec, dtype):
    """Host complex array -> (2, N) stacked real numpy array."""
    vec = np.asarray(vec)
    return np.stack([vec.real, vec.imag]).astype(dtype)
