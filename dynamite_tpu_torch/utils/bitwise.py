"""
Vectorized integer bit-manipulation helpers used throughout the package.

These operate on numpy arrays (host side) of any integer dtype. Device-side
(torch) equivalents live in :mod:`dynamite_tpu_torch.ops.index_maps`.

Reference semantics: dynamite, src/dynamite/bitwise.py
"""

import numpy as np


def popcount(x):
    """Number of set bits of each element of ``x`` (any integer dtype)."""
    x = np.asarray(x)
    if x.dtype == np.uint64 or x.itemsize == 8:
        ux = x.astype(np.uint64)
    else:
        ux = x.astype(np.uint32)
    count = np.zeros(ux.shape, dtype=np.int64)
    while np.any(ux):
        count += (ux & 1).astype(np.int64)
        ux >>= 1
    return count if count.shape else int(count)


def parity(x):
    """Parity (popcount mod 2) of each element of ``x``.

    Vectorized xor-fold; returns the same shape as the input.
    """
    x = np.asarray(x).copy()
    nbits = 8 * x.itemsize
    shift = 1
    while shift < nbits:
        x ^= x >> shift
        shift *= 2
    return x & 1


def intlog2(x):
    """floor(log2(x)) elementwise, with intlog2(0) == -1."""
    x = np.asarray(x).copy()
    out = np.full(x.shape, -1, dtype=np.int64)
    while np.any(x):
        out[x != 0] += 1
        x >>= 1
    if out.shape:
        return out
    return int(out)


def trailing_zeros(x):
    """Number of trailing zero bits; undefined (returns bit width) for 0."""
    x = np.asarray(x)
    return popcount((x & -x) - 1)
