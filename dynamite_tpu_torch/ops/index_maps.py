"""
Device-side subspace index maps over int64 tensors (the JAX package's
``ops/index_maps.py``, Full and Parity only).

Each map is a small host object with

* ``i2s(idx)``   — product state for each index (indices assumed valid)
* ``s2i(state)`` — (index, valid) pair; index is garbage where ~valid

built from the host-side Subspace objects via :func:`device_map`.
"""

import torch


def parity(x):
    """Parity (popcount mod 2) of each int64 element. torch has no popcount,
    so this is the xor-fold of the 64-bit word."""
    for shift in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


class FullMap:
    def __init__(self, L):
        self.L = L

    def i2s(self, idx):
        return idx

    def s2i(self, state):
        return state, torch.ones(state.shape, dtype=torch.bool,
                                 device=state.device)


class ParityMap:
    def __init__(self, L, space):
        self.L = L
        self.space = space

    def i2s(self, idx):
        return (idx << 1) | (parity(idx) ^ self.space)

    def s2i(self, state):
        return state >> 1, parity(state) == self.space


def device_map(subspace):
    """Build the device index map for a host Subspace object."""
    from .. import subspaces as sp

    if isinstance(subspace, sp.Full):
        return FullMap(subspace.L)
    if isinstance(subspace, sp.Parity):
        return ParityMap(subspace.L, subspace.space)
    raise NotImplementedError(
        f'no device map for subspace type {type(subspace).__name__} '
        '(ROADMAP.md queue 1)')
