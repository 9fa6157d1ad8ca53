"""
Device-side subspace index maps over int64 tensors (the JAX package's
``ops/index_maps.py``: Full, Parity, SpinConserve and Explicit/Auto; XParity
resolves to its parent's map).

Each map is a small host object with

* ``i2s(idx)``   — product state for each index (indices assumed valid)
* ``s2i(state)`` — (index, valid) pair; index is garbage where ~valid

built from the host-side Subspace objects via :func:`device_map`.
"""

import numpy as np
import torch

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def parity(x):
    """Parity (popcount mod 2) of each int64 element. torch has no popcount,
    so this is the xor-fold of the 64-bit word."""
    for shift in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def popcount(x):
    """Set bits of each nonnegative int64 element: the SWAR byte counts,
    summed by shifts (no multiply, so nothing overflows)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


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


class SpinConserveMap:
    """Sector-major (un)ranking of fixed-popcount bitstrings (see
    ops/sectors.py): index = sector offset + rank(high rest) * na +
    rank(low half). The two half-rank loops run over the bits, with the
    binomial table and the layout's per-sector arrays as small int64
    tensors, kept per device."""

    def __init__(self, L, k, nchoosek):
        from .sectors import layout
        self.L = L
        self.k = k
        self.nchoosek = np.asarray(nchoosek)  # [kk, n] = C(n, kk)
        self.lay = layout(L, k)
        self._tables = {}

    def _on(self, device):
        """The lookup tables as int64 tensors on ``device`` (cached)."""
        if device not in self._tables:
            lay = self.lay
            self._tables[device] = {
                name: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                      device=device)
                for name, a in (('flat', self.nchoosek.reshape(-1)),
                                ('off', lay.off), ('na', lay.na),
                                ('kr', lay.kr), ('ka', lay.ka),
                                ('t', lay.t), ('off_tk', lay.off_tk),
                                ('na_tk', lay.na_tk))}
        return self._tables[device]

    def _rank(self, x, nbits, flat):
        """Value-order combinatorial rank over one half."""
        ld = self.nchoosek.shape[1]
        idx = torch.zeros_like(x)
        kk = torch.zeros_like(x)
        for n in range(nbits):
            bit = (x >> n) & 1
            kk = kk + bit
            idx = idx + bit * flat[kk.clamp(0, self.k) * ld + n]
        return idx

    def _unrank(self, idx, k, nbits, flat):
        """Inverse of :meth:`_rank`; ``k`` is a per-element popcount."""
        ld = self.nchoosek.shape[1]
        state = torch.zeros_like(idx)
        for n in range(nbits, 0, -1):
            state = state << 1
            current = torch.where(k > n - 1, 0,
                                  flat[k.clamp(0, self.k) * ld + (n - 1)])
            take = (idx >= current).to(idx.dtype)
            idx = idx - take * current
            k = k - take
            state = state | take
        return state

    def i2s(self, idx):
        tb = self._on(idx.device)
        lay = self.lay
        sec = torch.searchsorted(tb['off'], idx, right=True) - 1
        rem = idx - tb['off'][sec]
        na = tb['na'][sec]
        rb = rem // na
        ra = rem - rb * na
        hr = self._unrank(rb, tb['kr'][sec], lay.Lr, tb['flat'])
        sa = self._unrank(ra, tb['ka'][sec], lay.La, tb['flat'])
        return (tb['t'][sec] << (self.L - 1)) | (hr << lay.La) | sa

    def s2i(self, state):
        tb = self._on(state.device)
        lay = self.lay
        t = (state >> (self.L - 1)) & 1
        hr = (state >> lay.La) & ((1 << lay.Lr) - 1)
        sa = state & ((1 << lay.La) - 1)
        kr = popcount(hr)
        valid = (t + kr + popcount(sa)) == self.k
        # kr <= Lr, so the slot stays inside the (t, kr) tables even where
        # the state is invalid (t = 1 with any kr)
        slot = t * (lay.Lr + 1) + kr
        rb = self._rank(hr, lay.Lr, tb['flat'])
        ra = self._rank(sa, lay.La, tb['flat'])
        return tb['off_tk'][slot] + rb * tb['na_tk'][slot] + ra, valid


class ExplicitMap:
    """Sorted-array binary search (``torch.searchsorted``) with an optional
    permutation back to user order (reference: bsubspace_impl.h:306-331).
    The state list and its sorted form are copied to a device at first use
    there and kept on the map."""

    def __init__(self, L, state_map, rmap_states, rmap_indices):
        self.L = L
        self.state_map = np.asarray(state_map)
        self.rmap_states = np.asarray(rmap_states)
        self.rmap_indices = (None if rmap_indices is None
                             else np.asarray(rmap_indices))
        self._tables = {}

    def _on(self, device, name):
        """One of the int64 tables on ``device`` (cached per map); the
        sorted states are the state list itself when it came sorted."""
        key = (torch.device(device), name)
        if key not in self._tables:
            arr = getattr(self, name)
            if name == 'rmap_states' and arr is self.state_map:
                self._tables[key] = self._on(device, 'state_map')
            else:
                self._tables[key] = torch.as_tensor(
                    np.ascontiguousarray(arr, dtype=np.int64), device=device)
        return self._tables[key]

    def table_bytes(self):
        """Bytes of the tables one device holds once both maps ran."""
        arrays = {id(a): a.nbytes for a in (self.state_map, self.rmap_states,
                                            self.rmap_indices)
                  if a is not None}
        return sum(arrays.values())

    def i2s(self, idx):
        return self._on(idx.device, 'state_map')[idx]

    def s2i(self, state):
        sorted_states = self._on(state.device, 'rmap_states')
        pos = torch.searchsorted(sorted_states, state)
        pos = pos.clamp_(max=len(self.rmap_states) - 1)
        valid = sorted_states[pos] == state
        if self.rmap_indices is not None:
            return self._on(state.device, 'rmap_indices')[pos], valid
        return pos, valid


def device_map(subspace):
    """Build the device index map for a host Subspace object.

    XParity is handled at the operator level (its MSC gets rewritten and its
    index maps coincide with the parent's on representatives), so here it
    resolves to its parent's map.
    """
    from .. import subspaces as sp

    if isinstance(subspace, sp.XParity):
        return device_map(subspace.parent)
    if isinstance(subspace, sp.Full):
        return FullMap(subspace.L)
    if isinstance(subspace, sp.Parity):
        return ParityMap(subspace.L, subspace.space)
    if isinstance(subspace, sp.SpinConserve):
        return SpinConserveMap(subspace.L, subspace.k, subspace.nchoosek)
    if isinstance(subspace, sp.Explicit):
        return ExplicitMap(subspace.L, subspace.state_map,
                           subspace.rmap_states, subspace.rmap_indices)
    raise TypeError(f'no device map for subspace type {type(subspace)}')
