"""
Symmetry-sector subspaces: bijections between dense vector indices and the
product states (bitstrings) they represent.

This slice of the port carries ``Full`` and ``Parity``. Host-side maps here
are vectorized numpy; the torch versions that the device code uses live in
:mod:`dynamite_tpu_torch.ops.index_maps`.

Reference semantics: src/dynamite/subspaces.py and
src/dynamite/_backend/bsubspace_impl.h (index-map formulas).
"""

from copy import deepcopy
from zlib import crc32

import numpy as np

from . import config
from .utils import validate
from .utils.bitwise import parity


class Subspace:
    """Base class for all subspaces."""

    _chksum = None
    _product_state_basis = True

    def __eq__(self, other):
        """True when the two subspaces define the same index<->state mapping,
        even across different classes."""
        if other is self:
            return True
        if not isinstance(other, Subspace):
            raise ValueError('Cannot compare Subspace to non-Subspace type')
        if self.L is None:
            raise ValueError('comparing subspaces requires L to be set '
                             'on both')
        if self.get_dimension() != other.get_dimension():
            return False
        return self.get_checksum() == other.get_checksum()

    def identical(self, other):
        """Whether the two subspaces are the same type with the same values."""
        return hash(self) == hash(other)

    @property
    def L(self):
        return self._L

    @L.setter
    def L(self, value):
        if self.L is not None and value != self.L:
            raise AttributeError('Cannot change L for a subspace after it '
                                 'is set')
        value = validate.L(value)
        self._L = self.check_L(value)

    def check_L(self, value):
        return value

    @property
    def product_state_basis(self):
        """Whether the basis states of this subspace are product states."""
        return self._product_state_basis

    def copy(self):
        return deepcopy(self)

    def get_checksum(self):
        """CRC32 over the full index->state map, for fast equality checks."""
        if self._chksum is None:
            block = 1 << 14
            chksum = 0
            dim = self.get_dimension()
            for start in range(0, dim, block):
                stop = min(start + block, dim)
                states = self.idx_to_state(np.arange(start, stop))
                chksum = crc32(np.ascontiguousarray(states, dtype=np.int64),
                               chksum)
            self._chksum = chksum
        return self._chksum

    def __hash__(self):
        return hash((type(self).__name__, self.get_checksum()))

    def get_dimension(self):
        """The dimension of the subspace."""
        raise NotImplementedError

    def _require_L(self):
        if self.L is None:
            raise ValueError('L has not been set for this subspace')

    # -- vectorized index maps ----------------------------------------------

    def idx_to_state(self, idx):
        """Map index(es) to product-state integer(s)."""
        single = not hasattr(idx, '__len__')
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64))
        dim = self.get_dimension()
        if idx.size and (idx.min() < 0 or idx.max() >= dim):
            bad = idx[(idx < 0) | (idx >= dim)]
            raise ValueError(f'Indices {bad} out of bounds for subspace of '
                             f'dimension {dim}')
        out = self._idx_to_state(idx)
        return out[0] if single else out

    def state_to_idx(self, state):
        """Inverse of :meth:`idx_to_state`; -1 for states outside the
        subspace."""
        single = not hasattr(state, '__len__')
        state = np.atleast_1d(np.asarray(state, dtype=np.int64))
        out = self._state_to_idx(state)
        return out[0] if single else out

    def _idx_to_state(self, idx):
        raise NotImplementedError

    def _state_to_idx(self, state):
        raise NotImplementedError


class _ProductStateSubspace(Subspace):
    """A subspace whose basis states are product states in the Z basis."""

    def __init__(self, L=None):
        self._L = None
        if L is None:
            L = config.L
        if L is not None:
            self.L = L


class Full(_ProductStateSubspace):
    """The entire 2**L dimensional Hilbert space."""

    def __eq__(self, other):
        if isinstance(other, Full):
            return other.L == self.L
        return super().__eq__(other)

    def __hash__(self):
        return hash(('Full', self.L))

    def __repr__(self):
        return f'Full(L={self.L})' if self.L is not None else 'Full()'

    def get_dimension(self):
        self._require_L()
        return 1 << self.L

    def _idx_to_state(self, idx):
        return idx

    def _state_to_idx(self, state):
        return state


class Parity(_ProductStateSubspace):
    """States with an even or odd number of down (1) spins.

    The index drops the lowest bit, which is reconstructed from the parity of
    the rest (reference: bsubspace_impl.h:116-134).

    Parameters
    ----------
    space : int or str
        0 or 'even' for the even sector; 1 or 'odd' for the odd one.
    """

    def __init__(self, space, L=None):
        super().__init__(L)
        self._space = self._check_space(space)

    @staticmethod
    def _check_space(value):
        if value in (0, 'even'):
            return 0
        if value in (1, 'odd'):
            return 1
        raise ValueError(f'Invalid parity space "{value}" (valid choices are '
                         '0, 1, "even", or "odd")')

    @property
    def space(self):
        return self._space

    def __eq__(self, other):
        # two Parity spaces are equal iff L and sector agree; skips the
        # checksum over all 2**(L-1) basis states
        if isinstance(other, Parity):
            return other.L == self.L and other.space == self.space
        return super().__eq__(other)

    def __hash__(self):
        return hash(('Parity', self.L, self.space))

    def __repr__(self):
        arg = {0: "'even'", 1: "'odd'"}[self.space]
        if self.L is not None:
            arg += f', L={self.L}'
        return f'Parity({arg})'

    def get_dimension(self):
        self._require_L()
        return 1 << (self.L - 1)

    def _idx_to_state(self, idx):
        return (idx << 1) | (parity(idx) ^ self.space)

    def _state_to_idx(self, state):
        idx = state >> 1
        return np.where(parity(state) == self.space, idx, -1)


def _not_ported(name, item):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f'{name} is not ported to dynamite_tpu_torch yet '
            f'(ROADMAP.md queue 1, item {item})')
    return type(name, (Subspace,), {'__init__': __init__,
                                    '__doc__': f'Not ported yet: ROADMAP.md '
                                               f'queue 1, item {item}.'})


SpinConserve = _not_ported('SpinConserve', 7)
XParity = _not_ported('XParity', 7)
Explicit = _not_ported('Explicit', 10)
Auto = _not_ported('Auto', 10)
