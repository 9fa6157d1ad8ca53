"""
Symmetry-sector subspaces: bijections between dense vector indices and the
product states (bitstrings) they represent.

The port carries ``Full``, ``Parity``, ``SpinConserve`` and ``XParity`` over
any of them; ``Explicit`` and ``Auto`` raise until they are ported. Host-side
maps here are vectorized numpy; the torch versions that the device code uses
live in :mod:`dynamite_tpu_torch.ops.index_maps`.

Reference semantics: src/dynamite/subspaces.py and
src/dynamite/_backend/bsubspace_impl.h (index-map formulas).
"""

import math
from copy import deepcopy
from zlib import crc32

import numpy as np

from . import config
from .ops import msc as msc_mod
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


class SpinConserve(_ProductStateSubspace):
    """States with exactly ``k`` down (1) spins: dimension C(L, k).

    The basis is ordered *sector-major*, as in the JAX package (see
    :mod:`dynamite_tpu_torch.ops.sectors`): by the top spin, then by the
    Hamming weight of the high half, then by the combinatorial rank of each
    half. Every symmetry sector is then a contiguous 2-D block, and the
    matvec becomes dense matmuls (ops/sector_apply.py).
    """

    def __init__(self, L, k, spinflip=None):
        super().__init__(L=L)
        if spinflip is not None:
            raise DeprecationWarning('spinflip argument has been deprecated; '
                                     'use the XParity class instead.')
        if not 0 <= k <= self.L:
            raise ValueError('k must be between 0 and L')
        self._k = int(k)
        # nchoosek[kk, n] = C(n, kk), zero when kk > n
        self._nchoosek = np.array(
            [[math.comb(n, kk) for n in range(L + 1)]
             for kk in range(k + 1)],
            dtype=np.int64)

    @property
    def k(self):
        """The number of down ('1' in binary representation) spins."""
        return self._k

    @property
    def nchoosek(self):
        return self._nchoosek

    @property
    def sector_layout(self):
        """The static sector-major layout (ops/sectors.SectorLayout)."""
        from .ops import sectors
        return sectors.layout(self.L, self.k)

    def __eq__(self, other):
        # two SpinConserve spaces are equal iff L and k agree; skips the
        # checksum over all C(L, k) basis states
        if isinstance(other, SpinConserve):
            return other.L == self.L and other.k == self.k
        return super().__eq__(other)

    def __hash__(self):
        return hash(('SpinConserve', self.L, self.k))

    def __repr__(self):
        return f'SpinConserve(L={self.L}, k={self.k})'

    def get_dimension(self):
        return int(self._nchoosek[self.k, self.L])

    def _state_to_idx(self, state):
        from .ops import sectors
        return sectors.state_to_idx(self.sector_layout, state)

    def _idx_to_state(self, idx):
        from .ops import sectors
        return sectors.idx_to_state(self.sector_layout, idx)


class XParity(Subspace):
    r"""Parity in the X basis, layered on top of a parent subspace.

    Basis states are :math:`|c> \pm |\bar c>` (c and its global spin flip),
    represented by whichever of the two bitstrings has spin L-1 in state 0.
    Halves the parent dimension; not a product-state basis.
    (reference: subspaces.py:532-795)
    """

    _product_state_basis = False

    def __init__(self, parent=None, sector='+', L=None):
        if parent is None:
            parent = Full()
        self._parent = parent
        if L is not None:
            self.parent.L = L

        self._validate_parent(self.parent)

        if sector in ('+', +1):
            self._sector = +1
        elif sector in ('-', -1):
            self._sector = -1
        else:
            raise ValueError('invalid value for sector')

    @classmethod
    def _validate_parent(cls, parent):
        if not parent.product_state_basis:
            raise ValueError('parent must be a product state subspace')
        if isinstance(parent, Full):
            return
        if parent.L is None:
            raise ValueError('L must be set for the parent subspace')
        if isinstance(parent, Parity):
            if parent.L % 2 == 0:
                return
            raise ValueError('Parity is only compatible with XParity when L '
                             'is even')
        if isinstance(parent, SpinConserve):
            if parent.L == 2 * parent.k:
                return
            raise ValueError('SpinConserve is only compatible with XParity '
                             'when k=L/2')
        raise NotImplementedError(
            f'XParity over {type(parent).__name__} is not ported yet '
            '(ROADMAP.md queue 1, item 10)')

    @property
    def parent(self):
        return self._parent

    @property
    def sector(self):
        return self._sector

    @property
    def _L(self):
        return self.parent.L

    @_L.setter
    def _L(self, value):
        self.parent.L = value

    def __hash__(self):
        return hash(('XParity', self.sector, self.parent))

    def __repr__(self):
        return f'XParity({self.parent!r}, sector={self.sector:+d})'

    def get_dimension(self):
        return self.parent.get_dimension() // 2

    def _idx_to_state(self, idx):
        # representatives are exactly the first dim/2 parent states
        return self.parent.idx_to_state(idx)

    def _state_to_idx(self, state):
        if np.count_nonzero(state >> (self.L - 1)):
            raise ValueError('invalid state')
        return self.parent.state_to_idx(state)

    def reduce_msc(self, msc, check_conserves=False):
        """Rewrite an MSC operator into the equivalent form on this subspace:
        drop terms that do not commute with the global X-string, fold masks
        that touch spin L-1 onto their complements (with a sector sign)."""
        msc = msc.copy()

        commutes = parity(msc['signs']) == 0
        conserved = bool(np.all(commutes))
        msc = msc[commutes]

        fold = (msc['masks'] >> (self.L - 1)) != 0
        msc['masks'][fold] ^= (np.int64(1) << np.int64(self.L)) - 1
        if self.sector == -1:
            msc['coeffs'][fold] *= -1

        msc = msc_mod.combine_terms(msc)

        if check_conserves:
            return msc, conserved
        return msc

    def convert_state(self, state):
        """Convert a state on this subspace to its parent, or vice versa,
        on the state's device: the complement of each representative is
        found with the parent's device index map (ops/index_maps.py), and
        the amplitudes move with one ``index_select`` (to the parent) or
        one ``index_add_`` (to this subspace)."""
        import torch
        from .states import State
        from .ops.index_maps import device_map
        from .parallel import multihost

        state.assert_initialized()
        if multihost.world_size() > 1:
            raise NotImplementedError(
                'XParity.convert_state of a state spread over ranks is not '
                'ported yet (ROADMAP.md queue 1, item 12)')
        n_in = len(state)
        flip = (1 << self.L) - 1
        pmap = device_map(self.parent)
        data = state.data
        invsq2 = 1.0 / np.sqrt(2)

        def complement_idx(first, stop):
            rows = torch.arange(first, stop, dtype=torch.int64,
                                device=data.device)
            idx, _ = pmap.s2i(flip ^ pmap.i2s(rows))
            return idx

        if state.subspace is self:
            # to the parent: amplitude a on representative c, sector * a on
            # its complement; the second half of the parent's rows are the
            # complements of the first
            pdim = self.parent.get_dimension()
            comp = data.index_select(1, complement_idx(n_in, pdim))
            vec = torch.cat([data, self.sector * comp], dim=1)
            out = State(subspace=self.parent)
        elif state.subspace is self.parent:
            dim_out = n_in // 2
            to_idx = complement_idx(dim_out, n_in)
            vec = data[:, :dim_out].clone()
            vec.index_add_(1, to_idx, data[:, dim_out:],
                           alpha=self.sector)
            out = State(subspace=self)
        else:
            raise ValueError('subspace of input state must be this XParity '
                             'subspace or its parent')
        out.data = vec * invsq2
        out.set_initialized()
        return out


def _not_ported(name, item):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f'{name} is not ported to dynamite_tpu_torch yet '
            f'(ROADMAP.md queue 1, item {item})')
    return type(name, (Subspace,), {'__init__': __init__,
                                    '__doc__': f'Not ported yet: ROADMAP.md '
                                               f'queue 1, item {item}.'})


Explicit = _not_ported('Explicit', 10)
Auto = _not_ported('Auto', 10)
