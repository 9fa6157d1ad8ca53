"""
Symmetry-sector subspaces: bijections between dense vector indices and the
product states (bitstrings) they represent.

The port carries ``Full``, ``Parity``, ``SpinConserve``, ``Explicit``,
``Auto`` and ``XParity`` over any of them. Host-side maps here are
vectorized numpy; the torch versions that the device code uses
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
from .utils.bitwise import parity, popcount


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


class Explicit(_ProductStateSubspace):
    """A subspace given by an explicit list of product states.

    state_to_idx is a binary search over the sorted state list
    (reference: bsubspace_impl.h:306-331).
    """

    def __init__(self, state_list, L=None):
        self.state_map = np.ascontiguousarray(state_list, dtype=np.int64)

        if np.all(self.state_map[:-1] <= self.state_map[1:]):
            self.rmap_indices = None  # already sorted: rank == index
            self.rmap_states = self.state_map
        else:
            order = np.argsort(self.state_map, kind='stable')
            self.rmap_indices = np.ascontiguousarray(order, dtype=np.int64)
            self.rmap_states = np.ascontiguousarray(self.state_map[order])

        if np.any(self.rmap_states[1:] == self.rmap_states[:-1]):
            raise ValueError('state_list contains duplicate states')

        super().__init__(L=L)

    def check_L(self, value):
        if int(self.rmap_states[-1]) >> value != 0:
            raise ValueError('State in subspace has more spins than provided')
        return value

    def __hash__(self):
        return hash(('Explicit', self.get_checksum()))

    def __repr__(self):
        if len(self.state_map) <= 32:
            shown = list(self.state_map)
        else:
            shown = (list(self.state_map[:3]) + ['...']
                     + list(self.state_map[-3:]))
        L = (self.L if self.L is not None
             else int(self.rmap_states[-1]).bit_length())
        body = ', '.join(
            x if isinstance(x, str) else '0b' + bin(int(x))[2:].zfill(L)
            for x in shown)
        arg = f'[{body}]'
        if self.L is not None:
            arg += f', L={self.L}'
        return f'Explicit({arg})'

    def get_dimension(self):
        return len(self.state_map)

    def _idx_to_state(self, idx):
        return self.state_map[idx]

    def _state_to_idx(self, state):
        pos = np.searchsorted(self.rmap_states, state)
        pos = np.minimum(pos, len(self.rmap_states) - 1)
        found = self.rmap_states[pos] == state
        idx = pos if self.rmap_indices is None else self.rmap_indices[pos]
        return np.where(found, idx, -1)


class Auto(Explicit):
    """Discover the symmetry sector containing a seed state by breadth-first
    search over the Hamiltonian's hopping graph (reference:
    subspaces.py:466-529 + bsubspace.pyx:212-261). The search runs in the
    port's host C++ (``csrc/host_bfs.cpp``, :mod:`._native`).

    Parameters
    ----------
    H : Operator
        The operator whose conserved sector is wanted.
    state : int or str
        Seed product state (string like 'UUDD...' or integer).
    size_guess : int, optional
        Unused (kept for API parity; memory is grown dynamically).
    sort : bool
        Sort the discovered states (True) or keep reverse-BFS
        (Cuthill-McKee-like) order (False).
    """

    def __init__(self, H, state, size_guess=None, sort=True):
        from .states import State

        H.establish_L()

        self._repr_args = f'H={H!r}, state={state!r}'
        if size_guess is not None:
            self._repr_args += f', size_guess={size_guess}'
        if not sort:
            self._repr_args += ', sort=False'

        self.state = State.str_to_state(state, H.L)
        H.reduce_msc()
        state_map = _bfs_sector(H.msc, self.state)

        if sort:
            state_map = _canonical_order(state_map, H.L)
        else:
            state_map = state_map[::-1]  # reverse Cuthill-McKee needs reverse

        super().__init__(state_map, L=H.L)

    def __repr__(self):
        return f'Auto({self._repr_args})'


def _canonical_order(states, L):
    """The canonical deterministic order for a discovered sector: when the
    sector has uniform Hamming weight (a magnetization sector), the
    SpinConserve sector-major order, so Auto == SpinConserve holds, as in
    the reference (its tests rely on the equality); otherwise plain value
    order."""
    pcs = popcount(states)
    if len(states) and np.all(pcs == pcs.flat[0]):
        from .ops import sectors
        lay = sectors.layout(L, int(pcs.flat[0]))
        key = sectors.state_to_idx(lay, states)
        return np.ascontiguousarray(states[np.argsort(key, kind='stable')])
    return np.sort(states)


def _bfs_sector(msc, seed):
    """BFS over the graph whose edges are the operator's masks, starting from
    ``seed``. An edge (state -> state^mask) exists when the mask group's
    total coefficient sum_t (-1)**parity(state & sign_t) * coeff_t is
    nonzero. Returns states in discovery (queue) order, from the host C++
    search (:func:`._native.bfs_sector`)."""
    from . import _native
    masks, offsets = msc_mod.mask_groups(msc)
    return _native.bfs_sector(masks, offsets, msc['signs'], msc['coeffs'],
                              int(seed))


def _bfs_sector_reference(msc, seed):
    """The plain numpy version of :func:`_bfs_sector` (the JAX package's
    fallback loop), the same states in the same order; the tests hold the
    native search against it. A Python loop over every edge: minutes at
    L=24, so no entry point calls it."""
    masks, offsets = msc_mod.mask_groups(msc)
    signs = msc['signs']
    coeffs = msc['coeffs']

    seen = {int(seed)}
    order = [int(seed)]
    frontier = np.array([seed], dtype=np.int64)

    while frontier.size:
        # (F, T) parity signs, then per-group coefficient totals
        sgn = 1 - 2 * parity(frontier[:, None] & signs[None, :])
        totals = np.add.reduceat(sgn * coeffs[None, :], offsets[:-1], axis=1)
        edges = frontier[:, None] ^ masks[None, :]      # (F, G)
        valid = totals != 0
        new = []
        for s, ok in zip(edges.reshape(-1), valid.reshape(-1)):
            s = int(s)
            if ok and s not in seen:
                seen.add(s)
                new.append(s)
        order.extend(new)
        frontier = np.array(new, dtype=np.int64)

    return np.array(order, dtype=np.int64)


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

        # Explicit and friends: check directly that each of the first dim/2
        # states starts with 0 and has its complement in the subspace
        dim = parent.get_dimension()
        if dim % 2 != 0:
            raise ValueError('parent subspace must have even dimension')
        flip = (1 << parent.L) - 1
        block = 1 << 14
        for start in range(0, dim // 2, block):
            stop = min(start + block, dim // 2)
            reps = parent.idx_to_state(np.arange(start, stop))
            if np.count_nonzero(reps >> (parent.L - 1)):
                raise ValueError('first dim/2 basis states must have spin '
                                 'L-1 up (0 in integer notation)')
            if np.any(parent.state_to_idx(reps ^ flip) == -1):
                raise ValueError('the complement of every state in subspace '
                                 '(all spins flipped) must also be in '
                                 'subspace')

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
        the amplitudes move with one ``index_select`` and, to this
        subspace, one add. Over ranks the input is all-gathered (the
        complement of a representative lives on another rank) and each
        rank fills its own rows of the output, by the same ops over their
        global indices, its pad rows 0: each rank's rows equal those of
        one process's conversion, bitwise."""
        import torch
        from .states import State
        from .ops.apply import all_gather_rows
        from .ops.index_maps import device_map
        from .parallel import mesh, multihost

        state.assert_initialized()
        to_parent = state.subspace is self
        if to_parent:
            out = State(subspace=self.parent)
        elif state.subspace is self.parent:
            out = State(subspace=self)
        else:
            raise ValueError('subspace of input state must be this XParity '
                             'subspace or its parent')
        data = state.data
        if multihost.world_size() > 1:
            data = all_gather_rows(data)
        n_in, dim_out = len(state), len(out)
        first, valid = mesh.row0(dim_out), mesh.valid_rows(dim_out)
        stop = first + valid
        flip = (1 << self.L) - 1
        pmap = device_map(self.parent)

        def complement_idx(a, b):
            rows = torch.arange(a, b, dtype=torch.int64, device=data.device)
            idx, _ = pmap.s2i(flip ^ pmap.i2s(rows))
            return idx

        if to_parent:
            # amplitude a on representative c, sector * a on its
            # complement; the second half of the parent's rows are the
            # complements of the first
            mid = min(max(n_in, first), stop)
            comp = data.index_select(1, complement_idx(mid, stop))
            vec = torch.cat([data[:, first:mid], self.sector * comp], dim=1)
        else:
            # a representative's amplitude plus sector times its
            # complement's
            vec = data[:, first:stop].clone()
            vec.add_(data.index_select(1, complement_idx(first, stop)),
                     alpha=self.sector)
        local = out._zeros()
        local[:, :valid] = vec * (1.0 / np.sqrt(2))
        out.data = local
        out.set_initialized()
        return out

