"""
Sector-major layout for the SpinConserve basis (the JAX package's
``ops/sectors.py``, line for line; numpy only).

The SpinConserve subspace (fixed Hamming weight k over L spins) is the
workhorse symmetry sector. The reference dynamite ranks its states
combinatorially (bsubspace_impl.h:191-228), which turns every mask group
into a full-length gather. The JAX package instead chose the *basis
ordering* so that the matvec becomes dense matrix multiplications, and the
port keeps that order: a state saved by either package means the same
basis vector in the other.  Split the chain into a low half
(bits [0, La)), a high "rest" (bits [La, L-1)) and the top spin (bit L-1),
and order states by

    ( t = top bit,  kr = popcount(rest),  rank(rest),  rank(low) )

where rank() is the value-order combinatorial rank within each half.  All
states sharing (t, kr) — a *sector* — then form one contiguous block that
is naturally a 2-D matrix:

    X_sec[beta, alpha],   beta = rank(rest)  in C(Lr, kr) rows,
                          alpha = rank(low)  in C(La, ka) columns,
                          ka = k - t - kr.

A Pauli-string mask m = (m_top | m_rest | m_low) now acts separably:

* m_low only   -> alpha' = rank(low ^ m_low): a small (na x na) matrix
                  acting on the column axis — a dense matmul, with every
                  low-half mask group SUMMED into one matrix per sector;
* m_rest/m_top -> beta' = rank(rest ^ m_rest): an (nb x nb) matrix on the
                  row axis (again one merged matmul per sector pair);
* mixed        -> a row gather (contiguous rows, cheap) composed with a
                  column-axis matrix;
* m == 0       -> a precomputed diagonal field D_sec (the analog of the
                  reference's PrecomputeDiagonal, bpetsc_template_1.c).

Walsh sign factors split the same way, (-1)^{bra&s} =
w_top * w_rest(beta) * w_low(alpha), so they fold into the matrices and
(rarely) into per-row scale vectors.

The top spin is split out so that states with t=0 occupy exactly the first
dim/2 indices (for k = L/2), preserving the representative convention the
XParity subspace relies on (see subspaces.XParity).

The complement bar(s) of a state maps to index dim-1-idx in this ordering
(sector (t,kr) pairs with (1-t, Lr-kr) and in-sector ranks reverse), which
keeps the spin-flip structure exact.

Everything here is host-side numpy; the engine built on top of it lives in
ops/sector_apply.py and the torch index maps in ops/index_maps.py.
"""

from functools import lru_cache

import numpy as np

from ..utils.bitwise import popcount


@lru_cache(maxsize=None)
def sector_split(L):
    """(La, Lr): low-half and high-rest bit counts. The top bit L-1 is its
    own factor. Valid for L >= 1 (L == 1 gives La = 0, Lr = 0)."""
    La = L // 2
    Lr = L - La - 1
    return La, Lr


class SectorLayout:
    """Static layout of the sector-major SpinConserve basis for (L, k).

    Attributes (all host numpy, small):
      La, Lr        : split (top bit is separate)
      t, kr, ka     : per-sector quantum numbers, index order (arrays, S)
      nb, na        : per-sector matrix shape (rows = rest rank,
                      cols = low rank)
      off           : per-sector start offset in the state vector
      dim           : total dimension C(L, k)
      off_tk, na_tk : offset / row-length lookup indexed t*(Lr+1)+kr
                      (entries for nonexistent sectors are 0)
      sec_tk        : sector id per (t, kr) slot, -1 where nonexistent
    """

    def __init__(self, L, k):
        self.L = L
        self.k = k
        La, Lr = sector_split(L)
        self.La = La
        self.Lr = Lr
        from math import comb

        t_l, kr_l, ka_l, nb_l, na_l, off_l = [], [], [], [], [], []
        off = 0
        for t in (0, 1):
            lo = max(0, k - t - La)
            hi = min(Lr, k - t)
            for kr in range(lo, hi + 1):
                ka = k - t - kr
                nb = comb(Lr, kr)
                na = comb(La, ka)
                t_l.append(t)
                kr_l.append(kr)
                ka_l.append(ka)
                nb_l.append(nb)
                na_l.append(na)
                off_l.append(off)
                off += nb * na
        self.t = np.asarray(t_l, dtype=np.int64)
        self.kr = np.asarray(kr_l, dtype=np.int64)
        self.ka = np.asarray(ka_l, dtype=np.int64)
        self.nb = np.asarray(nb_l, dtype=np.int64)
        self.na = np.asarray(na_l, dtype=np.int64)
        self.off = np.asarray(off_l, dtype=np.int64)
        self.dim = off
        assert off == comb(L, k)

        slots = 2 * (Lr + 1)
        self.off_tk = np.zeros(slots, dtype=np.int64)
        self.na_tk = np.zeros(slots, dtype=np.int64)
        self.sec_tk = np.full(slots, -1, dtype=np.int64)
        for s in range(len(self.t)):
            slot = self.t[s] * (Lr + 1) + self.kr[s]
            self.off_tk[slot] = self.off[s]
            self.na_tk[slot] = self.na[s]
            self.sec_tk[slot] = s

    @property
    def n_sectors(self):
        return len(self.t)

    def split_state(self, s):
        """(t, hr, sa) components of state integer(s)."""
        s = np.asarray(s)
        t = (s >> (self.L - 1)) & 1
        hr = (s >> self.La) & ((np.int64(1) << self.Lr) - 1)
        sa = s & ((np.int64(1) << self.La) - 1)
        return t, hr, sa


@lru_cache(maxsize=None)
def layout(L, k):
    return SectorLayout(L, k)


# -------------------------------------------------------------------------
# host-side (numpy) combinatorial rank helpers over one half
# -------------------------------------------------------------------------

def rank_bits(x, nbits, nck, kmax):
    """Value-order combinatorial rank of each x among same-popcount strings
    of ``nbits`` bits. nck is the (kmax+1, >=nbits+1) binomial table."""
    x = np.asarray(x, dtype=np.int64)
    idx = np.zeros(x.shape, dtype=np.int64)
    kk = np.zeros(x.shape, dtype=np.int64)
    for n in range(nbits):
        bit = (x >> n) & 1
        kk += bit
        idx += bit * nck[np.minimum(kk, kmax), n]
    return idx


def unrank_bits(idx, k0, nbits, nck, kmax):
    """Inverse of rank_bits: the popcount-k0 string of ``nbits`` bits with
    rank ``idx`` (k0 may be an array)."""
    idx = np.array(idx, dtype=np.int64, copy=True)
    k = np.array(np.broadcast_to(k0, idx.shape), dtype=np.int64, copy=True)
    state = np.zeros(idx.shape, dtype=np.int64)
    for n in range(nbits, 0, -1):
        state <<= 1
        current = np.where(k > n - 1, 0, nck[np.minimum(k, kmax), n - 1])
        take = idx >= current
        idx -= np.where(take, current, 0)
        k -= take
        state |= take
    return state


def states_of_popcount(nbits, kk):
    """All nbits-bit integers of popcount kk, in value (= rank) order."""
    if kk == 0:
        return np.zeros(1, dtype=np.int64)
    if kk > nbits:
        return np.zeros(0, dtype=np.int64)
    # Gosper's hack, vectorized-ish via python loop (sizes here are small:
    # at most C(Lr, kr) or C(La, ka) entries, bounded by the sector shape)
    from math import comb
    n = comb(nbits, kk)
    out = np.empty(n, dtype=np.int64)
    v = (1 << kk) - 1
    for i in range(n):
        out[i] = v
        c = v & -v
        r = v + c
        v = (((r ^ v) >> 2) // c) | r
    return out


def state_to_idx(layout_, state):
    """Vectorized sector-major rank; -1 for states outside the subspace."""
    lay = layout_
    state = np.asarray(state, dtype=np.int64)
    t, hr, sa = lay.split_state(state)
    kr = popcount(hr)
    ka = popcount(sa)
    valid = (t + kr + ka) == lay.k
    nck = nchoosek_table(lay.L, lay.k)
    slot = np.minimum(t * (lay.Lr + 1) + kr, len(lay.off_tk) - 1)
    off = lay.off_tk[slot]
    na = lay.na_tk[slot]
    rb = rank_bits(hr, lay.Lr, nck, lay.k)
    ra = rank_bits(sa, lay.La, nck, lay.k)
    idx = off + rb * na + ra
    return np.where(valid, idx, -1)


def idx_to_state(layout_, idx):
    """Vectorized sector-major unrank (indices assumed valid)."""
    lay = layout_
    idx = np.asarray(idx, dtype=np.int64)
    sec = np.searchsorted(lay.off, idx, side='right') - 1
    rem = idx - lay.off[sec]
    na = lay.na[sec]
    rb = rem // na
    ra = rem - rb * na
    nck = nchoosek_table(lay.L, lay.k)
    hr = unrank_bits(rb, lay.kr[sec], lay.Lr, nck, lay.k)
    sa = unrank_bits(ra, lay.ka[sec], lay.La, nck, lay.k)
    return (lay.t[sec] << (lay.L - 1)) | (hr << lay.La) | sa


@lru_cache(maxsize=None)
def nchoosek_table(L, k):
    """nck[kk, n] = C(n, kk) for kk <= k, n <= L (shared with the subspace
    object's table; rebuilt here so layouts are self-contained)."""
    from math import comb
    return np.array([[comb(n, kk) for n in range(L + 1)]
                     for kk in range(k + 1)], dtype=np.int64)
