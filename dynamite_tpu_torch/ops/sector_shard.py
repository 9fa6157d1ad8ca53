"""
The sector engine over ranks: its alpha ring (the JAX package's
``ops/sector_shard.py``), torch ops as in :mod:`.sector_apply`.

In the sector-major basis (:mod:`.sectors`) each sector is a contiguous
(nb x na) block: rows indexed by the rank of the high-rest bits (beta),
columns by the rank of the low half (alpha). The engine's channels
(:class:`.sector_apply.SectorPlan`) act as

* row channels:   Y_so += ca ⊙ (N @ X_si)         mix beta, alpha untouched
* col channels:   Y_so += W ⊙ (X_si[bidx] @ M^T)  permute beta, mix alpha
* diagonal:       Y    += D ⊙ X                    elementwise

Each rank owns an alpha slice of width w = ceil(na / P) of every sector
(:class:`AlphaLayout`), so row channels, the beta gather and the diagonal
are local, and only the column channels' alpha products need other ranks'
data. Those run as a ring: the engine-layout blocks pass around it and each
rank adds, at each step, X_ring[bidx] @ M[its out-cols, the block's
in-cols]^T. The M tables are split over their output-alpha rows, so table
memory per rank falls as 1/P; the row matrices N, the row scales W and the
gathers bidx (the size of a sector's rows, not of the state) are held by
every rank.

The state keeps the canonical layout of ``parallel.mesh`` (sector-major
rows, contiguous blocks of ceil(dim / P) rows, pad rows 0). Two more rings
move it into the alpha layout and back: at each step a rank takes, from
index arithmetic on (sector, beta, alpha) alone, the elements of the
passing block that are its own, so no index table at the state's size is
kept. Every ring here runs :func:`.apply.ring` over the kernel's transport
(process group or virtual ranks), P steps and P - 1 passes each.

Unlike the JAX package, the build keeps ``bidx`` as the plan's int64 copy
(no second cast per channel) and makes no sector index table that nothing
reads.
"""

import numpy as np
import torch

from .. import tracing
from .apply import _Sharded, ring
from .ell import _key
from .sector_apply import SectorPlan, diagonal_at


def _cdiv(a, b):
    return -(-a // b)


class AlphaLayout:
    """The alpha layout of a :class:`.sector_apply.SectorPlan` over
    ``world`` ranks. For each participating sector i (in ``secs`` order):

    * ``nb[i]``, ``na[i]`` — its canonical block shape;
    * ``w[i]`` — the width of each rank's alpha slice (na padded to
      world * w);
    * ``aoff[i]`` — the offset of its (nb, w) block in a rank's engine
      buffer of ``local_dim`` entries;
    * ``off[i]`` — its canonical flat offset."""

    def __init__(self, sector_plan, world):
        lay = sector_plan.lay
        secs = sector_plan.secs
        base = int(lay.off[secs[0]])
        self.world = world
        self.nb = [int(lay.nb[s]) for s in secs]
        self.na = [int(lay.na[s]) for s in secs]
        self.off = [int(lay.off[s]) - base for s in secs]
        self.w = [_cdiv(n, world) for n in self.na]
        self.aoff = []
        o = 0
        for nb, w in zip(self.nb, self.w):
            self.aoff.append(o)
            o += nb * w
        self.local_dim = o
        self.dim = sector_plan.dim

    def engine_sources(self, rank):
        """Host numpy: the canonical flat index that feeds each engine
        position of ``rank`` (-1 for alpha padding)."""
        out = np.full(self.local_dim, -1, dtype=np.int64)
        for i in range(len(self.nb)):
            nb, na, w = self.nb[i], self.na[i], self.w[i]
            a = rank * w + np.arange(w)
            valid = a < na
            block = (self.off[i] + np.arange(nb)[:, None] * na
                     + np.minimum(a, na - 1)[None, :])
            block = np.where(valid[None, :], block, -1)
            out[self.aoff[i]:self.aoff[i] + nb * w] = block.reshape(-1)
        return out

    def meta(self, device):
        """(aoff, w, na, off) as int64 tensors on ``device``."""
        return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                     device=device)
                     for a in (self.aoff, self.w, self.na, self.off))


def _local_coords(meta, local_dim, rank, device):
    """For each engine position of ``rank``: the canonical flat index that
    feeds it, -1 for alpha padding (:meth:`AlphaLayout.engine_sources` as
    torch ops)."""
    aoff, w, na, off = meta
    q = torch.arange(local_dim, dtype=torch.int64, device=device)
    s = torch.searchsorted(aoff, q, right=True) - 1
    ws = w[s]
    rem = q - aoff[s]
    beta = rem // ws
    alpha = rank * ws + (rem - beta * ws)
    g = off[s] + beta * na[s] + alpha
    return torch.where(alpha < na[s], g, -1)


def _canonical_coords(meta, local_can, dim, rank, device):
    """For each canonical row of ``rank``: the rank that holds it in the
    alpha layout, its position there, and whether it is a row (not a
    pad)."""
    aoff, w, na, off = meta
    g = rank * local_can + torch.arange(local_can, dtype=torch.int64,
                                        device=device)
    valid = g < dim
    gc = torch.where(valid, g, 0)
    s = torch.searchsorted(off, gc, right=True) - 1
    rem = gc - off[s]
    nas = na[s]
    beta = rem // nas
    alpha = rem - beta * nas
    ws = w[s]
    d = alpha // ws
    p = aoff[s] + beta * ws + (alpha - d * ws)
    return d, p, valid


class _RankTables:
    """One rank's tables in one (dtype, device): its column channels (M
    split to its output-alpha rows), its row channels (its slice of ca)
    and its diagonal in the alpha layout. A matrix several channels share
    is one tensor; N, W and bidx are shared by every rank."""

    def __init__(self, route, rank, dtype, device, shared):
        sp, alay = route.sector_plan, route.layout
        P = alay.world

        def put(a, index=False):
            if a is None:
                return None
            key = ('shared', id(a))
            if key not in shared:
                t = torch.as_tensor(a, device=device)
                shared[key] = t.long() if index else t.to(dtype)
            return shared[key]

        mine = {}

        def m_rows(mat, o, i):
            """mat's output-alpha rows of this rank, padded to (w_o, P w_i)."""
            if mat is None:
                return None
            key = id(mat)
            if key not in mine:
                w_o, w_i = alay.w[o], alay.w[i]
                pad = np.zeros((w_o, P * w_i), dtype=mat.dtype)
                a0 = rank * w_o
                k = max(0, min(w_o, mat.shape[0] - a0))
                pad[:k, :mat.shape[1]] = mat[a0:a0 + k]
                mine[key] = torch.as_tensor(pad, device=device).to(dtype)
            return mine[key]

        def ca_slice(ca, o):
            if ca is None:
                return None
            key = ('ca', id(ca))
            if key not in mine:
                w_o = alay.w[o]
                pad = np.zeros(P * w_o, dtype=ca.dtype)
                pad[:len(ca)] = ca
                mine[key] = torch.as_tensor(
                    pad[rank * w_o:(rank + 1) * w_o], device=device).to(dtype)
            return mine[key]

        idx = sp.sec_index
        self.cols = [(idx[si], idx[so], put(b, True), put(w),
                      m_rows(mr, idx[so], idx[si]),
                      m_rows(mi, idx[so], idx[si]))
                     for si, so, b, w, mr, mi in sp.col_channels]
        self.rows = [(idx[si], idx[so], ca_slice(ca, idx[so]), put(nr),
                      put(ni))
                     for si, so, ca, nr, ni in sp.row_channels]
        self.own = list(mine.values())
        self.diag = None
        if sp.diag_terms:
            g = _local_coords(route.meta(device), alay.local_dim, rank,
                              device)
            self.diag = diagonal_at(route.plan, sp.diag_terms, g, dtype)
            self.own += [d for d in self.diag if d is not None]


class SectorRing(_Sharded):
    """The sector engine's alpha ring over the ranks of a transport (the
    JAX package's ``build_sector_sharded``, ``sector_shard.py:166``).
    ``sector_plan`` is the whole operator's plan (every rank builds the
    same, in ``config.real_dtype``, its diagonal left out), ``layout`` the
    :class:`AlphaLayout`; ``on(dtype, device)`` the ranks'
    :class:`_RankTables`, built here in ``config``'s dtype on
    ``config.device``. Counts its applies, one per rank, in
    ``sector.ring_applies`` (:mod:`..tracing`)."""

    engine = 'sector_ring'

    def __init__(self, plan, left, right, transport):
        from .. import config
        super().__init__(plan, transport)
        self.sector_plan = SectorPlan(plan, left, right, config.real_dtype,
                                      with_diag=False)
        self.layout = AlphaLayout(self.sector_plan, self.world)
        self._meta = {}
        self._on = {}
        self.on(config.real_dtype, config.device)

    def meta(self, device):
        device = _key(None, device)[1]
        if device not in self._meta:
            self._meta[device] = self.layout.meta(device)
        return self._meta[device]

    def on(self, dtype, device):
        """{rank: _RankTables} of the ranks this process runs, in ``dtype``
        on ``device`` (built once)."""
        key = _key(dtype, device)
        device = key[1]
        if key not in self._on:
            shared = {}
            self._on[key] = {r: _RankTables(self, r, dtype, device, shared)
                             for r in self.transport.ranks}
            self._on[key]['shared'] = list(shared.values())
        return self._on[key]

    def table_bytes(self, rank, dtype, device):
        """A rank's table bytes in ``dtype``, counted from the plan (so
        any rank's, built or not, without a collective), the same on every
        rank: its own (each M's output-alpha rows padded to (w_o, P w_i),
        its slice of each ca, its diagonal in the alpha layout) and those
        every rank holds (N, W, and bidx as int64), each matrix once
        (:class:`_RankTables` shares them by identity)."""
        sp, alay, P = self.sector_plan, self.layout, self.world
        cb = torch.empty((), dtype=dtype).element_size()
        idx = sp.sec_index
        shared, own = {}, {}
        for si, so, b, w, mr, mi in sp.col_channels:
            o, i = idx[so], idx[si]
            if b is not None:
                shared[id(b)] = b.size * 8
            if w is not None:
                shared[id(w)] = w.size * cb
            for m in (mr, mi):
                if m is not None:
                    own[id(m)] = alay.w[o] * P * alay.w[i] * cb
        for si, so, ca, nr, ni in sp.row_channels:
            if ca is not None:
                own[('ca', id(ca))] = alay.w[idx[so]] * cb
            for n in (nr, ni):
                if n is not None:
                    shared[id(n)] = n.size * cb
        diag = 0
        if sp.diag_terms:
            planes = 2 if any(c.imag for c, _s in sp.diag_terms) else 1
            diag = planes * alay.local_dim * cb
        return sum(shared.values()) + sum(own.values()) + diag

    def _slices(self, xe):
        alay = self.layout
        return [xe[:, o:o + nb * w].view(2, nb, w)
                for o, nb, w in zip(alay.aoff, alay.nb, alay.w)]

    def apply(self, xs):
        """The (2, local_dim) canonical rows of y of every rank the
        transport runs, from theirs of x."""
        transport, alay, P = self.transport, self.layout, self.world
        dtype, device = xs[0].dtype, xs[0].device
        tabs = self.on(dtype, device)
        meta = self.meta(device)
        local_can = self.local_left

        # ring 1: canonical -> alpha layout
        g = {r: _local_coords(meta, alay.local_dim, r, device)
             for r in transport.ranks}

        def conv_in(r, t, block, acc):
            lo = ((r - t) % P) * local_can
            sel = (g[r] >= lo) & (g[r] < lo + local_can)
            return torch.where(sel, block[:, (g[r] - lo).clamp_(
                0, local_can - 1)], acc)

        xe = ring(transport, xs, conv_in,
                  [x.new_zeros((2, alay.local_dim)) for x in xs])
        del g

        # the diagonal and the row channels: local in the alpha layout
        ye = []
        for r, x in zip(transport.ranks, xe):
            tab = tabs[r]
            if tab.diag is None:
                y = torch.zeros_like(x)
            else:
                Dr, Di = tab.diag
                y = x * Dr
                if Di is not None:
                    y[0].addcmul_(Di, x[1], value=-1)
                    y[1].addcmul_(Di, x[0])
            xsl, ysl = self._slices(x), self._slices(y)
            for si, so, ca, Nr, Ni in tab.rows:
                src = xsl[si] if ca is None else xsl[si] * ca
                ysl[so].baddbmm_(Nr.expand(2, -1, -1), src)
                if Ni is not None:
                    ysl[so][0].addmm_(Ni, src[1], alpha=-1)
                    ysl[so][1].addmm_(Ni, src[0])
            ye.append(y)

        # ring 2: the column channels against the passing block
        def col_body(r, t, block, y):
            c = (r - t) % P
            bs, ysl = self._slices(block), self._slices(y)
            for si, so, bidx, W, Mr, Mi in tabs[r].cols:
                src = bs[si] if bidx is None else bs[si].index_select(1,
                                                                      bidx)
                if W is not None:
                    src = src * W[:, None]
                w_i = alay.w[si]
                Mr_c = Mr[:, c * w_i:(c + 1) * w_i]
                ysl[so].baddbmm_(src, Mr_c.t().expand(2, -1, -1))
                if Mi is not None:
                    Mi_c = Mi[:, c * w_i:(c + 1) * w_i]
                    ysl[so][0].addmm_(src[1], Mi_c.t(), alpha=-1)
                    ysl[so][1].addmm_(src[0], Mi_c.t())
            return y

        if self.sector_plan.col_channels:
            ye = ring(transport, xe, col_body, ye)
        del xe

        # ring 3: alpha layout -> canonical
        coords = {r: _canonical_coords(meta, local_can, alay.dim, r, device)
                  for r in transport.ranks}

        def conv_out(r, t, block, acc):
            d, p, valid = coords[r]
            sel = valid & (d == (r - t) % P)
            return torch.where(sel, block[:, p], acc)

        ys = ring(transport, ye, conv_out,
                  [x.new_zeros((2, local_can)) for x in xs])
        tracing.count('sector.ring_applies', len(ys))
        return ys

