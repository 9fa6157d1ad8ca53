"""
The sector engine for SpinConserve pairs: dense matmuls over the blocks of
the sector-major basis (the JAX package's ``ops/sector_apply.py``).

In the sector-major basis (ops/sectors.py) every symmetry sector of the
SpinConserve subspace is a contiguous (nb x na) matrix block — rows indexed
by the rank of the high-rest bits, columns by the rank of the low half —
and a Pauli-string matvec decomposes into dense matrix products:

* every mask confined to the low half contributes to ONE merged (na x na)
  column matrix A per sector:            Y_s += X_s @ A_s^T
* every mask confined to the high bits contributes to merged (nb x nb')
  row matrices N per (input, output) sector pair:   Y_so += N @ X_si
* masks spanning the boundary become a contiguous-row gather composed with
  a column matrix:                Y_so += W ⊙ (X_si[bidx] @ M^T)
* the identity mask becomes a precomputed diagonal field (the analog of
  the reference's PrecomputeDiagonal, bpetsc_template_1.c:169-202):
  Y += D ⊙ X.

Walsh sign factors (-1)^{bra & s} split multiplicatively over the three bit
regions, so they fold into the matrices; the (rare) masks whose sign bits
cross the boundary get per-row scale vectors (subgrouped by the high part
of the sign mask).

The host build (:class:`SectorPlan`: channels, their merging and the
deduplication of matrices by content) is the JAX package's, line for line,
so both packages build the same channels and matrices; the diagonal field is
computed with torch ops over the device index map and stays on the device.
:func:`build_sector_apply` runs the channels as torch ops, one product per
channel accumulated in place into the output sector's (2, nb, na) view of
y; a matrix that several channels share is one tensor. (The JAX package
batches the channels that share a matrix into one product; on an H100 that
costs a concatenation and an add per channel more, so each channel runs
its own product.) On a CUDA device that fixed sequence of ~200 launches
(SpinConserve(24, 12)) costs the host about three times what it costs the
card, so :func:`sector_apply` captures it once per table set, dtype and
device as a CUDA graph and replays it: the host enqueues a copy, one graph
launch and a clone an apply. TF32 stays off (``config``), so float32
products run in full float32.

:func:`sector_apply_reference` is the engine's plain version: the row-wise
sweep that ranks each row's partners on the fly (the JAX package's general
apply, ``ops/apply.py:360-387``), in row chunks.

Supports plain SpinConserve pairs and XParity-wrapped ones (the reduced
MSC's masks never touch the top spin, so only the t=0 sectors — exactly
the XParity representatives — participate).
"""

import copy
import gc
import weakref

import numpy as np
import torch

from .. import tracing
from ..utils.bitwise import popcount, parity
from . import sectors as sec_mod
from .index_maps import parity as parity_t

# operators with more mask groups than this (e.g. SYK: thousands of
# non-conserving masks) take the ELL engine (ops/ell.py) or the on-the-fly
# sweep, as in the JAX package. Long-range two-body
# models stay under this for any L <= 63 (O(L^2/2) mask groups: XX and YY
# share a group), and channel merging keeps the channel count O(sectors +
# distinct crossing masks), so the limit only exists to stop pathological
# operators from minutes-long host builds
SECTOR_GROUP_LIMIT = 2048
# bytes of device memory for the tables (the JAX package's
# ops/ell.py DEFAULT_ELL_BUDGET, which gates its sector engine)
TABLE_BUDGET = 4 << 30
_TOL = 1e-12
# rows per chunk of the diagonal build and of the plain version
CHUNK_BITS = 20


def _np_dtype(dtype):
    """The numpy dtype of a torch or numpy real dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype({torch.float32: np.float32,
                         torch.float64: np.float64}[dtype])
    return np.dtype(dtype)


def _resolve(subspace):
    """The underlying SpinConserve, or None; second value: XParity flag."""
    from .. import subspaces as sp
    if isinstance(subspace, sp.XParity):
        parent = subspace.parent
        if isinstance(parent, sp.SpinConserve):
            return parent, True
        return None, False
    if isinstance(subspace, sp.SpinConserve):
        return subspace, False
    return None, False


def sector_supported(plan, left, right):
    """Whether the sector engine applies to this (msc, left, right)."""
    lbase, lx = _resolve(left)
    rbase, rx = _resolve(right)
    if lbase is None or rbase is None:
        return False
    if lx != rx:
        return False
    if (lbase.L, lbase.k) != (rbase.L, rbase.k):
        return False
    if plan.dim_left != plan.dim_right:
        return False
    if not plan.groups or len(plan.groups) > SECTOR_GROUP_LIMIT:
        return False
    return True


def _split_mask(m, L, La, Lr):
    mt = (m >> (L - 1)) & 1
    mr = (m >> La) & ((1 << Lr) - 1)
    ma = m & ((1 << La) - 1)
    return mt, mr, ma


def table_bytes_estimate(plan, left, right, world=None):
    """Pre-build upper bound on device table memory. One device (``world``
    None): the matrices and the diagonal, the budget gate of the sector
    engine and of the alpha ring (the JAX package's count). Over ``world``
    ranks (one included): the alpha ring's (:mod:`.sector_shard`), summed
    over the ranks: every rank holds its output-alpha rows of each M,
    padded to (w_o, world w_i) with w = ceil(na / world), the M counted by
    :func:`_ring_matrix_entries`, its diagonal in the alpha layout, its
    slice of each row scale ca, and a copy of each N matrix, row scale W
    and gather bidx (int64); W, bidx and ca are counted at most
    (popcount(mr) + 1) per (mr, top bit, sign part) and output sector."""
    from .. import config
    lbase, lx = _resolve(left)
    lay = sec_mod.layout(lbase.L, lbase.k)
    secs = [s for s in range(lay.n_sectors) if not (lx and lay.t[s])]
    cb = _np_dtype(config.real_dtype).itemsize
    P = 1 if world is None else int(world)
    na = lay.na[secs]
    nb = lay.nb[secs]
    w = -(-na // P)
    # cross-matrix families: masks that TOUCH BOTH halves (high-only
    # masks become row matrices, low-only ones merge into the shared
    # column matrices), one family per distinct high-rest part
    cross_mrs = set()
    col_vecs = set()   # (mr, mt, s_r): column channels' W and bidx
    row_vecs = set()   # (mr, mt, s_a): row channels' ca
    diag_imag = False
    for m, _pm, signs, coeffs in plan.groups:
        mt, mr, ma = _split_mask(int(m), lbase.L, lay.La, lay.Lr)
        if ma and (mr or mt):
            cross_mrs.add(mr)
        if m == 0 and np.any(np.abs(np.imag(coeffs)) > 0):
            diag_imag = True
        if world is not None and m:
            signs = np.asarray(signs, dtype=np.int64)
            if ma:
                col_vecs.update((mr, mt, int(v)) for v in np.unique(
                    (signs >> lay.La) & ((1 << lay.Lr) - 1)))
            else:
                row_vecs.update((mr, mt, int(v)) for v in np.unique(
                    signs & ((1 << lay.La) - 1)))
    # matrices are deduplicated by content across sectors: low matrices
    # and cross matrices depend only on the low-half weight(s), so count
    # unique na values, not per-sector copies (the JAX package's count; the
    # build shares no matrix between ka and La - ka, whose na agree, so
    # over ranks _ring_matrix_entries counts by ka); high (row)
    # matrices are genuinely per sector pair (internal + two boundary
    # families)
    high = P * 3 * int(np.sum(nb ** 2))
    diag = (2 if diag_imag else 1) * int(np.sum(nb * P * w))
    if world is None:
        una = np.unique(na)
        mats = (1 + 2 * len(cross_mrs)) * int(np.sum(una ** 2))
    else:
        mats = _ring_matrix_entries(plan, lbase.L, lay, secs, P)
    total = cb * (mats + high + diag)
    if world is not None:
        per_so = lambda keys: sum(bin(mr).count('1') + 1
                                  for mr, _t, _s in keys)
        total += P * int(np.sum(nb)) * per_so(col_vecs) * (8 + cb)
        total += P * int(np.sum(w)) * per_so(row_vecs) * cb
    return total


def _ring_matrix_entries(plan, L, lay, secs, P):
    """Entries of the column matrices M the alpha ring holds, summed over
    ``P`` ranks, a bound from the plan's groups alone: the build keys a
    matrix by (mask's high part mr, top bit mt, row-sign part s_r) and
    shares it by content between sectors of one (ka_o, ka_i) (and top bit
    of the output, where a sign reaches it). So each family (mr, mt) holds
    at most one (P w_o, P w_i) matrix per sign part (parts that differ
    only inside a one-bit mr merge: their row scales agree up to sign),
    per output (t, ka_o), per ka_i its masks reach (ka_i - ka_o = d with
    |d| <= popcount(ma), |d| <= popcount(mr) + mt, d of popcount(ma)'s
    parity), and a second for an imaginary part."""
    La, Lr = lay.La, lay.Lr
    families = {}   # (mr, mt) -> [{d}, {s_r}, top sign, planes]
    for m, _pm, signs, coeffs in plan.groups:
        mt, mr, ma = _split_mask(int(m), L, La, Lr)
        if not ma:
            continue
        fam = families.setdefault((mr, mt), [set(), set(), False, 1])
        p = popcount(ma)
        reach = min(p, popcount(mr) + mt)
        fam[0].update(d for d in range(-reach, reach + 1) if (d - p) % 2 == 0)
        signs = np.asarray(signs, dtype=np.int64)
        keep = ~mr if popcount(mr) == 1 else -1
        fam[1].update(int(v) for v in np.unique(
            (signs >> La) & ((1 << Lr) - 1) & keep))
        fam[2] |= bool(np.any((signs >> (L - 1)) & 1))
        if np.any(np.abs(np.imag(coeffs)) > 0):
            fam[3] = 2
    padded = {int(lay.ka[s]): P * -(-int(lay.na[s]) // P) for s in secs}
    total = 0
    for ds, s_rs, top, planes in families.values():
        outs = {(int(lay.t[s]) if top else 0, int(lay.ka[s])) for s in secs}
        for _t, ka_o in outs:
            total += planes * len(s_rs) * padded[ka_o] * sum(
                padded.get(ka_o + d, 0) for d in ds)
    return total


class SectorPlan:
    """Host-side decomposition of an apply plan into sector channels. The
    matrices are numpy arrays of ``real_dtype`` (a torch or numpy real
    dtype); the diagonal field is computed on ``device`` and kept there,
    unless ``with_diag`` is False: then ``diag`` is None and
    ``diag_terms`` (the mask-0 terms, (coefficient, sign) pairs) give it
    at any rows (:func:`diagonal_at`, the alpha ring's per-rank
    diagonal)."""

    def __init__(self, plan, left, right, real_dtype, device='cpu',
                 with_diag=True):
        with tracing.span('build.sector_plan'):
            self._build(plan, left, right, real_dtype, device, with_diag)

    def _build(self, plan, left, right, real_dtype, device, with_diag):
        """The build, stage by stage, each a child span of
        ``build.sector_plan``: the sector layout and the half-state
        enumerations (``.states``), the channel matrices (``.channels``),
        their merging (``.merge``), the diagonal field (``.diagonal``) and
        the sharing of equal matrices (``.dedup``)."""
        with tracing.span('build.sector_plan.states'):
            real_dtype = _np_dtype(real_dtype)
            lbase, self.xparity = _resolve(left)
            L, k = lbase.L, lbase.k
            lay = sec_mod.layout(L, k)
            self.lay = lay
            self.dim = plan.dim_left
            self.real_dtype = real_dtype

            La, Lr = lay.La, lay.Lr
            nck = sec_mod.nchoosek_table(L, k)

            # participating sectors (XParity: only t=0 representatives — the
            # reduced MSC's masks have the top bit clear, subspaces.reduce_msc)
            self.secs = [s for s in range(lay.n_sectors)
                         if not (self.xparity and lay.t[s])]
            self.sec_index = {s: i for i, s in enumerate(self.secs)}
            assert lay.off[self.secs[0]] == 0
            last = self.secs[-1]
            assert lay.off[last] + lay.nb[last] * lay.na[last] == self.dim

            # cached half-state enumerations and ranks
            hr_lists = {}   # kr -> sorted Lr-bit states
            sa_lists = {}   # ka -> sorted La-bit states

            def hr_of(kr):
                if kr not in hr_lists:
                    hr_lists[kr] = sec_mod.states_of_popcount(Lr, kr)
                return hr_lists[kr]

            def sa_of(ka):
                if ka not in sa_lists:
                    sa_lists[ka] = sec_mod.states_of_popcount(La, ka)
                return sa_lists[ka]

            def rank_r(x):
                return sec_mod.rank_bits(x, Lr, nck, k)

            def rank_a(x):
                return sec_mod.rank_bits(x, La, nck, k)

            # every participating sector's half-state lists, as the channel
            # loop and the merge read them
            for s in self.secs:
                hr_of(lay.kr[s])
                sa_of(lay.ka[s])

        with tracing.span('build.sector_plan.channels'):
            # channel accumulators
            colmm = {}     # (si, so, mr, mt, s_r) -> M_cplx
            rowmm = {}     # (si, so, s_a) -> N_cplx
            diag_terms = []
            # exact build byproduct (reference CheckConserves)
            conserved = True

            for m, _perm, signs, coeffs in plan.groups:
                m = int(m)
                scale = float(np.sum(np.abs(coeffs)))
                tol = _TOL * max(scale, 1e-300)
                if m == 0:
                    diag_terms.extend(
                        (complex(c), int(s)) for s, c in zip(signs, coeffs))
                    continue
                mt, mr, ma = _split_mask(m, L, La, Lr)
                if self.xparity:
                    assert mt == 0  # guaranteed by XParity.reduce_msc
                s_tops = (np.asarray(signs, dtype=np.int64) >> (L - 1)) & 1
                s_rs = (np.asarray(signs, dtype=np.int64) >> La) \
                    & ((1 << Lr) - 1)
                s_as = np.asarray(signs, dtype=np.int64) & ((1 << La) - 1)

                for so in self.secs:
                    t_o, kr_o, ka_o = lay.t[so], lay.kr[so], lay.ka[so]
                    t_b = t_o ^ mt
                    sa_o = sa_of(ka_o)
                    sa_b = sa_o ^ ma
                    pcb = popcount(sa_b)
                    hr_o = hr_of(kr_o)
                    hr_b = hr_o ^ mr
                    kr_b = popcount(hr_b) if mr else np.full(len(hr_o), kr_o)

                    if ma:
                        # column-matrix channels: one per realizable input
                        # sector; terms subgrouped by the row part of the sign
                        # (within a subgroup the row factor is shared, so the
                        # alpha action is a single matrix)
                        ra_b = rank_a(np.where(pcb <= k, sa_b, 0))
                        subs = []  # (s_r, fa) per subgroup, beta-independent
                        for s_r in np.unique(s_rs):
                            tsel = s_rs == s_r
                            w_top = 1 - 2.0 * ((t_b * s_tops[tsel]) & 1)
                            wa = 1 - 2.0 * parity(
                                sa_b[:, None] & s_as[None, tsel])
                            subs.append((int(s_r),
                                         wa @ (coeffs[tsel] * w_top)))
                        for kr_i in np.unique(kr_b):
                            ka_i = k - t_b - kr_i
                            slot = t_b * (Lr + 1) + kr_i
                            si = int(lay.sec_tk[slot]) \
                                if 0 <= ka_i <= La else -1
                            live = si >= 0 and si in self.sec_index
                            csel = (pcb == ka_i) if live \
                                else np.zeros(len(sa_b), bool)
                            # transitions leaving the subspace are dropped;
                            # the operator conserves the sector only if their
                            # total weight (summed over sign subgroups, which
                            # can cancel) vanishes — reconstructed exactly as
                            # a sum of outer products on the dropped entries
                            if conserved and any(
                                    np.any(np.abs(fa[~csel]) > tol)
                                    for _sr, fa in subs):
                                brow = np.nonzero(kr_b == kr_i)[0]
                                F = np.zeros((len(brow), int((~csel).sum())),
                                             dtype=np.complex128)
                                for s_r, fa in subs:
                                    wr = 1 - 2.0 * parity(hr_b[brow] & s_r)
                                    F += np.outer(wr, fa[~csel])
                                if np.any(np.abs(F) > tol):
                                    conserved = False
                            if not live or not np.any(csel):
                                continue
                            rows = np.nonzero(csel)[0]
                            for s_r, fa in subs:
                                if not np.any(np.abs(fa[rows]) > 0):
                                    continue
                                key = (si, so, mr, mt, s_r)
                                M = colmm.get(key)
                                if M is None:
                                    M = np.zeros((lay.na[so], lay.na[si]),
                                                 dtype=np.complex128)
                                    colmm[key] = M
                                np.add.at(M, (rows, ra_b[rows]), fa[rows])
                    else:
                        # row-matrix channels (mask confined to the high bits):
                        # alpha is untouched, so the live channel needs
                        # ka_i == ka_o; terms subgrouped by the low sign part
                        subs = []  # (s_a, fb) per subgroup, alpha-independent
                        for s_a in np.unique(s_as):
                            tsel = s_as == s_a
                            w_top = 1 - 2.0 * ((t_b * s_tops[tsel]) & 1)
                            wr = 1 - 2.0 * parity(
                                hr_b[:, None] & s_rs[None, tsel])
                            subs.append((int(s_a),
                                         wr @ (coeffs[tsel] * w_top)))
                        rb_b = rank_r(np.where(kr_b <= k, hr_b, 0))
                        for kr_i in np.unique(kr_b):
                            ka_i = k - t_b - kr_i
                            slot = t_b * (Lr + 1) + kr_i
                            si = int(lay.sec_tk[slot]) \
                                if 0 <= ka_i <= La else -1
                            live = (si >= 0 and si in self.sec_index
                                    and ka_i == ka_o)
                            rsel = kr_b == kr_i
                            if not live:
                                brow = np.nonzero(rsel)[0]
                                if conserved and any(
                                        np.any(np.abs(fb[brow]) > tol)
                                        for _sa, fb in subs):
                                    F = np.zeros((len(brow), len(sa_o)),
                                                 dtype=np.complex128)
                                    for s_a, fb in subs:
                                        wa = 1 - 2.0 * parity(sa_o & s_a)
                                        F += np.outer(fb[brow], wa)
                                    if np.any(np.abs(F) > tol):
                                        conserved = False
                                continue
                            rows = np.nonzero(rsel)[0]
                            for s_a, fb in subs:
                                if not np.any(np.abs(fb[rows]) > 0):
                                    continue
                                key = (si, so, s_a)
                                N = rowmm.get(key)
                                if N is None:
                                    N = np.zeros((lay.nb[so], lay.nb[si]),
                                                 dtype=np.complex128)
                                    rowmm[key] = N
                                np.add.at(N, (rows, rb_b[rows]), fb[rows])

            self.conserved = conserved

        with tracing.span('build.sector_plan.merge'):
            # ---- finalize channels ------------------------------------------
            # column channels need the row gather index and a row scale (the
            # validity mask times the rest-part Walsh sign). Subgroups whose
            # row scales agree up to a global sign merge into one channel with
            # the sign folded into the matrix — e.g. the XX and YY parts of a
            # boundary hop, whose sign bits sit inside the mask and are
            # therefore constant on each channel.
            pre = {}
            pre_order = []
            for (si, so, mr, mt, s_r), M in colmm.items():
                if not np.any(np.abs(M) > 0):
                    continue
                kr_i = lay.kr[si]
                hr_o = hr_of(lay.kr[so])
                hr_b = hr_o ^ mr
                valid = popcount(hr_b) == kr_i
                bidx = np.where(valid, rank_r(np.where(valid, hr_b, 0)), 0)
                w = ((1 - 2.0 * parity(hr_b & s_r)) * valid).astype(np.float64)
                sign = 1.0
                nzi = np.nonzero(w)[0]
                if len(nzi) and w[nzi[0]] < 0:
                    sign = -1.0
                wc = w * sign + 0.0  # +0.0 canonicalizes -0.0 on masked rows
                bidx_arr = None if (mr == 0 and np.all(valid)) \
                    else bidx.astype(np.int32)
                key = (si, so,
                       None if bidx_arr is None else bidx_arr.tobytes(),
                       wc.tobytes())
                ent = pre.get(key)
                if ent is None:
                    pre[key] = [bidx_arr, wc, sign * M]
                    pre_order.append(key)
                else:
                    ent[2] = ent[2] + sign * M

            self.col_channels = []   # (si, so, bidx|None, W|None, Mr, Mi|None)
            for key in pre_order:
                si, so = key[0], key[1]
                bidx_arr, wc, M = pre[key]
                if not np.any(np.abs(M) > 0):
                    continue
                W = None if np.all(wc == 1.0) else wc.astype(real_dtype)
                Mr = np.ascontiguousarray(M.real, dtype=real_dtype)
                Mi = np.ascontiguousarray(M.imag, dtype=real_dtype) \
                    if np.any(np.abs(M.imag) > 0) else None
                self.col_channels.append((si, so, bidx_arr, W, Mr, Mi))

            # row channels: same merging on the column scale
            rpre = {}
            rpre_order = []
            for (si, so, s_a), N in rowmm.items():
                if not np.any(np.abs(N) > 0):
                    continue
                sa_o = sa_of(lay.ka[so])
                ca = (1 - 2.0 * parity(sa_o & s_a)).astype(np.float64)
                sign = 1.0
                if ca[0] < 0:
                    sign = -1.0
                cc = ca * sign
                key = (si, so, cc.tobytes())
                ent = rpre.get(key)
                if ent is None:
                    rpre[key] = [cc, sign * N]
                    rpre_order.append(key)
                else:
                    ent[1] = ent[1] + sign * N

            self.row_channels = []   # (si, so, ca|None, Nr, Ni|None)
            for key in rpre_order:
                si, so = key[0], key[1]
                cc, N = rpre[key]
                if not np.any(np.abs(N) > 0):
                    continue
                ca_arr = None if np.all(cc == 1.0) else cc.astype(real_dtype)
                Nr = np.ascontiguousarray(N.real, dtype=real_dtype)
                Ni = np.ascontiguousarray(N.imag, dtype=real_dtype) \
                    if np.any(np.abs(N.imag) > 0) else None
                self.row_channels.append((si, so, ca_arr, Nr, Ni))

        with tracing.span('build.sector_plan.diagonal'):
            # ---- diagonal stream --------------------------------------------
            # built on device with torch ops over the index map — the host
            # equivalent moves O(nterms * dim) complex doubles and dominated
            # the JAX package's build at large L (the reference's
            # PrecomputeDiagonal analog, bpetsc_template_1.c:169-202)
            self.diag = None
            self.diag_terms = diag_terms
            if diag_terms and with_diag:
                self.diag = self._diagonal(plan, device)

        with tracing.span('build.sector_plan.dedup'):
            self._dedup()

    def _diagonal(self, plan, device):
        dtype = torch.float64 if self.real_dtype == np.float64 \
            else torch.float32
        return diagonal_at(plan, self.diag_terms, torch.arange(
            self.dim, dtype=torch.int64, device=device), dtype)

    def with_diagonal(self, plan, device):
        """This plan with its diagonal field on ``device`` (a copy sharing
        every matrix): the one-device engine's plan from the alpha ring's,
        built without it, with no second host build."""
        out = copy.copy(self)
        if self.diag_terms and self.diag is None:
            out.diag = self._diagonal(plan, device)
        return out

    def _dedup(self):
        """Share identical matrices across channels (the low matrices, for
        one, depend only on the sector's low-half weight)."""
        pool = {}

        def share(a):
            if a is None:
                return None
            key = (a.shape, a.dtype.str, hash(a.tobytes()))
            got = pool.get(key)
            if got is not None and np.array_equal(got, a):
                return got
            pool[key] = a
            return a

        self.col_channels = [
            (si, so, share(b), share(w), share(mr), share(mi))
            for si, so, b, w, mr, mi in self.col_channels]
        self.row_channels = [
            (si, so, share(ca), share(nr), share(ni))
            for si, so, ca, nr, ni in self.row_channels]

    @property
    def table_bytes(self):
        seen = set()
        total = 0
        for ch in self.col_channels:
            for a in ch[2:]:
                if a is not None and id(a) not in seen:
                    seen.add(id(a))
                    total += a.nbytes
        for ch in self.row_channels:
            for a in ch[2:]:
                if a is not None and id(a) not in seen:
                    seen.add(id(a))
                    total += a.nbytes
        if self.diag is not None:
            total += sum(d.nbytes for d in self.diag if d is not None)
        return total

    @property
    def n_channels(self):
        return len(self.col_channels) + len(self.row_channels)


def diagonal_at(plan, diag_terms, rows, dtype):
    """(Dr, Di|None) of the diagonal field D[row] = sum_t c_t
    (-1)^{pc(state(row) & s_t)} at the global rows ``rows`` (an int64
    tensor on the device; a row < 0 gets 0), in row chunks: every row for
    the one-device engine, the alpha ring's rows in its own layout."""
    has_imag = any(abs(c.imag) > 0 for c, _s in diag_terms)
    dr = torch.zeros(rows.shape, dtype=dtype, device=rows.device)
    di = torch.zeros_like(dr) if has_imag else None
    for start in range(0, len(rows), 1 << CHUNK_BITS):
        sl = slice(start, start + (1 << CHUNK_BITS))
        r = rows[sl]
        ok = (r >= 0).to(dtype)
        states = plan.row_states(r.clamp(min=0))
        for c, s in diag_terms:
            w = (1 - 2 * parity_t(states & s)).to(dtype) * ok
            if c.real:
                dr[sl] += c.real * w
            if has_imag and c.imag:
                di[sl] += c.imag * w
    return dr, di


def build_sector_apply(plan, left, right):
    """Returns the sector engine's :class:`SectorTables` (its apply is
    :func:`sector_apply`) and its SectorPlan, or (None, None) when
    unsupported or over the table budget. The plan is built in
    ``config.real_dtype`` with its diagonal on ``config.device``."""
    from .. import config

    if not sector_supported(plan, left, right):
        return None, None
    if table_bytes_estimate(plan, left, right) > TABLE_BUDGET:
        return None, None

    sp = SectorPlan(plan, left, right, config.real_dtype, config.device)
    return SectorTables(sp), sp


class SectorTables:
    """The channels of a :class:`SectorPlan` as the apply runs them.

    * ``blocks`` — (offset, nb, na) of each participating sector in x and y;
    * ``col_channels`` — [(si, so, bidx, W, Mr, Mi)];
    * ``row_channels`` — [(si, so, ca, Nr, Ni)];

    with si, so indices into ``blocks``. Arrays stay the plan's numpy arrays
    until :meth:`on` copies them to a (dtype, device), once each.
    ``graphs`` holds :func:`sector_apply`'s CUDA graph of these channels
    per (dtype, device), with its staging buffers; a copy
    (``copy.copy``) starts with none."""

    def __init__(self, sp):
        self.plan = sp
        secs = sp.secs
        base_off = int(sp.lay.off[secs[0]])
        self.blocks = [(int(sp.lay.off[s]) - base_off, int(sp.lay.nb[s]),
                        int(sp.lay.na[s])) for s in secs]
        self.col_channels = [(sp.sec_index[si], sp.sec_index[so], b, w, mr,
                              mi) for si, so, b, w, mr, mi in sp.col_channels]
        self.row_channels = [(sp.sec_index[si], sp.sec_index[so], ca, nr, ni)
                             for si, so, ca, nr, ni in sp.row_channels]
        self._on = {}
        self.graphs = {}

    def __copy__(self):
        """A shallow copy with no graph: a graph replays the channels it
        was captured from, so a copy whose channels are then changed
        captures its own."""
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        out.graphs = {}
        return out

    @property
    def n_matmuls(self):
        """Matrix products per apply: one per channel, and one more for each
        plane of an imaginary part."""
        return sum(1 + (0 if ch[-1] is None else 2)
                   for ch in self.col_channels + self.row_channels)

    @property
    def dense_flops(self):
        """Float operations of the dense products per apply (both planes,
        2 per multiply-add), counted from the matrices' shapes."""
        flops = 0
        for _si, so, _b, _w, mr, mi in self.col_channels:
            flops += 2 * 2 * self.blocks[so][1] * mr.size * (
                1 if mi is None else 2)
        for si, _so, _ca, nr, ni in self.row_channels:
            flops += 2 * 2 * nr.size * self.blocks[si][2] * (
                1 if ni is None else 2)
        return flops

    def on(self, dtype, device):
        """(col_channels, row_channels, diag) with every array a tensor on
        ``device`` (floats in ``dtype``); a matrix shared by several
        channels is copied once. Built once per (dtype, device), in the
        span ``build.upload``, counted in ``build.uploads``."""
        key = (dtype, device)
        if key not in self._on:
            with tracing.span('build.upload'):
                self._upload(key, dtype, device)
        return self._on[key]

    def _upload(self, key, dtype, device):
        tracing.count('build.uploads')
        moved = {}

        def put(a, index=False):
            if a is None:
                return None
            if id(a) not in moved:
                t = torch.as_tensor(a, device=device)
                moved[id(a)] = t.long() if index else t.to(dtype)
            return moved[id(a)]

        diag = self.plan.diag
        self._on[key] = (
            [(si, so, put(b, True), put(w), put(mr), put(mi))
             for si, so, b, w, mr, mi in self.col_channels],
            [(si, so, put(ca), put(nr), put(ni))
             for si, so, ca, nr, ni in self.row_channels],
            None if diag is None else tuple(
                None if d is None else d.to(device=device, dtype=dtype)
                for d in diag))


def sector_apply(x, tables):
    """y = H x on (2, dim) planes by the sector engine of
    :class:`SectorTables`, on x's device and in x's dtype, as a new tensor.

    The tables are uploaded first (:meth:`SectorTables.on`). On a CPU
    tensor, or while the current CUDA stream is capturing a graph of its
    own, the channel loop (:func:`_sector_apply_eager`) runs as torch ops.
    Otherwise the loop is captured once per table set, dtype and device as
    a CUDA graph (:func:`_capture`) and replayed: x is copied into the
    graph's static input, the graph launched, and its static output cloned,
    so no result aliases a buffer that the next apply overwrites. The
    replay runs the same kernels in the same order, so its y is bitwise
    the loop's. Counts one call in ``sector.applies`` (:mod:`..tracing`),
    each capture in ``sector.graph_captures`` and each replay in
    ``sector.graph_replays``; it launches no kernel of its own (the
    products are cuBLAS's)."""
    tables.on(x.dtype, x.device)
    tracing.count('sector.applies')
    if x.device.type != 'cuda' or torch.cuda.is_current_stream_capturing():
        y = x.new_empty(x.shape)
        _sector_apply_eager(x, tables, y)
        return y
    key = (x.dtype, x.device)
    if key not in tables.graphs:
        tables.graphs[key] = _capture(x, tables)
    graph, staging = tables.graphs[key]
    staging.x.copy_(x)
    graph.replay()
    tracing.count('sector.graph_replays')
    return staging.y.clone()


def _sector_apply_eager(x, tables, y):
    """The channel loop: y = H x written into ``y`` (contiguous (2, dim)
    planes like x) by torch ops.

    y starts as D ⊙ x. Each column channel then adds (X_si[bidx] ⊙ W) @ M^T
    (the gather by bidx where the channel has one, the row scale W folded
    into the gathered rows) in place into its output sector's (2, nb, na)
    view of y; each row channel adds N @ (X_si ⊙ ca) the same way. A
    complex matrix takes one product for its real part over both planes
    and one for each plane of its imaginary part."""
    col_channels, row_channels, diag = tables.on(x.dtype, x.device)
    blocks = tables.blocks
    xs = [x[:, o:o + nb * na].view(2, nb, na) for o, nb, na in blocks]
    if diag is None:
        y.zero_()
    else:
        Dr, Di = diag
        torch.mul(x, Dr, out=y)
        if Di is not None:
            y[0].addcmul_(Di, x[1], value=-1)
            y[1].addcmul_(Di, x[0])
    ys = [y[:, o:o + nb * na].view(2, nb, na) for o, nb, na in blocks]

    for si, so, bidx, W, Mr, Mi in col_channels:
        src = xs[si] if bidx is None else xs[si].index_select(1, bidx)
        if W is not None:
            src = src * W[:, None]
        ys[so].baddbmm_(src, Mr.t().expand(2, -1, -1))
        if Mi is not None:
            ys[so][0].addmm_(src[1], Mi.t(), alpha=-1)
            ys[so][1].addmm_(src[0], Mi.t())

    for si, so, ca, Nr, Ni in row_channels:
        src = xs[si] if ca is None else xs[si] * ca
        ys[so].baddbmm_(Nr.expand(2, -1, -1), src)
        if Ni is not None:
            ys[so][0].addmm_(Ni, src[1], alpha=-1)
            ys[so][1].addmm_(Ni, src[0])


class _Staging:
    """The static input ``x`` and output ``y`` of the engine's graphs for
    one (shape, dtype, device), shared by the graphs of every table set of
    that kind."""

    __slots__ = ('x', 'y', '__weakref__')

    def __init__(self, like):
        self.x = torch.zeros_like(like, memory_format=torch.contiguous_format)
        self.y = torch.empty_like(self.x)


# (shape, dtype, device) -> _Staging. The graphs that use a pair hold it,
# and it goes with the last of them, so however many realizations are
# alive (they linger in reference cycles until Python's collector runs),
# they share one input and one output
_staging = weakref.WeakValueDictionary()
# device -> (capture stream, the engine's graphs alive there). The live
# graphs keep their intermediates in one memory pool: they replay one at a
# time on a stream, and none leaves its output there, so each may reuse
# what the others' intermediates used. A capture takes the pool of any
# live graph, and starts a new one when none is left (a pool cannot be
# taken again once its last graph is gone)
_capture_state = {}


def _capture(x, tables):
    """The eager loop of ``tables`` at x's shape, dtype and device captured
    as a CUDA graph over that kind's :class:`_Staging`, with (graph,
    staging) returned. The loop runs once on the capture stream first, so
    its kernels are loaded and cuBLAS has its workspace for that stream
    before the capture. Python's collector is held off during the capture:
    it could free another table set's graph there."""
    device = x.device
    if device not in _capture_state:
        _capture_state[device] = (torch.cuda.Stream(device),
                                  weakref.WeakSet())
    stream, live = _capture_state[device]
    donor = next(iter(live), None)
    pool = None if donor is None else donor.pool()
    key = (tuple(x.shape), x.dtype, device)
    staging = _staging.get(key)
    if staging is None:
        staging = _Staging(x)
        _staging[key] = staging
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        _sector_apply_eager(staging.x, tables, staging.y)
        gc.disable()
        try:
            graph.capture_begin(pool=pool)
            try:
                _sector_apply_eager(staging.x, tables, staging.y)
            finally:
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
    torch.cuda.current_stream(device).wait_stream(stream)
    live.add(graph)
    tracing.count('sector.graph_captures')
    return graph, staging


def sector_apply_reference(x, plan):
    """The sector engine's plain version: y = H x by the row-wise sweep
    that ranks each row's partners on the fly (the JAX package's general
    apply, ``ops/apply.py:360-387``), over chunks of 2**CHUNK_BITS rows.
    For each row and mask group: bra = i2s(row) ^ m, (col, valid) =
    s2i(bra), y += f_m(bra) * valid * x[:, col]. ``plan`` is the
    operator's ``ops.apply._Plan``; x is (2, dim_right)."""
    dim = plan.dim_left
    y = torch.empty((2, dim), dtype=x.dtype, device=x.device)
    for start in range(0, dim, 1 << CHUNK_BITS):
        rows = torch.arange(start, min(start + (1 << CHUNK_BITS), dim),
                            dtype=torch.int64, device=x.device)
        kets = plan.row_states(rows)
        yr = torch.zeros(rows.shape, dtype=x.dtype, device=x.device)
        yi = torch.zeros_like(yr)
        for m, _perm, signs, coeffs in plan.groups:
            bra = kets ^ m
            fr = torch.zeros_like(yr)
            fi = torch.zeros_like(yr)
            for s, c in zip(signs, coeffs):
                w = (1 - 2 * parity_t(bra & int(s))).to(x.dtype)
                fr += float(c.real) * w
                fi += float(c.imag) * w
            col, valid = plan.right_map.s2i(bra)
            xp = x[:, torch.where(valid, col, 0)]
            ok = valid.to(x.dtype)
            fr *= ok
            fi *= ok
            yr += fr * xp[0] - fi * xp[1]
            yi += fr * xp[1] + fi * xp[0]
        y[0, start:start + len(rows)] = yr
        y[1, start:start + len(rows)] = yi
    return y
