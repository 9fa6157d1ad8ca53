"""
The ELL engine for general subspace pairs (the JAX package's
``ops/ell.py``): Explicit/Auto, projections such as Full -> Parity,
rectangular SpinConserve pairs, many-mask XOR operators that the XOR-dense
engine declines, and SpinConserve operators past the sector engine's limits.

For a fixed (msc, left, right) triple the column of every nonzero is a
static function of the row, col = s2i_right(i2s_left(row) ^ mask), and so
is the Walsh coefficient f_m(bra). The engine computes both once, on the
device, into (G, rows) tables, one line per mask group g
(:func:`build_tables`, the JAX package's layout):

    y[:, r] = sum_g (fr[g, r] + i fi[g, r]) * x[:, cols[g, r]]

Rows whose partner leaves the right subspace hold column 0 and coefficient
0 there; ``fi`` exists only when some coefficient is imaginary. The engine
packs them (:func:`pack_tables`), one block of rows at a time as they are
computed (:func:`build_packed`), into sliced ELL tables (SELL-32,
:class:`SellTables`) that keep only the nonzero entries, each row's in
ascending group order, and every apply runs the hand-written Hopper kernel
``csrc/ell_apply.cu`` over those (:func:`ell_apply`), which replaces the
JAX package's ``lax.scan`` of gathers (``ell.py:252`` ``make_apply``).
Within ``config.ell_budget`` (:func:`table_bytes`, the (G, rows) count as
the JAX package counts it, so both route an operator alike; the packed
tables only ever take less) this is the default route; over it, or with
``config.use_ell = False``, the on-the-fly sweep
(:func:`.apply.general_sweep`) runs instead.

On CUDA tensors :func:`ell_apply` launches the kernel or raises; on CPU
tensors it runs the plain version over the same packed tables,
:func:`sell_apply_reference`. :func:`ell_apply_reference` is the plain
version over the (G, rows) tables, the tests' oracle of the packing.

Over ranks (``ops/apply.py``'s sharded ELL route, the JAX package's
``_build_sharded_ell``) each rank builds the tables of its own rows only:
every builder here takes a global row range ``rows=(start, stop)``, whose
rows at or past the left dimension are the layout's pad rows
(``parallel.mesh``) and get no entry, and blocks are counted from
``start``, so no slice spans two ranks. Columns stay global: a rank's
tables apply to the gathered (2, storage_dim) input, their ``dim_right``.
"""

import ctypes
import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from ..utils.build import CSRC, NVCC_FLAGS, build_shared_library, find_nvcc
from .index_maps import parity

SOURCE = CSRC / 'ell_apply.cu'
TERM_CHUNK = 8        # terms per build step (the JAX package's)
BUILD_CHUNK_BITS = 20  # rows per block of the build (>= 5: whole slices)
REF_CHUNK_BITS = 18   # rows (entries) per gather of the plain versions
SLICE = 32            # rows per slice of the packed tables: one warp
PACK_CHUNK_BITS = 18  # rows per step of the packing


def ell_budget():
    """Bytes of device memory the engine's tables may take."""
    from .. import config
    return config.ell_budget


def chunk_groups(groups):
    """Split mask groups into <= TERM_CHUNK-term build chunks, tracking which
    group each chunk belongs to. Returns (masks, signs, crs, cis, gids, G).
    """
    masks, signs, crs, cis, gids = [], [], [], [], []
    for g, (m, _perm, s, c) in enumerate(groups):
        for start in range(0, len(s), TERM_CHUNK):
            s_pad = np.zeros(TERM_CHUNK, dtype=np.int64)
            c_pad = np.zeros(TERM_CHUNK, dtype=np.complex128)
            piece_s = s[start:start + TERM_CHUNK]
            piece_c = c[start:start + TERM_CHUNK]
            s_pad[:len(piece_s)] = piece_s
            c_pad[:len(piece_c)] = piece_c
            masks.append(int(m))
            signs.append(s_pad)
            crs.append(c_pad.real.copy())
            cis.append(c_pad.imag.copy())
            gids.append(g)
    return (np.asarray(masks, dtype=np.int64), np.stack(signs),
            np.stack(crs), np.stack(cis),
            np.asarray(gids, dtype=np.int32), len(groups))


def table_bytes(plan, storage_rows=None):
    """The tables' bytes as the JAX package estimates them for its budget
    gate: an index (4 bytes up to L = 31, else 8) and two coefficients in
    ``config.real_dtype`` per (row, group), whether or not ``fi`` is
    built, over ``storage_rows`` rows (default the left dimension; over
    ranks, the padded storage length: the whole count, summed over
    ranks)."""
    from .. import config
    rows = plan.dim_left if storage_rows is None else storage_rows
    idx_bytes = 4 if plan.L <= 31 else 8
    cb = config.real_dtype.itemsize
    return len(plan.groups) * rows * (idx_bytes + cb + cb)


def index_dtype(plan):
    """int32 columns unless a dimension reaches 2**31."""
    big = max(plan.dim_left, plan.dim_right) >= 1 << 31
    return torch.int64 if big else torch.int32


def _row_range(plan, rows):
    """(start, stop) of a row range, every row of the plan by default."""
    return (0, plan.dim_left) if rows is None else (int(rows[0]),
                                                     int(rows[1]))


def packed_bound(plan, dtype, rows=None):
    """The most bytes the packed tables of a plan's ``rows`` (see
    :func:`_table_blocks`) can take in ``dtype``: an index and one
    coefficient (two when ``fi`` is built) for every group of every row,
    and the slice pointers. That is the (G, rows) count plus 8 bytes a
    slice of 32 rows; the tables take less wherever a row drops an
    entry."""
    start, stop = _row_range(plan, rows)
    entry = (index_dtype(plan).itemsize
             + dtype.itemsize * (2 if has_imag(plan) else 1))
    return (len(plan.groups) * (stop - start) * entry
            + 8 * (-(-(stop - start) // SLICE) + 1))


def has_imag(plan):
    """Whether any coefficient has an imaginary part (then ``fi`` is
    built)."""
    return any(np.any(c.imag != 0) for _m, _p, _s, c in plan.groups)


def _table_blocks(plan, dtype, device, with_conserves, rows=None):
    """The (G, rows) tables of a plan in blocks of 2**BUILD_CHUNK_BITS rows
    on ``device``: yields (start, cols, fr, fi_or_None, leaves) per block,
    ``start`` counted from the range's first row, each table (G, block
    rows), ``leaves`` a bool tensor when ``with_conserves`` (some row of
    the block leaves the right subspace with a coefficient that does not
    cancel), else None. ``rows`` is a global row range (start, stop),
    every row by default; its rows at or past ``plan.dim_left`` are pad
    rows: column 0, coefficient 0, and they leave nothing. See
    :func:`build_tables`."""
    masks_c, signs_c, cr_c, ci_c, gids, G = chunk_groups(plan.groups)
    fi_needed = bool(np.any(ci_c != 0))
    first, last = _row_range(plan, rows)
    rows_all = last - first
    # the cancellation threshold of each group, from its chunks' scales
    gscale = np.zeros(G)
    np.add.at(gscale, gids, (np.abs(cr_c) + np.abs(ci_c)).sum(axis=1))
    tol = 1e-12 * gscale

    C = 1 << BUILD_CHUNK_BITS
    for start in range(0, rows_all, C):
        stop = min(start + C, rows_all)
        cols = torch.empty((G, stop - start), dtype=index_dtype(plan),
                           device=device)
        fr = torch.empty((G, stop - start), dtype=dtype, device=device)
        fi = torch.empty_like(fr) if fi_needed else None
        leaves = (torch.zeros((), dtype=torch.bool, device=device)
                  if with_conserves else None)
        rows = torch.arange(first + start, first + stop, dtype=torch.int64,
                            device=device)
        real = rows < plan.dim_left if first + stop > plan.dim_left \
            else None
        if real is not None:
            rows = rows.clamp_(max=plan.dim_left - 1)
        kets = plan.row_states(rows)
        c = 0
        while c < len(gids):
            g = int(gids[c])
            bra = kets ^ int(masks_c[c])
            col, valid = plan.right_map.s2i(bra)
            if real is not None:
                valid = valid & real
            f_re = torch.zeros(stop - start, dtype=torch.float64,
                               device=device)
            f_im = torch.zeros_like(f_re) if fi_needed else None
            while c < len(gids) and gids[c] == g:
                # term by term in a fixed order: each product is exact (a
                # sign), so a row's sum does not depend on how many rows
                # the block holds (a matrix product may sum the terms in
                # another order for another shape)
                for t in range(TERM_CHUNK):
                    cr, ci = float(cr_c[c, t]), float(ci_c[c, t])
                    if not (cr or ci):
                        continue
                    w = (1 - 2 * parity(bra & int(signs_c[c, t]))
                         ).to(torch.float64)
                    if cr:
                        f_re.add_(w, alpha=cr)
                    if ci:
                        f_im.add_(w, alpha=ci)
                c += 1
            if with_conserves:
                mag = f_re.abs() if f_im is None else f_re.abs() + f_im.abs()
                out = ~valid if real is None else ~valid & real
                leaves |= (out & (mag > tol[g])).any()
            cols[g] = torch.where(valid, col, 0)
            ok = valid.to(torch.float64)
            fr[g] = f_re * ok
            if fi_needed:
                fi[g] = f_im * ok
        yield start, cols, fr, fi, leaves
        del cols, fr, fi  # before the next block's tables are made


def build_tables(plan, dtype, device, with_conserves=False, rows=None):
    """The (cols, fr, fi) tables of a plan on ``device``: cols a (G, rows)
    int32 tensor (int64 when a dimension reaches 2**31), fr and fi (G,
    rows) in ``dtype``, fi None when every coefficient is real. A group's
    coefficient is summed over its terms in float64, term by term in a
    fixed order (so every row gets the same bits whatever block or rank
    builds it), and cast to ``dtype`` once.

    ``with_conserves`` also returns the conservation flag, computed in the
    same pass: every row's every group either lands inside the right
    subspace or has a coefficient that cancels to within 1e-12 of the
    group's coefficient scale (the JAX package's test). For Hermitian
    operators on a square pair this equals the reference's column-wise
    CheckConserves (bpetsc_template_2.c:990-1056).

    ``rows`` = (start, stop) builds those global rows alone (one rank's,
    pad rows included; see :func:`_table_blocks`).

    The engine itself never holds these tables whole
    (:func:`build_packed`); they are the JAX package's layout, and the
    input of :func:`pack_tables`. Returns (cols, fr, fi_or_None[,
    conserved])."""
    device = torch.device(device)
    start, stop = _row_range(plan, rows)
    shape = (len(plan.groups), stop - start)
    cols = torch.empty(shape, dtype=index_dtype(plan), device=device)
    fr = torch.empty(shape, dtype=dtype, device=device)
    fi = (torch.empty(shape, dtype=dtype, device=device)
          if has_imag(plan) else None)
    leaves = torch.zeros((), dtype=torch.bool, device=device)
    for start, c, f, g, lv in _table_blocks(plan, dtype, device,
                                            with_conserves, rows):
        sl = slice(start, start + c.shape[1])
        cols[:, sl] = c
        fr[:, sl] = f
        if fi is not None:
            fi[:, sl] = g
        if with_conserves:
            leaves |= lv
    if with_conserves:
        return cols, fr, fi, not bool(leaves)
    return cols, fr, fi


class SellTables(NamedTuple):
    """Sliced ELL tables (SELL-32) of one operator: slice ``s`` holds rows
    ``32 s ... 32 s + lanes_s - 1`` (``lanes_s`` = 32 but in the last
    slice, which holds the rows left) in ``width_s`` steps, ``width_s`` the
    most kept entries of any of its rows, column-major: entry ``j`` of row
    ``32 s + l`` lies at ``slice_ptr[s] + lanes_s j + l``. A row's entries
    are its nonzero (G, rows) entries in ascending group order; shorter
    rows are padded with column 0 and coefficient 0.

    ``slice_ptr`` is int64 (n_slices + 1,); ``cols`` int32 (int64 when a
    dimension reaches 2**31), ``fr`` and ``fi`` (None for real
    coefficients) in the working dtype, all (stored,). ``nnz`` counts the
    kept entries, ``stored`` the entries held (nnz plus padding)."""
    slice_ptr: torch.Tensor
    cols: torch.Tensor
    fr: torch.Tensor
    fi: Optional[torch.Tensor]
    rows: int
    dim_right: int
    nnz: int
    stored: int

    @property
    def n_slices(self):
        return len(self.slice_ptr) - 1

    @property
    def nbytes(self):
        """Device bytes of the tables held."""
        return sum(t.numel() * t.element_size()
                   for t in (self.slice_ptr, self.cols, self.fr, self.fi)
                   if t is not None)


def _kept(fr, fi):
    """Which entries carry a nonzero coefficient in the working dtype."""
    return fr != 0 if fi is None else (fr != 0) | (fi != 0)


def _slice_lanes(rows, device):
    """Rows of each slice: 32, the last one the rows left."""
    n_slices = -(-rows // SLICE)
    lanes = torch.full((n_slices,), SLICE, dtype=torch.int64, device=device)
    if n_slices:
        lanes[-1] = rows - SLICE * (n_slices - 1)
    return lanes


def pack_tables(cols, fr, fi, dim_right):
    """Pack (G, rows) tables (:func:`build_tables`) into :class:`SellTables`
    on their device, with torch ops: an entry is kept when ``fr`` or ``fi``
    is nonzero. Two passes over chunks of 2**PACK_CHUNK_BITS rows (the
    rows' counts, then a scatter of each kept entry to its place), so the
    temporaries stay at a few tens of MB beside the input and the
    output. The engine packs one block of rows at a time
    (:func:`build_packed`)."""
    G, rows = cols.shape
    device = cols.device
    lanes = _slice_lanes(rows, device)
    n_slices = len(lanes)
    C = 1 << PACK_CHUNK_BITS
    counts = torch.zeros(n_slices * SLICE, dtype=torch.int32, device=device)
    for start in range(0, rows, C):
        sl = slice(start, min(start + C, rows))
        counts[sl] = _kept(fr[:, sl], None if fi is None else fi[:, sl]
                           ).sum(0, dtype=torch.int32)
    width = counts.view(n_slices, SLICE).amax(1).long()
    slice_ptr = torch.zeros(n_slices + 1, dtype=torch.int64, device=device)
    torch.cumsum(width * lanes, 0, out=slice_ptr[1:])
    stored, nnz = int(slice_ptr[-1]), int(counts.sum(dtype=torch.int64))
    del counts, width
    p_cols = torch.zeros(stored, dtype=cols.dtype, device=device)
    p_fr = torch.zeros(stored, dtype=fr.dtype, device=device)
    p_fi = None if fi is None else torch.zeros_like(p_fr)
    for start in range(0, rows, C):
        sl = slice(start, min(start + C, rows))
        keep = _kept(fr[:, sl], None if fi is None else fi[:, sl])
        r = torch.arange(sl.start, sl.stop, device=device)
        s = r // SLICE
        # entry j of row r: slice_ptr[s] + lanes[s] j + r % 32, j its rank
        # among the row's kept entries in group order
        pos = keep.cumsum(0, dtype=torch.int64).sub_(1).mul_(lanes[s])
        pos += slice_ptr[s] + r % SLICE
        pos = pos[keep]
        p_cols[pos] = cols[:, sl][keep]
        p_fr[pos] = fr[:, sl][keep]
        if fi is not None:
            p_fi[pos] = fi[:, sl][keep]
    return SellTables(slice_ptr, p_cols, p_fr, p_fi, rows, int(dim_right),
                      nnz, stored)


def build_packed(plan, dtype, device, with_conserves=False, rows=None,
                 dim_right=None):
    """The :class:`SellTables` of a plan on ``device``, packed block by
    block as :func:`build_tables` computes its rows: each block of
    2**BUILD_CHUNK_BITS rows (a multiple of 32, so no slice spans two) goes
    through :func:`pack_tables` and is dropped before the next is built,
    and the packed pieces are joined one table at a time at the end. The
    build thus holds at most the packed tables and one block with its
    temporaries, or the packed tables and one more copy of one of them; it
    never holds the (G, rows) tables whole.

    ``rows`` = (start, stop) packs those global rows alone (one rank's,
    see :func:`_table_blocks`), their slices counted from ``start``;
    ``dim_right`` is the width of the x the tables apply to (default the
    right dimension; over ranks, the gathered storage length).

    Returns (tables, the conservation flag of :func:`build_tables` or None,
    the seconds spent packing and joining)."""
    device = torch.device(device)
    start, stop = _row_range(plan, rows)
    if dim_right is None:
        dim_right = plan.dim_right
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == 'cuda' else (lambda: None))
    pieces, leaves, pack_s = [], [], 0.0
    for _start, c, f, g, lv in _table_blocks(plan, dtype, device,
                                             with_conserves, rows):
        sync()
        t0 = time.perf_counter()
        pieces.append(pack_tables(c, f, g, dim_right))
        del c, f, g
        sync()
        pack_s += time.perf_counter() - t0
        if lv is not None:
            leaves.append(lv)
    conserved = (not bool(torch.stack(leaves).any())
                 if with_conserves else None)
    if len(pieces) == 1:
        return pieces[0], conserved, pack_s
    t0 = time.perf_counter()
    offsets = np.cumsum([0] + [p.stored for p in pieces])
    slice_ptr = torch.cat([p.slice_ptr[:-1] + int(o)
                           for p, o in zip(pieces, offsets)]
                          + [pieces[-1].slice_ptr[-1:] + int(offsets[-2])])
    nnz = sum(p.nnz for p in pieces)
    joined = {}
    for name in ('cols', 'fr', 'fi'):
        parts = [getattr(p, name) for p in pieces]
        pieces = [p._replace(**{name: None}) for p in pieces]
        joined[name] = None if parts[0] is None else torch.cat(parts)
        del parts
    sync()
    pack_s += time.perf_counter() - t0
    return (SellTables(slice_ptr, joined['cols'], joined['fr'],
                       joined['fi'], stop - start, int(dim_right), nnz,
                       int(offsets[-1])), conserved, pack_s)


def _key(dtype, device):
    """A (dtype, device) cache key; a CUDA device without an index is the
    current one, as its tensors report it."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return dtype, device


class EllTables:
    """The packed ELL tables (:class:`SellTables`) of one plan, built at
    first use per (dtype, device) and kept (:meth:`on`);
    :meth:`build_conserving` builds the first set with the conservation
    flag. Each build packs its rows block by block (:func:`build_packed`);
    ``build_s`` holds each build's seconds, the packing's included,
    ``pack_s`` the packing's alone. Over ranks, one rank's: ``rows`` its
    global row range and ``dim_right`` the gathered input's width (see
    :func:`build_packed`), and every byte count is that rank's."""

    def __init__(self, plan, rows=None, dim_right=None):
        self.plan = plan
        self.rows = rows
        self.dim_right = dim_right
        self.n_groups = len(plan.groups)
        self.has_fi = has_imag(plan)
        self._tables = {}
        self.build_s = {}
        self.pack_s = {}

    def _build(self, dtype, device, with_conserves):
        key = _key(dtype, device)
        t0 = time.perf_counter()
        with tracing.span('build.ell'):
            tables, conserved, pack_s = build_packed(
                self.plan, dtype, key[1], with_conserves, self.rows,
                self.dim_right)
            if key[1].type == 'cuda':
                torch.cuda.synchronize(key[1])
        self._tables[key] = tables
        self.build_s[key] = time.perf_counter() - t0
        self.pack_s[key] = pack_s
        return conserved

    def build_conserving(self, dtype, device):
        """Build the tables for (dtype, device) and return the conservation
        flag of the same pass."""
        return self._build(dtype, device, True)

    def on(self, dtype, device):
        """The :class:`SellTables` in ``dtype`` on ``device``."""
        key = _key(dtype, device)
        if key not in self._tables:
            self._build(dtype, device, False)
        return self._tables[key]

    def drop(self, dtype, device):
        """Free the tables for (dtype, device)."""
        self._tables.pop(_key(dtype, device), None)

    def nbytes(self, dtype, device=None):
        """Bytes of the tables in ``dtype`` on one device: those held once
        they are built on ``device`` (default ``config.device``); before
        that the most they can hold (:func:`packed_bound`)."""
        if device is None:
            from .. import config
            device = config.device
        key = _key(dtype, device)
        if key in self._tables:
            return self._tables[key].nbytes
        return packed_bound(self.plan, dtype, self.rows)


def ell_apply_reference(x, cols, fr, fi=None):
    """The plain PyTorch version over the (G, rows) tables: y[:, r] =
    sum_g (fr[g, r] + i fi[g, r]) x[:, cols[g, r]] over (2, dim) planes,
    gathered in chunks of 2**REF_CHUNK_BITS rows, so the (2, G, chunk)
    temporaries stay at a few hundred MB at L=24. The oracle of
    :func:`pack_tables`; nothing on the main path runs it."""
    rows = cols.shape[1]
    y = x.new_empty((2, rows))
    C = 1 << REF_CHUNK_BITS
    for start in range(0, rows, C):
        sl = slice(start, min(start + C, rows))
        xp = x[:, cols[:, sl].long()]          # (2, G, chunk)
        f = fr[:, sl]
        yr = (f * xp[0]).sum(0)
        yi = (f * xp[1]).sum(0)
        if fi is not None:
            g = fi[:, sl]
            yr -= (g * xp[1]).sum(0)
            yi += (g * xp[0]).sum(0)
        y[0, sl] = yr
        y[1, sl] = yi
    return y


def sell_apply_reference(x, t):
    """The plain PyTorch version of the kernel, over the packed tables
    ``t`` (:class:`SellTables`): the same y as :func:`ell_apply_reference`.
    The full slices of one width w are gathered together, about
    2**REF_CHUNK_BITS entries at a time, as (w, slices, 32) blocks, both
    planes at once, and summed over w in entry order, as the kernel sums a
    row, so a row's sum does not depend on its slice's width or on how
    many slices share it (a sharded rank's tables give its rows bitwise
    what the whole tables give); a last, narrower slice on its own."""
    lanes = _slice_lanes(t.rows, x.device)
    width = torch.diff(t.slice_ptr) // lanes
    y = x.new_zeros((2, t.rows))
    blocks = []                 # (slices, their width, their lanes)
    full = t.rows // SLICE
    for w in torch.unique(width[:full]).tolist():
        sel = torch.nonzero(width[:full] == w).flatten()
        step = max(1, (1 << REF_CHUNK_BITS) // (SLICE * max(w, 1)))
        blocks += [(sel[i:i + step], w, SLICE)
                   for i in range(0, len(sel), step)]
    if full < t.n_slices:
        blocks.append((torch.tensor([full], device=x.device),
                       int(width[full]), t.rows - SLICE * full))
    for s, w, n in blocks:
        if w == 0:
            continue
        # entry j of lane l of slice s lies at slice_ptr[s] + n j + l
        idx = (t.slice_ptr[s][None, :, None]
               + n * torch.arange(w, device=x.device)[:, None, None]
               + torch.arange(n, device=x.device))          # (w, slices, n)
        xp = x[:, t.cols[idx].long()]                      # (2, w, slices, n)
        f = t.fr[idx]
        g = None if t.fi is None else t.fi[idx]
        acc = x.new_zeros((2, len(s), n))
        for j in range(w):
            acc += f[j] * xp[:, j]
            if g is not None:
                acc[0] -= g[j] * xp[1, j]
                acc[1] += g[j] * xp[0, j]
        rows = (s[:, None] * SLICE + torch.arange(n, device=x.device)
                ).flatten()
        y[:, rows] = acc.view(2, -1)
    return y


def build_library():
    """Compile ``csrc/ell_apply.cu`` into ``_build/<hash>/libell_apply.so``
    unless that file exists already (see
    :func:`..utils.build.build_shared_library`)."""
    return build_shared_library(find_nvcc(), NVCC_FLAGS, SOURCE,
                                'libell_apply.so')


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()['path']))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ell_apply_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, p, p, p, p, p, p,
                                     i64, i64, i64, p]
    lib.ell_apply_launch.restype = ctypes.c_int
    lib.ell_apply_error_string.argtypes = [ctypes.c_int]
    lib.ell_apply_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, t):
    from .xor_apply import _check_card
    _check_card(x, 'ell_apply')
    if x.dim() != 2 or x.shape != (2, t.dim_right):
        raise ValueError(f'ell_apply: x must be (2, {t.dim_right}) planes, '
                         f'got {tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('ell_apply: x must be contiguous')
    if t.cols.dtype not in (torch.int32, torch.int64):
        raise TypeError(f'ell_apply: cols must be int32 or int64, got '
                        f'{t.cols.dtype}')
    if t.slice_ptr.dtype != torch.int64 \
            or t.slice_ptr.shape != (-(-t.rows // SLICE) + 1,):
        raise ValueError('ell_apply: slice_ptr must be int64 with one '
                         'entry per slice and one more')
    for name, v in (('slice_ptr', t.slice_ptr), ('cols', t.cols),
                    ('fr', t.fr), ('fi', t.fi)):
        if v is None:
            continue
        if v.device != x.device:
            raise ValueError(f'ell_apply: {name} is on {v.device}, x on '
                             f'{x.device}')
        if name in ('cols', 'fr', 'fi') and v.shape != (t.stored,):
            raise ValueError(f'ell_apply: {name} has shape '
                             f'{tuple(v.shape)}, expected ({t.stored},)')
        if not v.is_contiguous():
            raise ValueError(f'ell_apply: {name} must be contiguous')
        if name in ('fr', 'fi') and v.dtype != x.dtype:
            raise TypeError(f'ell_apply: {name} is {v.dtype}, x is '
                            f'{x.dtype}')


def ell_apply(x, t):
    """y = A x over the packed tables ``t`` (:class:`SellTables`; see
    :func:`sell_apply_reference`), as a (2, rows) tensor in x's dtype.

    On a CUDA tensor it launches ``csrc/ell_apply.cu`` on the current
    stream (built at first use) and counts one launch in ``ell.launches``
    (:mod:`..tracing`); an input it does not take, a failed build or a
    refused launch raises. On a CPU tensor it runs the plain version."""
    if x.device.type == 'cpu':
        return sell_apply_reference(x, t)
    _check(x, t)
    y = x.new_empty((2, t.rows))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ell_apply_launch(
            int(x.dtype == torch.float64), int(t.cols.dtype == torch.int64),
            int(t.fi is not None), x.data_ptr(), y.data_ptr(),
            t.slice_ptr.data_ptr(), t.cols.data_ptr(), t.fr.data_ptr(),
            t.fi.data_ptr() if t.fi is not None else None,
            t.rows, t.n_slices, t.dim_right, stream)
    if err != 0:
        raise RuntimeError('ell_apply kernel launch failed: '
                           + lib.ell_apply_error_string(err).decode())
    tracing.count('ell.launches')
    return y
