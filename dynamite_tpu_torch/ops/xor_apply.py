"""
The XOR-mode Pauli-string matvec for Full/Parity subspace pairs, and XParity
over either (its MSC rewritten by ``XParity.reduce_msc``, its rows the
parent's first half): the host plan, the wrappers of the hand-written Hopper
kernels (``csrc/xor_apply.cu``) and their plain PyTorch versions.

This replaces the JAX package's Pallas kernel
(``dynamite_tpu/ops/pallas_apply.py::_build_call``) on both of its routes:
one device (:func:`xor_apply`) and one rank's block of rows in the
distributed path (:func:`xor_apply_sharded`), together with its diagonal
stream (``compute_diagonal``; here :func:`xor_diagonal`). One term
``y[k] += c * (-1)^parity(bra & s) * x[col]`` reduces, for Full/Parity
pairs, to ``c' * (-1)^parity(k & s_eff) * x[k ^ m']`` over row indices k
(see :func:`_effective_sign_mask`). The plan flattens those into CSR tables,
one entry per mask group:

* ``group_mask[G]`` — the permutation mask m' of each group;
* ``group_start[G+1]`` — each group's slice of the term arrays;
* ``term_s[T]``, ``term_cr[T]``, ``term_ci[T]`` — s_eff and c * const_sign.

Once the mask-0 group has ``DIAG_PRECOMPUTE_MIN_TERMS`` terms or more (the
JAX kernel's threshold), it leaves the kernel's group loop: its sum, the
diagonal d(k), is built once per (dtype, device, layout) by its own kernel
and read beside x. That kernel takes each aligned tile of
``2**DIAG_TILE_BITS`` rows as a Walsh-Hadamard transform of the tile's
coefficients by low sign mask (:class:`DiagonalPlan`).

For blocks of 2**local_bits rows, :meth:`XorTables.for_layout` splits each
m' into ``m_hi = m' >> local_bits``, the source block, and ``m_lo``, the
permutation inside it. The sign is taken on the global row index, so the
TPU kernel's runtime vector of device-sign parities has no counterpart.

The kernel factors the sign per tile of ``2**tile_bits`` rows, with R rows
per thread (:func:`tile_shape`); :class:`TilePlan` holds its tables. Each
sign mask splits into s_hi (bits >= tile_bits) and s_lo; a group's terms
that share s_lo merge into one slot, whose coefficient
``C = sum c_t (-1)^parity(k_hi & s_hi_t)`` each tile computes once; the
slots of a group are sorted into R classes by ``s_lo & (R - 1)``, the sign
pattern over the R rows of a thread.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors they
run the plain versions.
"""

import ctypes
import functools

import numpy as np
import torch

from ..utils.bitwise import parity as parity_np
from ..utils.build import CSRC, NVCC_FLAGS, build_shared_library, find_nvcc
from .index_maps import parity

SOURCE = CSRC / 'xor_apply.cu'
THREADS = 256  # kThreads in the CUDA source
VECS = 2  # vectors of R rows per thread (kVecs in the CUDA source)
MAX_SOURCES = 64  # kMaxSources in the CUDA source
# the JAX kernel's threshold for the precomputed diagonal (pallas_apply.py)
DIAG_PRECOMPUTE_MIN_TERMS = 4
# the diagonal kernel's tile: 2**12 rows (kDiagTileBits in the CUDA source)
DIAG_TILE_BITS = 12
# group flags (kComplex, kMixed in the CUDA source)
COMPLEX = 1
MIXED = 2


def _effective_sign_mask(s, m, left, right):
    """Reduce parity(bra & s) to parity(k & s_eff) ^ const over row indices
    k, for XOR-mode subspace pairs.

    Full: bra = k ^ m            -> s_eff = s,        const = parity(m & s)
    Parity: bra = ((k<<1)|pb) ^ m with pb = parity(k) ^ space
        -> s_eff = (s>>1) ^ (all-ones if s&1), folding the parity bit's
           contribution parity(k) into the mask; const collects the m and
           space terms.
    XParity over either reduces as its parent does: its (rewritten) masks
    keep spin L-1 clear, so its rows are the parent's first half.
    Returns (s_eff, sign) with sign = +-1.
    """
    from .. import subspaces as sp
    lbase = left.parent if isinstance(left, sp.XParity) else left
    if isinstance(lbase, sp.Full):
        s_eff = int(s)
        const = int(parity_np(np.int64(s & m)))
        return s_eff, 1 - 2 * const
    if isinstance(lbase, sp.Parity):
        nbits = lbase.L - 1
        ones = (1 << nbits) - 1
        s_eff = (int(s) >> 1) ^ (ones if (s & 1) else 0)
        const = int(parity_np(np.int64((s >> 1) & (m >> 1))))
        const ^= int(s & 1) & (lbase.space ^ (int(m) & 1))
        return s_eff, 1 - 2 * const
    raise TypeError('effective sign mask only defined for Full/Parity')


def tile_shape(local_bits, itemsize):
    """(tile_bits, rows_per_thread) of a launch on blocks of 2**local_bits
    rows: R rows per thread make one 16-byte load per plane (4 in float32,
    2 in float64), each thread takes VECS vectors of them, and a tile is
    THREADS * R * VECS rows; both shrink to fit a smaller block."""
    rows = 16 // itemsize
    tile_bits = min((THREADS * rows * VECS).bit_length() - 1, local_bits)
    return tile_bits, min(rows, 1 << local_bits)


class TilePlan:
    """The kernel's slot tables for tiles of ``2**tile_bits`` rows and R =
    ``rows_per_thread`` rows per thread, over a list of groups, each a pair
    (sign masks, complex coefficients):

    * ``group_flags[G]`` — COMPLEX if a coefficient has an imaginary part,
      MIXED if the group has slots in a sign class other than 0;
    * ``class_start[G*R + 1]`` — slot ranges by group, then by class
      p = s_lo & (R - 1);
    * ``slot_slo[S]`` — each slot's sign mask below tile_bits; slots are
      sorted by (group, class, s_lo);
    * ``slot_term_start[S + 1]``, ``term_shi[T]``, ``term_cr[T]``,
      ``term_ci[T]`` — each slot's terms (in their order in the group), with
      the sign mask from tile_bits up and the coefficient.
    """

    def __init__(self, groups, tile_bits, rows_per_thread):
        R = rows_per_thread
        if R & (R - 1) or R > 1 << tile_bits:
            raise ValueError(f'{R} rows per thread do not divide a tile of '
                             f'2**{tile_bits} rows')
        self.tile_bits = tile_bits
        self.rows_per_thread = R
        lo = (1 << tile_bits) - 1
        flags, cls, slo, starts, shi, coeffs = [], [0], [], [0], [], []
        for signs, cs in groups:
            signs = np.asarray(signs, dtype=np.int64)
            cs = np.asarray(cs, dtype=np.complex128)
            s_lo = signs & lo
            flag = COMPLEX if np.any(cs.imag != 0) else 0
            for p in range(R):
                for v in np.unique(s_lo[(s_lo & (R - 1)) == p]):
                    idx = np.flatnonzero(s_lo == v)
                    slo.append(int(v))
                    shi.extend(signs[idx] & ~np.int64(lo))
                    coeffs.extend(cs[idx])
                    starts.append(len(shi))
                    if p:
                        flag |= MIXED
                cls.append(len(slo))
            flags.append(flag)
        self.group_flags = np.asarray(flags, dtype=np.int32)
        self.class_start = np.asarray(cls, dtype=np.int32)
        self.slot_slo = np.asarray(slo, dtype=np.int32)
        self.slot_term_start = np.asarray(starts, dtype=np.int32)
        self.term_shi = np.asarray(shi, dtype=np.int64)
        coeffs = np.asarray(coeffs, dtype=np.complex128)
        self.term_cr = coeffs.real.copy()
        self.term_ci = coeffs.imag.copy()
        self._device_tables = {}

    @property
    def n_groups(self):
        return len(self.group_flags)

    @property
    def n_slots(self):
        return len(self.slot_slo)

    def smem_bytes(self, itemsize):
        """Shared memory of one tile (``Tile::bytes`` in the CUDA source),
        in 16-byte entries: per group its source pointer and m_lo, then its
        flags and R + 1 class starts; per slot two coefficients and s_lo."""
        def padded(nbytes):
            return -(-nbytes // 16) * 16
        return (self.n_groups * (16 + padded(4 * (self.rows_per_thread + 2)))
                + self.n_slots * padded(2 * itemsize + 4 + (itemsize - 4)))

    def on(self, device, dtype):
        """The tables as tensors on ``device`` (coefficients in ``dtype``),
        built once and cached."""
        key = (device, dtype)
        if key not in self._device_tables:
            self._device_tables[key] = {
                name: torch.as_tensor(getattr(self, name), device=device)
                for name in ('group_flags', 'class_start', 'slot_slo',
                             'slot_term_start', 'term_shi')}
            for name in ('term_cr', 'term_ci'):
                self._device_tables[key][name] = torch.as_tensor(
                    getattr(self, name), device=device).to(dtype)
        return self._device_tables[key]


class DiagonalPlan:
    """The diagonal kernel's tables for tiles of ``2**tile_bits`` rows,
    over the diagonal's terms (sign masks, complex coefficients): the
    terms in CSR by their sign mask below tile_bits, s_lo, one slot per
    distinct s_lo, each slot's terms in their order in the diagonal.

    * ``slot_slo[S]`` — the slots' s_lo, ascending;
    * ``slot_term_start[S + 1]`` — slot j's terms are
      ``slot_term_start[j]:slot_term_start[j + 1]``;
    * ``term_shi[T]``, ``term_cr[T]``, ``term_ci[T]`` — each term's sign
      mask from tile_bits up and its coefficient.

    In the tile whose rows have the high bits k_hi, entry u of
    g = sum over the terms of the slot of u of c_t (-1)^parity(k_hi &
    s_hi) (0 where no slot has u), and the tile's diagonal is the
    Walsh-Hadamard transform of g: d(k_hi + q) = sum_u g[u]
    (-1)^parity(q & u).
    """

    def __init__(self, signs, coeffs, tile_bits):
        signs = np.asarray(signs, dtype=np.int64)
        coeffs = np.asarray(coeffs, dtype=np.complex128)
        lo = (1 << tile_bits) - 1
        s_lo = signs & lo
        order = np.argsort(s_lo, kind='stable')
        slo, counts = np.unique(s_lo, return_counts=True)
        self.tile_bits = tile_bits
        self.slot_slo = slo.astype(np.int32)
        self.slot_term_start = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int32)
        self.term_shi = signs[order] & ~np.int64(lo)
        self.term_cr = coeffs.real[order].copy()
        self.term_ci = coeffs.imag[order].copy()
        self._device_tables = {}

    @property
    def n_slots(self):
        return len(self.slot_slo)

    def on(self, device, dtype):
        """The tables as tensors on ``device`` (coefficients in ``dtype``),
        built once and cached."""
        key = (device, dtype)
        if key not in self._device_tables:
            tables = {name: torch.as_tensor(getattr(self, name),
                                            device=device)
                      for name in ('slot_slo', 'slot_term_start',
                                   'term_shi')}
            for name in ('term_cr', 'term_ci'):
                tables[name] = torch.as_tensor(getattr(self, name),
                                               device=device).to(dtype)
            self._device_tables[key] = tables
        return self._device_tables[key]


class XorTables:
    """The CSR group/term tables of one XOR-mode plan, and the kernel's
    split of them: the diagonal (``use_diag``: the mask-0 group's
    ``diag_s``, ``diag_c``) and the groups of its loop (``kernel_groups``).

    The host (numpy) arrays drive the plain versions; :meth:`tiles` and
    :meth:`diag_plan` give the kernels' tables for one tile shape.
    """

    def __init__(self, plan, left):
        if plan.dim_left != plan.dim_right:
            raise ValueError('XorTables needs a square XOR-mode plan')
        masks, starts, signs, coeffs = [], [0], [], []
        for m_full, perm_mask, group_signs, group_coeffs in plan.groups:
            for s, c in zip(group_signs, group_coeffs):
                s_eff, const_sign = _effective_sign_mask(
                    int(s), int(m_full), left, left)
                signs.append(s_eff)
                coeffs.append(complex(c) * const_sign)
            masks.append(perm_mask)
            starts.append(len(signs))
        self.dim = plan.dim_left
        if self.dim & (self.dim - 1):
            raise ValueError('XorTables needs a power-of-two dimension')
        self.nbits = self.dim.bit_length() - 1
        self.group_mask = np.asarray(masks, dtype=np.int64)
        self.group_start = np.asarray(starts, dtype=np.int32)
        self.term_s = np.asarray(signs, dtype=np.int64)
        coeffs = np.asarray(coeffs, dtype=np.complex128)
        self.term_cr = coeffs.real.copy()
        self.term_ci = coeffs.imag.copy()

        diag = [g for g in range(self.n_groups) if self.group_mask[g] == 0]
        terms = np.concatenate(
            [np.arange(self.group_start[g], self.group_start[g + 1])
             for g in diag]).astype(np.int64) if diag else np.zeros(0, int)
        self.use_diag = len(terms) >= DIAG_PRECOMPUTE_MIN_TERMS
        if not self.use_diag:
            diag, terms = [], terms[:0]
        self.diag_s = self.term_s[terms]
        self.diag_c = coeffs[terms]
        self.has_imag_diag = bool(np.any(self.diag_c.imag != 0))
        self.kernel_groups = np.asarray(
            [g for g in range(self.n_groups) if g not in diag],
            dtype=np.int64)
        self._tiles = {}
        self._layouts = {}
        self._diagonals = {}

    @property
    def n_groups(self):
        return len(self.group_mask)

    @property
    def n_terms(self):
        return len(self.term_s)

    def tiles(self, tile_bits, rows_per_thread):
        """The :class:`TilePlan` of the kernel's groups (cached)."""
        key = ('groups', tile_bits, rows_per_thread)
        if key not in self._tiles:
            sl = [slice(self.group_start[g], self.group_start[g + 1])
                  for g in self.kernel_groups]
            self._tiles[key] = TilePlan(
                [(self.term_s[s], self.term_cr[s] + 1j * self.term_ci[s])
                 for s in sl], tile_bits, rows_per_thread)
        return self._tiles[key]

    def diag_plan(self, tile_bits=DIAG_TILE_BITS):
        """The :class:`DiagonalPlan` of the diagonal (cached)."""
        key = ('diag', tile_bits)
        if key not in self._tiles:
            self._tiles[key] = DiagonalPlan(self.diag_s, self.diag_c,
                                            tile_bits)
        return self._tiles[key]

    def smem_bytes(self, itemsize, local_bits=None):
        """Shared memory one tile of the kernel needs, for blocks of
        2**local_bits rows (the whole space by default)."""
        shape = tile_shape(self.nbits if local_bits is None else local_bits,
                           itemsize)
        return self.tiles(*shape).smem_bytes(itemsize)

    def for_layout(self, local_bits):
        """The tables for blocks of 2**local_bits rows (cached); the whole
        space is ``for_layout(self.nbits)``."""
        if local_bits not in self._layouts:
            self._layouts[local_bits] = ShardedXorTables(self, local_bits)
        return self._layouts[local_bits]


def hi_list(perm_masks, local_bits):
    """The sorted distinct high masks m_hi = m' >> local_bits of a plan's
    permutation masks: over blocks of 2**local_bits rows, the block of rank
    r ^ hi_list[i] is source i of rank r."""
    return sorted({int(m) >> local_bits for m in perm_masks})


class ShardedXorTables:
    """One layout of :class:`XorTables`: the rows split into blocks of
    ``local_dim = 2**local_bits``, block b held by rank b.

    * ``hi_list`` — the sorted distinct m_hi = m' >> local_bits: the block
      of rank r ^ m_hi is source ``hi_list.index(m_hi)`` of rank r;
    * ``m_lo[G]`` — m' & (local_dim - 1), the permutation inside a block;
    * ``src_idx[G]`` — each group's index into ``hi_list``;
    * ``diag_src`` — the source of the own block (m_hi = 0), which the
      diagonal multiplies.
    """

    def __init__(self, tables, local_bits):
        if not 0 <= local_bits <= tables.nbits:
            raise ValueError(f'a block of 2**{local_bits} rows does not fit '
                             f'a space of 2**{tables.nbits}')
        self.tables = tables
        self.local_bits = local_bits
        self.local_dim = 1 << local_bits
        m_hi = tables.group_mask >> local_bits
        self.m_lo = tables.group_mask & (self.local_dim - 1)
        self.hi_list = hi_list(tables.group_mask, local_bits)
        self.src_idx = np.searchsorted(self.hi_list, m_hi).astype(np.int32)
        self.diag_src = self.hi_list.index(0) if tables.use_diag else -1
        self._device_tables = {}
        self._launch_args = {}
        # the plain version's group factors, per (device, dtype, row0), at
        # most PLAIN_CHUNK_ENTRIES entries in all
        self.plain_factors = {}

    def on(self, device):
        """(m_lo, src_idx) tensors of the kernel's groups."""
        if device not in self._device_tables:
            g = self.tables.kernel_groups
            self._device_tables[device] = (
                torch.as_tensor(self.m_lo[g], device=device),
                torch.as_tensor(self.src_idx[g], device=device))
        return self._device_tables[device]


#: Entries of the plain version's (terms, rows) sign table per chunk of
#: rows, and the most entries of group factors one layout keeps.
PLAIN_CHUNK_ENTRIES = 1 << 22


def _group_factors(tables, c0, c1, row0, dtype, device):
    """(groups, parts, c1 - c0) group factors f_g(k) = sum over the
    group's terms, in order, of c (-1)^parity(k & s) at the global rows
    k = row0 + [c0, c1) (the xor-fold parity): their real parts, and their
    imaginary parts unless every coefficient is real (parts 1 or 2)."""
    t = tables.tables
    groups = len(tables.m_lo)

    def dev(a, dt=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    term_group = dev(np.repeat(np.arange(groups), np.diff(t.group_start)))
    parts = [t.term_cr] if not np.any(t.term_ci) else [t.term_cr, t.term_ci]
    coeff = dev(np.stack(parts, 1), dtype)[:, :, None]
    k = torch.arange(c0, c1, dtype=torch.int64, device=device) + int(row0)
    w = (1 - 2 * parity(k & dev(t.term_s)[:, None])).to(dtype)
    f = torch.zeros((groups, len(parts), c1 - c0), dtype=dtype,
                    device=device)
    return f.index_add_(0, term_group, coeff * w[:, None, :])


def xor_apply_sharded_reference(srcs, tables, row0):
    """The plain PyTorch version of the kernel on one block: rows
    [row0, row0 + local_dim) of y = H x, where ``srcs[i]`` is the (2,
    local_dim) block of x at rows ``row0 ^ (hi_list[i] << local_bits)``
    and ``tables`` a :class:`ShardedXorTables`: each group's factor f_g
    (:func:`_group_factors`) times x[:, j ^ m_lo], summed over the groups
    in order (``cumsum``), in chunks of ``PLAIN_CHUNK_ENTRIES // terms``
    rows. A row's value does not depend on the chunk or the layout.

    The factors do not depend on x: the first apply to a block keeps them
    in ``tables.plain_factors`` while all it keeps fits
    ``PLAIN_CHUNK_ENTRIES`` (32 MB in float64), and later applies to that
    block only gather and multiply (PERF.md gives what that saves the
    tutorial's notebook 3 on the CPU)."""
    t = tables.tables
    n = tables.local_dim
    like = srcs[0] if srcs else torch.empty(0, dtype=torch.float64)
    dtype, device = like.dtype, like.device
    groups = len(tables.m_lo)
    if not groups:
        return torch.zeros((2, n), dtype=dtype, device=device)
    chunk = max(1, PLAIN_CHUNK_ENTRIES // max(len(t.term_s), groups))
    starts = range(0, n, chunk)
    key = (str(device), dtype, int(row0))
    kept = tables.plain_factors
    if key not in kept and groups * 2 * n + sum(
            f.numel() for f in kept.values()) <= PLAIN_CHUNK_ENTRIES:
        kept[key] = torch.cat([
            _group_factors(tables, c0, min(n, c0 + chunk), row0, dtype,
                           device) for c0 in starts], 2)
    # each group's source block, its real and imaginary rows
    rows = 2 * tables.src_idx[:, None].astype(np.int64) + np.arange(2)
    x = torch.stack(srcs).reshape(-1, n).index_select(
        0, torch.as_tensor(rows.reshape(-1), device=device))
    x = x.view(groups, 2, n)
    m = torch.as_tensor(tables.m_lo, dtype=torch.int64,
                        device=device)[:, None, None]
    out = []
    for c0 in starts:
        c1 = min(n, c0 + chunk)
        f = kept[key][:, :, c0:c1] if key in kept else _group_factors(
            tables, c0, c1, row0, dtype, device)
        j = torch.arange(c0, c1, dtype=torch.int64, device=device)
        xp = torch.gather(x, 2, (j ^ m).expand(groups, 2, c1 - c0))
        if f.shape[1] == 1:
            terms = f * xp
        else:
            fr, fi, xr, xi = f[:, 0], f[:, 1], xp[:, 0], xp[:, 1]
            terms = torch.stack([fr * xr - fi * xi, fr * xi + fi * xr], 1)
        out.append(terms.cumsum(0)[-1])
    return torch.cat(out, 1)


def xor_apply_reference(x, tables):
    """The plain PyTorch version of the kernel: y = H x over (2, dim)
    planes (one block holding every row)."""
    return xor_apply_sharded_reference([x], tables.for_layout(tables.nbits),
                                       0)


def xor_diagonal_reference(tables, row0, dtype, device):
    """The plain PyTorch version of the diagonal kernel: rows [row0, row0 +
    local_dim) of d(k) = sum_t c_t (-1)^parity(k & s_t) over the diagonal's
    terms of a :class:`ShardedXorTables`, as (1, local_dim) real planes, or
    (2, local_dim) when a coefficient is complex."""
    t = tables.tables
    k = torch.arange(tables.local_dim, dtype=torch.int64,
                     device=device) + int(row0)
    d = torch.zeros((2 if t.has_imag_diag else 1, tables.local_dim),
                    dtype=dtype, device=device)
    for s, c in zip(t.diag_s, t.diag_c):
        w = (1 - 2 * parity(k & int(s))).to(dtype)
        d[0] += float(c.real) * w
        if t.has_imag_diag:
            d[1] += float(c.imag) * w
    return d


def build_library():
    """Compile ``csrc/xor_apply.cu`` into ``_build/<hash>/libxor_apply.so``
    unless that file exists already (see
    :func:`..utils.build.build_shared_library`)."""
    return build_shared_library(find_nvcc(), NVCC_FLAGS, SOURCE,
                                'libxor_apply.so')


class _XorArgs(ctypes.Structure):
    """``XorArgs`` of the CUDA source, field for field."""
    _fields_ = [('src', ctypes.c_void_p * MAX_SOURCES),
                ('n_srcs', ctypes.c_int32),
                ('diag_src', ctypes.c_int32),
                ('y', ctypes.c_void_p),
                ('diag', ctypes.c_void_p),
                ('diag_planes', ctypes.c_int32),
                ('tile_bits', ctypes.c_int32),
                ('local_dim', ctypes.c_int64),
                ('row0', ctypes.c_int64),
                ('rows_per_thread', ctypes.c_int32),
                ('n_groups', ctypes.c_int32),
                ('n_slots', ctypes.c_int32),
                ('pad', ctypes.c_int32)] + [
                    (name, ctypes.c_void_p) for name in (
                        'group_mlo', 'group_src', 'group_flags',
                        'class_start', 'slot_slo', 'slot_term_start',
                        'term_shi', 'term_cr', 'term_ci')]


@functools.lru_cache(maxsize=None)
def _library():
    info = build_library()
    lib = ctypes.CDLL(str(info['path']))
    for fn in (lib.xor_apply_f32, lib.xor_apply_f64, lib.xor_diagonal_f32,
               lib.xor_diagonal_f64):
        fn.argtypes = [ctypes.POINTER(_XorArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.xor_apply_error_string.argtypes = [ctypes.c_int]
    lib.xor_apply_error_string.restype = ctypes.c_char_p
    return lib


_MAX_SMEM = 232448  # bytes of shared memory one Hopper block can use


@functools.lru_cache(maxsize=None)
def _capability(device):
    return torch.cuda.get_device_capability(device)


def _check_card(x, what):
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {x.device}')
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'{what}: dtype must be float32 or float64, got '
                        f'{x.dtype}')
    if _capability(x.device) != (9, 0):
        raise RuntimeError(f'{what}: the kernel is built for sm_90a '
                           '(Hopper); this device is sm_%d%d'
                           % _capability(x.device))


def _args(plan, tables, row0, dtype, device):
    """The XorArgs of a launch over the tables of a :class:`TilePlan`, but
    for the output and the sources."""
    a = _XorArgs()
    a.tile_bits = plan.tile_bits
    a.rows_per_thread = plan.rows_per_thread
    a.local_dim = tables.local_dim
    a.row0 = int(row0)
    a.n_groups = plan.n_groups
    a.n_slots = plan.n_slots
    for name, tensor in plan.on(device, dtype).items():
        setattr(a, name, tensor.data_ptr())
    return a


def _run(fn, args, device, what):
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: '
                           + lib.xor_apply_error_string(err).decode())


def _launch(srcs, tables, row0):
    """Check the inputs, launch the kernel on the current stream and return
    the (2, local_dim) output. Raises on anything it cannot run."""
    t = tables.tables
    n = tables.local_dim
    if len(srcs) != len(tables.hi_list):
        raise ValueError(f'xor_apply: {len(tables.hi_list)} source blocks '
                         f'expected, got {len(srcs)}')
    if len(srcs) > MAX_SOURCES:
        raise NotImplementedError(f'xor_apply: {len(srcs)} source blocks '
                                  f'exceed the kernel\'s {MAX_SOURCES}')
    x = srcs[0]
    _check_card(x, 'xor_apply')
    rows = tile_shape(tables.local_bits, x.element_size())[1]
    for s in srcs:
        if s.shape != (2, n):
            raise ValueError(f'xor_apply: expected shape (2, {n}), got '
                             f'{tuple(s.shape)}')
        if s.device != x.device or s.dtype != x.dtype:
            raise ValueError('xor_apply: source blocks differ in device or '
                             'dtype')
        if not s.is_contiguous():
            raise ValueError('xor_apply: x must be contiguous')
        if s.data_ptr() % (rows * s.element_size()):
            raise ValueError(f'xor_apply: a source block is not aligned to '
                             f'{rows * s.element_size()} bytes')
    if row0 % n or not 0 <= row0 < t.dim:
        raise ValueError(f'xor_apply: row offset {row0} is not a block start')

    a = _XorArgs.from_buffer_copy(_block_args(tables, row0, x.dtype,
                                              x.device))
    for i, s in enumerate(srcs):
        a.src[i] = s.data_ptr()
    a.n_srcs = len(srcs)
    y = torch.empty_like(x)
    a.y = y.data_ptr()
    _run('xor_apply_f32' if x.dtype == torch.float32 else 'xor_apply_f64',
         a, x.device, 'xor_apply')
    return y


def _block_args(tables, row0, dtype, device):
    """The XorArgs of the launches on one block of a
    :class:`ShardedXorTables`, but for the output and the sources: built at
    the block's first launch (with its diagonal stream) and kept on the
    layout per (dtype, device, row0), so a launch only copies it. Every
    pointer in it is to a tensor the tables keep."""
    key = (dtype, device, int(row0))
    if key not in tables._launch_args:
        t = tables.tables
        itemsize = torch.empty((), dtype=dtype).element_size()
        tile_bits, rows = tile_shape(tables.local_bits, itemsize)
        plan = t.tiles(tile_bits, rows)
        if plan.smem_bytes(itemsize) > _MAX_SMEM:
            raise NotImplementedError(
                f'xor_apply: {t.n_terms} terms exceed the shared-memory '
                'tables; many-mask operators (SYK) need the XOR-dense engine '
                '(ROADMAP.md queue 1, item 9)')
        if tables.local_dim >> tile_bits >= 1 << 31:
            raise ValueError('xor_apply: dimension exceeds one launch grid')
        a = _args(plan, tables, row0, dtype, device)
        m_lo, src_idx = tables.on(device)
        a.group_mlo = m_lo.data_ptr()
        a.group_src = src_idx.data_ptr()
        if t.use_diag:
            d = _diagonal(tables, row0, dtype, device)
            a.diag = d.data_ptr()
            a.diag_planes = d.shape[0]
            a.diag_src = tables.diag_src
        tables._launch_args[key] = a
    return tables._launch_args[key]


def _diagonal(tables, row0, dtype, device):
    """The diagonal stream of one block, built at first use and kept on the
    :class:`XorTables` per (dtype, device, row0, local_bits): one plane of
    local_dim rows (two when a coefficient is complex)."""
    cache = tables.tables._diagonals
    key = (dtype, device, int(row0), tables.local_bits)
    if key not in cache:
        cache[key] = xor_diagonal(tables, row0, dtype, device)
    return cache[key]


def _diagonal_args(tables, row0, d):
    """The XorArgs of the diagonal kernel's launch on rows [row0, row0 +
    local_dim) of a :class:`ShardedXorTables`, writing the (planes,
    local_dim) tensor d: the tables of :meth:`XorTables.diag_plan` on d's
    device, in d's dtype."""
    t = tables.tables
    if row0 % tables.local_dim or not 0 <= row0 < t.dim:
        raise ValueError(f'xor_diagonal: row offset {row0} is not a block '
                         'start')
    plan = t.diag_plan()
    on = plan.on(d.device, d.dtype)
    a = _XorArgs()
    a.tile_bits = plan.tile_bits
    a.local_dim = tables.local_dim
    a.row0 = int(row0)
    a.n_slots = plan.n_slots
    for name, tensor in on.items():
        setattr(a, name, tensor.data_ptr())
    a.y = d.data_ptr()
    a.diag_planes = d.shape[0]
    return a


def xor_diagonal(tables, row0, dtype, device):
    """Rows [row0, row0 + local_dim) of the diagonal d(k) of a
    :class:`ShardedXorTables` whose ``use_diag`` is set, as
    :func:`xor_diagonal_reference` gives them.

    On a CUDA device it launches the diagonal kernel (a Walsh-Hadamard
    transform per tile of ``2**DIAG_TILE_BITS`` rows, over the tables of
    :meth:`XorTables.diag_plan`; a block of fewer rows takes its rows of
    the tile that holds it) and counts one launch in
    ``xor_diagonal.launches``; on the CPU it runs the plain version."""
    t = tables.tables
    if not t.use_diag:
        raise ValueError('xor_diagonal: the operator has no diagonal stream')
    device = torch.device(device)
    if device.type == 'cpu':
        return xor_diagonal_reference(tables, row0, dtype, device)
    d = torch.empty((2 if t.has_imag_diag else 1, tables.local_dim),
                    dtype=dtype, device=device)
    _check_card(d, 'xor_diagonal')
    _run('xor_diagonal_f32' if dtype == torch.float32 else 'xor_diagonal_f64',
         _diagonal_args(tables, row0, d), device, 'xor_diagonal')
    xor_diagonal.launches += 1
    return d


xor_diagonal.launches = 0


def xor_apply(x, tables):
    """y = H x for a (2, dim) float32/float64 tensor holding every row: the
    sharded route with one block (one source, row offset 0), so its launches
    count in ``xor_apply_sharded.launches``."""
    if tables.n_groups == 0:
        return torch.zeros_like(x)
    return xor_apply_sharded([x], tables.for_layout(tables.nbits), 0)


def xor_apply_sharded(srcs, tables, row0):
    """Rows [row0, row0 + local_dim) of y = H x, from the source blocks of a
    :class:`ShardedXorTables` (see :func:`xor_apply_sharded_reference`).

    CUDA tensors run the hand-written kernel (built at first use), with one
    source per entry of ``hi_list``, the global row offset and, when the
    operator has one, the block's diagonal stream (built at the block's
    first launch, see :func:`xor_diagonal`); they count one launch in
    ``xor_apply_sharded.launches``. CPU tensors run the plain version.
    Nothing falls back: an unusable input or a failed build or launch
    raises."""
    if tables.tables.n_groups == 0:
        raise ValueError('xor_apply_sharded: an operator with no terms has '
                         'no source blocks')
    if srcs[0].device.type == 'cpu':
        return xor_apply_sharded_reference(srcs, tables, row0)
    y = _launch(list(srcs), tables, row0)
    xor_apply_sharded.launches += 1
    return y


xor_apply_sharded.launches = 0
