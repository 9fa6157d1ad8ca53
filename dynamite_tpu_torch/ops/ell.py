"""
The ELL engine for general subspace pairs (the JAX package's
``ops/ell.py``): Explicit/Auto, projections such as Full -> Parity,
rectangular SpinConserve pairs, many-mask XOR operators that the XOR-dense
engine declines, and SpinConserve operators past the sector engine's limits.

For a fixed (msc, left, right) triple the column of every nonzero is a
static function of the row, col = s2i_right(i2s_left(row) ^ mask), and so
is the Walsh coefficient f_m(bra). The engine computes both once, on the
device, into (G, rows) tables, one line per mask group g:

    y[:, r] = sum_g (fr[g, r] + i fi[g, r]) * x[:, cols[g, r]]

and every apply is one launch of the hand-written Hopper kernel
``csrc/ell_apply.cu`` (:func:`ell_apply`), which replaces the JAX
package's ``lax.scan`` of gathers (``ell.py:252`` ``make_apply``). Rows
whose partner leaves the right subspace hold column 0 and coefficient 0.
``fi`` exists only when some coefficient is imaginary. Within
``config.ell_budget`` (:func:`table_bytes`, counted as the JAX package
counts it, so both route an operator alike) this is the default route;
over it, or with ``config.use_ell = False``, the on-the-fly sweep
(:func:`.apply.general_sweep`) runs instead.

On CUDA tensors :func:`ell_apply` launches the kernel or raises; on CPU
tensors it runs the plain version, :func:`ell_apply_reference`.
"""

import ctypes
import functools
import time

import numpy as np
import torch

from ..utils.build import CSRC, NVCC_FLAGS, build_shared_library, find_nvcc
from .index_maps import parity

SOURCE = CSRC / 'ell_apply.cu'
TERM_CHUNK = 8        # terms per build step (the JAX package's)
BUILD_CHUNK_BITS = 20  # rows per step of the table build
REF_CHUNK_BITS = 18   # rows per gather of the plain version


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


def table_bytes(plan):
    """The tables' bytes as the JAX package estimates them for its budget
    gate: an index (4 bytes up to L = 31, else 8) and two coefficients in
    ``config.real_dtype`` per (row, group), whether or not ``fi`` is
    built."""
    from .. import config
    idx_bytes = 4 if plan.L <= 31 else 8
    cb = config.real_dtype.itemsize
    return len(plan.groups) * plan.dim_left * (idx_bytes + cb + cb)


def index_dtype(plan):
    """int32 columns unless a dimension reaches 2**31."""
    big = max(plan.dim_left, plan.dim_right) >= 1 << 31
    return torch.int64 if big else torch.int32


def has_imag(plan):
    """Whether any coefficient has an imaginary part (then ``fi`` is
    built)."""
    return any(np.any(c.imag != 0) for _m, _p, _s, c in plan.groups)


def build_tables(plan, dtype, device, with_conserves=False):
    """The (cols, fr, fi) tables of a plan on ``device``: cols a (G, rows)
    int32 tensor (int64 when a dimension reaches 2**31), fr and fi (G,
    rows) in ``dtype``, fi None when every coefficient is real. A group's
    coefficient is summed over its TERM_CHUNK-term chunks in float64, as
    the JAX package sums its chunks, and cast to ``dtype`` once.

    ``with_conserves`` also returns the conservation flag, computed in the
    same pass: every row's every group either lands inside the right
    subspace or has a coefficient that cancels to within 1e-12 of the
    group's coefficient scale (the JAX package's test). For Hermitian
    operators on a square pair this equals the reference's column-wise
    CheckConserves (bpetsc_template_2.c:990-1056).

    Returns (cols, fr, fi_or_None[, conserved])."""
    masks_c, signs_c, cr_c, ci_c, gids, G = chunk_groups(plan.groups)
    fi_needed = bool(np.any(ci_c != 0))
    rows_all = plan.dim_left
    device = torch.device(device)
    cols = torch.empty((G, rows_all), dtype=index_dtype(plan), device=device)
    fr = torch.empty((G, rows_all), dtype=dtype, device=device)
    fi = (torch.empty((G, rows_all), dtype=dtype, device=device)
          if fi_needed else None)
    # the cancellation threshold of each group, from its chunks' scales
    gscale = np.zeros(G)
    np.add.at(gscale, gids, (np.abs(cr_c) + np.abs(ci_c)).sum(axis=1))
    tol = 1e-12 * gscale
    signs_d = torch.as_tensor(signs_c, device=device)
    cr_d = torch.as_tensor(cr_c, device=device)
    ci_d = torch.as_tensor(ci_c, device=device)
    leaves = torch.zeros((), dtype=torch.bool, device=device)

    C = 1 << BUILD_CHUNK_BITS
    for start in range(0, rows_all, C):
        stop = min(start + C, rows_all)
        rows = torch.arange(start, stop, dtype=torch.int64, device=device)
        kets = plan.row_states(rows)
        c = 0
        while c < len(gids):
            g = int(gids[c])
            bra = kets ^ int(masks_c[c])
            col, valid = plan.right_map.s2i(bra)
            f_re = torch.zeros(stop - start, dtype=torch.float64,
                               device=device)
            f_im = torch.zeros_like(f_re) if fi_needed else None
            while c < len(gids) and gids[c] == g:
                w = (1 - 2 * parity(bra[:, None] & signs_d[c][None, :])
                     ).to(torch.float64)
                f_re += w @ cr_d[c]
                if fi_needed:
                    f_im += w @ ci_d[c]
                c += 1
            if with_conserves:
                mag = f_re.abs() if f_im is None else f_re.abs() + f_im.abs()
                leaves |= (~valid & (mag > tol[g])).any()
            cols[g, start:stop] = torch.where(valid, col, 0)
            ok = valid.to(torch.float64)
            fr[g, start:stop] = f_re * ok
            if fi_needed:
                fi[g, start:stop] = f_im * ok
    if with_conserves:
        return cols, fr, fi, not bool(leaves)
    return cols, fr, fi


def _key(dtype, device):
    """A (dtype, device) cache key; a CUDA device without an index is the
    current one, as its tensors report it."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return dtype, device


class EllTables:
    """The ELL tables of one plan, built at first use per (dtype, device)
    and kept (:meth:`on`); :meth:`build_conserving` builds the first set
    with the conservation flag. ``build_s`` holds each build's seconds."""

    def __init__(self, plan):
        self.plan = plan
        self.n_groups = len(plan.groups)
        self.has_fi = has_imag(plan)
        self._tables = {}
        self.build_s = {}

    def _build(self, dtype, device, with_conserves):
        key = _key(dtype, device)
        t0 = time.perf_counter()
        out = build_tables(self.plan, dtype, key[1],
                           with_conserves=with_conserves)
        self._tables[key] = out[:3]
        self.build_s[key] = time.perf_counter() - t0
        return out

    def build_conserving(self, dtype, device):
        """Build the tables for (dtype, device) and return the conservation
        flag of the same pass."""
        return self._build(dtype, device, True)[3]

    def on(self, dtype, device):
        """(cols, fr, fi_or_None) in ``dtype`` on ``device``."""
        key = _key(dtype, device)
        if key not in self._tables:
            self._build(dtype, device, False)
        return self._tables[key]

    def drop(self, dtype, device):
        """Free the tables for (dtype, device)."""
        self._tables.pop(_key(dtype, device), None)

    def nbytes(self, dtype):
        """Bytes of the tables in ``dtype`` on one device, built or not."""
        idx = index_dtype(self.plan).itemsize
        coeffs = dtype.itemsize * (2 if self.has_fi else 1)
        return self.n_groups * self.plan.dim_left * (idx + coeffs)


def ell_apply_reference(x, cols, fr, fi=None):
    """The plain PyTorch version of the kernel: y[:, r] = sum_g (fr[g, r] +
    i fi[g, r]) x[:, cols[g, r]] over (2, dim) planes, gathered in chunks
    of 2**REF_CHUNK_BITS rows, so the (2, G, chunk) temporaries stay at a
    few hundred MB at L=24."""
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


def build_library():
    """Compile ``csrc/ell_apply.cu`` into ``_build/<hash>/libell_apply.so``
    unless that file exists already (see
    :func:`..utils.build.build_shared_library`)."""
    return build_shared_library(find_nvcc(), NVCC_FLAGS, SOURCE,
                                'libell_apply.so')


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()['path']))
    p = ctypes.c_void_p
    lib.ell_apply_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, p, p, p, p, p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, p]
    lib.ell_apply_launch.restype = ctypes.c_int
    lib.ell_apply_error_string.argtypes = [ctypes.c_int]
    lib.ell_apply_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, cols, fr, fi):
    from .xor_apply import _check_card
    _check_card(x, 'ell_apply')
    G, rows = cols.shape
    if x.dim() != 2 or x.shape[0] != 2:
        raise ValueError(f'ell_apply: x must be (2, dim) planes, got '
                         f'{tuple(x.shape)}')
    if cols.dtype not in (torch.int32, torch.int64):
        raise TypeError(f'ell_apply: cols must be int32 or int64, got '
                        f'{cols.dtype}')
    for name, t in (('cols', cols), ('fr', fr), ('fi', fi)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f'ell_apply: {name} is on {t.device}, x on '
                             f'{x.device}')
        if t.shape != (G, rows):
            raise ValueError(f'ell_apply: {name} has shape '
                             f'{tuple(t.shape)}, expected {(G, rows)}')
        if not t.is_contiguous():
            raise ValueError(f'ell_apply: {name} must be contiguous')
        if name != 'cols' and t.dtype != x.dtype:
            raise TypeError(f'ell_apply: {name} is {t.dtype}, x is '
                            f'{x.dtype}')
    if not x.is_contiguous():
        raise ValueError('ell_apply: x must be contiguous')
    if G >= 1 << 31:
        raise ValueError('ell_apply: too many groups for one launch')


def ell_apply(x, cols, fr, fi=None):
    """y = A x over ELL tables (see :func:`ell_apply_reference`), as a
    (2, rows) tensor in x's dtype.

    On a CUDA tensor it launches ``csrc/ell_apply.cu`` on the current
    stream (built at first use) and counts one launch in
    ``ell_apply.launches``; an input it does not take, a failed build or a
    refused launch raises. On a CPU tensor it runs the plain version."""
    if x.device.type == 'cpu':
        return ell_apply_reference(x, cols, fr, fi)
    _check(x, cols, fr, fi)
    G, rows = cols.shape
    y = x.new_empty((2, rows))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ell_apply_launch(
            int(x.dtype == torch.float64), int(cols.dtype == torch.int64),
            int(fi is not None), x.data_ptr(), y.data_ptr(),
            cols.data_ptr(), fr.data_ptr(),
            fi.data_ptr() if fi is not None else None,
            rows, x.shape[1], G, stream)
    if err != 0:
        raise RuntimeError('ell_apply kernel launch failed: '
                           + lib.ell_apply_error_string(err).decode())
    ell_apply.launches += 1
    return y


ell_apply.launches = 0
