"""
The XOR-mode Pauli-string matvec for Full/Parity subspace pairs: the host
plan, the wrappers of the hand-written Hopper kernel (``csrc/xor_apply.cu``)
and its plain PyTorch version.

This replaces the JAX package's Pallas kernel
(``dynamite_tpu/ops/pallas_apply.py::_build_call``) on both of its routes:
one device (:func:`xor_apply`) and one rank's block of rows in the
distributed path (:func:`xor_apply_sharded`). One term
``y[k] += c * (-1)^parity(bra & s) * x[col]`` reduces, for Full/Parity
pairs, to ``c' * (-1)^parity(k & s_eff) * x[k ^ m']`` over row indices k
(see :func:`_effective_sign_mask`). The plan flattens those into CSR tables,
one entry per mask group:

* ``group_mask[G]`` — the permutation mask m' of each group;
* ``group_start[G+1]`` — each group's slice of the term arrays;
* ``term_s[T]``, ``term_cr[T]``, ``term_ci[T]`` — s_eff and c * const_sign.

For blocks of 2**local_bits rows, :meth:`XorTables.for_layout` splits each
m' into ``m_hi = m' >> local_bits``, the source block, and ``m_lo``, the
permutation inside it. The sign is taken on the global row index, so the
TPU kernel's runtime vector of device-sign parities has no counterpart.

The TPU kernel's block decomposition ("runs" of block offsets, the VMEM
budget search, the +-1 row/lane sign tables, the roll-and-select in-tile
permutation) existed because that chip has no scalar popcount and works on
(8, 128) tiles; Hopper has ``__popc``, so none of it is carried over.

On CUDA tensors the wrappers launch the kernel or raise; on CPU tensors they
run the plain versions.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.bitwise import parity as parity_np
from .index_maps import parity

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / 'csrc' / 'xor_apply.cu'
BUILD_DIR = _PKG_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')
THREADS = 256  # kThreads in the CUDA source
MAX_SOURCES = 64  # kMaxSources in the CUDA source


def _effective_sign_mask(s, m, left, right):
    """Reduce parity(bra & s) to parity(k & s_eff) ^ const over row indices
    k, for XOR-mode subspace pairs.

    Full: bra = k ^ m            -> s_eff = s,        const = parity(m & s)
    Parity: bra = ((k<<1)|pb) ^ m with pb = parity(k) ^ space
        -> s_eff = (s>>1) ^ (all-ones if s&1), folding the parity bit's
           contribution parity(k) into the mask; const collects the m and
           space terms.
    Returns (s_eff, sign) with sign = +-1.
    """
    from .. import subspaces as sp
    if isinstance(left, sp.Full):
        s_eff = int(s)
        const = int(parity_np(np.int64(s & m)))
        return s_eff, 1 - 2 * const
    if isinstance(left, sp.Parity):
        nbits = left.L - 1
        ones = (1 << nbits) - 1
        s_eff = (int(s) >> 1) ^ (ones if (s & 1) else 0)
        const = int(parity_np(np.int64((s >> 1) & (m >> 1))))
        const ^= int(s & 1) & (left.space ^ (int(m) & 1))
        return s_eff, 1 - 2 * const
    raise TypeError('effective sign mask only defined for Full/Parity')


class XorTables:
    """The CSR group/term tables of one XOR-mode plan.

    The host (numpy) arrays drive the plain version; :meth:`on` returns the
    kernel's device copies for one (device, dtype), built once and cached.
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
        self._device_tables = {}
        self._layouts = {}

    @property
    def n_groups(self):
        return len(self.group_mask)

    @property
    def n_terms(self):
        return len(self.term_s)

    def smem_bytes(self, itemsize):
        """Shared memory the kernel stages the tables in (with one source
        pointer per group)."""
        return (8 * (2 * self.n_groups + self.n_terms)
                + 2 * itemsize * self.n_terms + 4 * (self.n_groups + 1))

    def on(self, device, dtype):
        """(group_start, term_s, term_cr, term_ci) tensors."""
        key = (device, dtype)
        if key not in self._device_tables:
            self._device_tables[key] = (
                torch.as_tensor(self.group_start, device=device),
                torch.as_tensor(self.term_s, device=device),
                torch.as_tensor(self.term_cr, device=device).to(dtype),
                torch.as_tensor(self.term_ci, device=device).to(dtype),
            )
        return self._device_tables[key]

    def for_layout(self, local_bits):
        """The tables for blocks of 2**local_bits rows (cached); the whole
        space is ``for_layout(self.nbits)``."""
        if local_bits not in self._layouts:
            self._layouts[local_bits] = ShardedXorTables(self, local_bits)
        return self._layouts[local_bits]


class ShardedXorTables:
    """One layout of :class:`XorTables`: the rows split into blocks of
    ``local_dim = 2**local_bits``, block b held by rank b.

    * ``hi_list`` — the sorted distinct m_hi = m' >> local_bits: the block
      of rank r ^ m_hi is source ``hi_list.index(m_hi)`` of rank r;
    * ``m_lo[G]`` — m' & (local_dim - 1), the permutation inside a block;
    * ``src_idx[G]`` — each group's index into ``hi_list``.
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
        self.hi_list = sorted({int(h) for h in m_hi})
        self.src_idx = np.searchsorted(self.hi_list, m_hi).astype(np.int32)
        self._device_tables = {}

    def on(self, device):
        """(m_lo, src_idx) tensors."""
        if device not in self._device_tables:
            self._device_tables[device] = (
                torch.as_tensor(self.m_lo, device=device),
                torch.as_tensor(self.src_idx, device=device))
        return self._device_tables[device]


def xor_apply_sharded_reference(srcs, tables, row0):
    """The plain PyTorch version of the kernel on one block: rows
    [row0, row0 + local_dim) of y = H x, where ``srcs[i]`` is the (2,
    local_dim) block of x at rows ``row0 ^ (hi_list[i] << local_bits)``
    and ``tables`` a :class:`ShardedXorTables`. x[:, j ^ m_lo] gathers and
    the xor-fold parity of the global row."""
    t = tables.tables
    n = tables.local_dim
    like = srcs[0] if srcs else torch.empty(0, dtype=torch.float64)
    j = torch.arange(n, dtype=torch.int64, device=like.device)
    k = j + int(row0)
    yr = torch.zeros(n, dtype=like.dtype, device=like.device)
    yi = torch.zeros(n, dtype=like.dtype, device=like.device)
    for g, (m, src) in enumerate(zip(tables.m_lo, tables.src_idx)):
        fr = torch.zeros(n, dtype=like.dtype, device=like.device)
        fi = torch.zeros(n, dtype=like.dtype, device=like.device)
        for i in range(t.group_start[g], t.group_start[g + 1]):
            w = (1 - 2 * parity(k & int(t.term_s[i]))).to(like.dtype)
            fr += float(t.term_cr[i]) * w
            fi += float(t.term_ci[i]) * w
        x = srcs[src]
        xp = x[:, j ^ int(m)] if m else x
        yr += fr * xp[0] - fi * xp[1]
        yi += fr * xp[1] + fi * xp[0]
    return torch.stack([yr, yi])


def xor_apply_reference(x, tables):
    """The plain PyTorch version of the kernel: y = H x over (2, dim)
    planes (one block holding every row)."""
    return xor_apply_sharded_reference([x], tables.for_layout(tables.nbits),
                                       0)


def _find_nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for candidate in (shutil.which('nvcc'),
                      os.path.join(cuda_home, 'bin', 'nvcc')):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the XOR kernel is built from csrc/xor_apply.cu')


def build_library():
    """Compile ``csrc/xor_apply.cu`` into ``_build/<hash>/libxor_apply.so``
    unless that file exists already. The hash covers the source and the
    flags. Returns ``{'path', 'seconds', 'log'}``; seconds is 0 when the
    library was already built."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    lib = out_dir / 'libxor_apply.so'
    log = out_dir / 'nvcc.log'
    if lib.exists():
        return {'path': lib, 'seconds': 0.0,
                'log': log.read_text() if log.exists() else ''}
    out_dir.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = out_dir / f'libxor_apply.{os.getpid()}.so'
    t0 = time.perf_counter()
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed with exit code {proc.returncode}:\n'
                           f'{proc.stdout}\n{proc.stderr}')
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return {'path': lib, 'seconds': seconds, 'log': proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library():
    info = build_library()
    lib = ctypes.CDLL(str(info['path']))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.xor_apply_f32, lib.xor_apply_f64):
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), i32, ptr, i64, i64,
                       i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.xor_apply_error_string.argtypes = [ctypes.c_int]
    lib.xor_apply_error_string.restype = ctypes.c_char_p
    return lib


_MAX_SMEM = 232448  # bytes of shared memory one Hopper block can use


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
    if x.device.type != 'cuda':
        raise ValueError(f'xor_apply: unsupported device {x.device}')
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'xor_apply: dtype must be float32 or float64, got '
                        f'{x.dtype}')
    for s in srcs:
        if s.shape != (2, n):
            raise ValueError(f'xor_apply: expected shape (2, {n}), got '
                             f'{tuple(s.shape)}')
        if s.device != x.device or s.dtype != x.dtype:
            raise ValueError('xor_apply: source blocks differ in device or '
                             'dtype')
        if not s.is_contiguous():
            raise ValueError('xor_apply: x must be contiguous')
    if row0 % n or not 0 <= row0 < t.dim:
        raise ValueError(f'xor_apply: row offset {row0} is not a block start')
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError('xor_apply: the kernel is built for sm_90a '
                           '(Hopper); this device is sm_%d%d'
                           % torch.cuda.get_device_capability(x.device))
    if t.smem_bytes(x.element_size()) > _MAX_SMEM:
        raise NotImplementedError(
            f'xor_apply: {t.n_terms} terms exceed the shared-memory tables; '
            'many-mask operators (SYK) need the XOR-dense engine '
            '(ROADMAP.md queue 1, item 9)')
    if -(-n // THREADS) >= 1 << 31:
        raise ValueError('xor_apply: dimension exceeds one launch grid')

    lib = _library()
    start, sgn, cr, ci = t.on(x.device, x.dtype)
    m_lo, src_idx = tables.on(x.device)
    ptrs = (ctypes.c_void_p * len(srcs))(*(s.data_ptr() for s in srcs))
    y = torch.empty_like(x)
    fn = lib.xor_apply_f32 if x.dtype == torch.float32 else lib.xor_apply_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ptrs, len(srcs), y.data_ptr(), n, int(row0), t.n_groups,
                 t.n_terms, m_lo.data_ptr(), src_idx.data_ptr(),
                 start.data_ptr(), sgn.data_ptr(), cr.data_ptr(),
                 ci.data_ptr(), stream)
    if err != 0:
        raise RuntimeError('xor_apply kernel launch failed: '
                           + lib.xor_apply_error_string(err).decode())
    return y


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
    source per entry of ``hi_list`` and the global row offset, and count one
    launch in ``xor_apply_sharded.launches``; CPU tensors run the plain
    version. Nothing falls back: an unusable input or a failed build or
    launch raises."""
    if tables.tables.n_groups == 0:
        raise ValueError('xor_apply_sharded: an operator with no terms has '
                         'no source blocks')
    if srcs[0].device.type == 'cpu':
        return xor_apply_sharded_reference(srcs, tables, row0)
    y = _launch(list(srcs), tables, row0)
    xor_apply_sharded.launches += 1
    return y


xor_apply_sharded.launches = 0
