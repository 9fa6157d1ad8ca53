"""
The XOR-mode Pauli-string matvec for Full/Parity subspace pairs: the host
plan, the wrapper of the hand-written Hopper kernel (``csrc/xor_apply.cu``)
and its plain PyTorch version.

This replaces the JAX package's Pallas kernel
(``dynamite_tpu/ops/pallas_apply.py::_build_call``). One term
``y[k] += c * (-1)^parity(bra & s) * x[col]`` reduces, for Full/Parity
pairs, to ``c' * (-1)^parity(k & s_eff) * x[k ^ m']`` over row indices k
(see :func:`_effective_sign_mask`). The plan flattens those into CSR tables,
one entry per mask group:

* ``group_mask[G]`` — the permutation mask m' of each group;
* ``group_start[G+1]`` — each group's slice of the term arrays;
* ``term_s[T]``, ``term_cr[T]``, ``term_ci[T]`` — s_eff and c * const_sign.

The TPU kernel's block decomposition ("runs" of block offsets, the VMEM
budget search, the +-1 row/lane sign tables, the roll-and-select in-tile
permutation) existed because that chip has no scalar popcount and works on
(8, 128) tiles; Hopper has ``__popc``, so none of it is carried over.

On a CUDA tensor :func:`xor_apply` launches the kernel or raises; on a CPU
tensor it runs :func:`xor_apply_reference`.
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
        self.group_mask = np.asarray(masks, dtype=np.int64)
        self.group_start = np.asarray(starts, dtype=np.int32)
        self.term_s = np.asarray(signs, dtype=np.int64)
        coeffs = np.asarray(coeffs, dtype=np.complex128)
        self.term_cr = coeffs.real.copy()
        self.term_ci = coeffs.imag.copy()
        self._device_tables = {}

    @property
    def n_groups(self):
        return len(self.group_mask)

    @property
    def n_terms(self):
        return len(self.term_s)

    def smem_bytes(self, itemsize):
        """Shared memory the kernel stages the tables in."""
        return (8 * (self.n_groups + self.n_terms)
                + 2 * itemsize * self.n_terms + 4 * (self.n_groups + 1))

    def on(self, device, dtype):
        """(group_mask, group_start, term_s, term_cr, term_ci) tensors."""
        key = (device, dtype)
        if key not in self._device_tables:
            self._device_tables[key] = (
                torch.as_tensor(self.group_mask, device=device),
                torch.as_tensor(self.group_start, device=device),
                torch.as_tensor(self.term_s, device=device),
                torch.as_tensor(self.term_cr, device=device).to(dtype),
                torch.as_tensor(self.term_ci, device=device).to(dtype),
            )
        return self._device_tables[key]


def xor_apply_reference(x, tables):
    """The plain PyTorch version of the kernel: y = H x over (2, dim) planes,
    with x[:, arange ^ m'] gathers and the xor-fold parity."""
    dim = tables.dim
    k = torch.arange(dim, dtype=torch.int64, device=x.device)
    yr = torch.zeros(dim, dtype=x.dtype, device=x.device)
    yi = torch.zeros(dim, dtype=x.dtype, device=x.device)
    for g, m in enumerate(tables.group_mask):
        fr = torch.zeros(dim, dtype=x.dtype, device=x.device)
        fi = torch.zeros(dim, dtype=x.dtype, device=x.device)
        for t in range(tables.group_start[g], tables.group_start[g + 1]):
            w = (1 - 2 * parity(k & int(tables.term_s[t]))).to(x.dtype)
            fr += float(tables.term_cr[t]) * w
            fi += float(tables.term_ci[t]) * w
        xp = x[:, k ^ int(m)] if m else x
        yr += fr * xp[0] - fi * xp[1]
        yi += fr * xp[1] + fi * xp[0]
    return torch.stack([yr, yi])


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
        fn.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.xor_apply_error_string.argtypes = [ctypes.c_int]
    lib.xor_apply_error_string.restype = ctypes.c_char_p
    return lib


_MAX_SMEM = 232448  # bytes of shared memory one Hopper block can use


def xor_apply(x, tables):
    """y = H x for a (2, dim) float32/float64 tensor.

    A CUDA tensor runs the hand-written kernel (built at first use) and
    counts one launch in ``xor_apply.launches``; a CPU tensor runs
    :func:`xor_apply_reference`. Nothing falls back: an unusable input or a
    failed build or launch raises."""
    if x.device.type == 'cpu':
        return xor_apply_reference(x, tables)
    if x.device.type != 'cuda':
        raise ValueError(f'xor_apply: unsupported device {x.device}')
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'xor_apply: dtype must be float32 or float64, '
                        f'got {x.dtype}')
    if x.shape != (2, tables.dim):
        raise ValueError(f'xor_apply: expected shape (2, {tables.dim}), got '
                         f'{tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('xor_apply: x must be contiguous')
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError('xor_apply: the kernel is built for sm_90a '
                           '(Hopper); this device is sm_%d%d'
                           % torch.cuda.get_device_capability(x.device))
    if tables.smem_bytes(x.element_size()) > _MAX_SMEM:
        raise NotImplementedError(
            f'xor_apply: {tables.n_terms} terms exceed the shared-memory '
            'tables; many-mask operators (SYK) need the XOR-dense engine '
            '(ROADMAP.md queue 1, item 9)')
    if -(-tables.dim // THREADS) >= 1 << 31:
        raise ValueError('xor_apply: dimension exceeds one launch grid')

    lib = _library()
    mask, start, sgn, cr, ci = tables.on(x.device, x.dtype)
    y = torch.empty_like(x)
    fn = lib.xor_apply_f32 if x.dtype == torch.float32 else lib.xor_apply_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), tables.dim, tables.n_groups,
                 tables.n_terms, mask.data_ptr(), start.data_ptr(),
                 sgn.data_ptr(), cr.data_ptr(), ci.data_ptr(), stream)
    if err != 0:
        raise RuntimeError('xor_apply kernel launch failed: '
                           + lib.xor_apply_error_string(err).decode())
    xor_apply.launches += 1
    return y


xor_apply.launches = 0
