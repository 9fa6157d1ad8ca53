"""
Host-side native code of the port, with the JAX package's ``_native`` API:
the breadth-first sector discovery of ``subspaces.Auto``
(``csrc/host_bfs.cpp``) and the SpinConserve index maps and batch parity
(``csrc/host_sectors.cpp``). Each source is built with ``g++`` into
``_build/<hash>/`` at first use and bound with ctypes, as
:mod:`.ops.xor_apply` builds the CUDA library. A failed build raises with
the compiler's log: there is no quiet fallback to a Python loop (which
takes minutes over the 65 M edges of an L=24 sector), and
:func:`available` never returns False.
"""

import ctypes
import functools
import os

import numpy as np

from .utils.build import CSRC, build_shared_library

SOURCES = {'host_bfs': CSRC / 'host_bfs.cpp',
           'host_sectors': CSRC / 'host_sectors.cpp'}
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    'host_bfs': {
        'bfs_sector': (ctypes.c_int64,
                       [_i64p, _i64p, ctypes.c_int64, _i64p, _f64p, _f64p,
                        ctypes.c_int64, _i64p, ctypes.c_int64]),
    },
    'host_sectors': {
        'spinconserve_s2i': (None,
                             [_i64p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, _i64p, ctypes.c_int64, _i64p,
                              _i64p, _i64p]),
        'spinconserve_i2s': (None,
                             [_i64p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, _i64p, ctypes.c_int64, _i64p,
                              _i64p, _i64p, _i64p, _i64p, ctypes.c_int64,
                              _i64p]),
        'parity_and': (None, [_i64p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_uint8)]),
    },
}


def build_library(name='host_bfs'):
    """Compile ``csrc/<name>.cpp`` with g++ (or ``$CXX``) unless the library
    for this source and these flags exists already; returns its path (see
    :func:`.utils.build.build_shared_library`)."""
    return build_shared_library(os.environ.get('CXX', 'g++'), CXX_FLAGS,
                                SOURCES[name], f'lib{name}.so')['path']


@functools.lru_cache(maxsize=None)
def _library(name):
    lib = ctypes.CDLL(str(build_library(name)))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def available():
    """Build (or load) both host libraries and return True; a failed build
    raises with the compiler's log."""
    for name in SOURCES:
        _library(name)
    return True


def _ptr(arr, ctype=ctypes.c_int64):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def bfs_sector(group_masks, group_offsets, signs, coeffs, seed,
               capacity=None):
    """The states reachable from ``seed`` over the operator's hopping graph
    (see ``csrc/host_bfs.cpp``), in discovery order, as int64."""
    lib = _library('host_bfs')
    group_masks = _i64(group_masks)
    group_offsets = _i64(group_offsets)
    signs = _i64(signs)
    coeffs = np.asarray(coeffs, dtype=np.complex128)
    cre = np.ascontiguousarray(coeffs.real)
    cim = np.ascontiguousarray(coeffs.imag)
    capacity = capacity or 1 << 20
    while True:
        out = np.empty(capacity, dtype=np.int64)
        n = lib.bfs_sector(_ptr(group_masks), _ptr(group_offsets),
                           len(group_masks), _ptr(signs),
                           _ptr(cre, ctypes.c_double),
                           _ptr(cim, ctypes.c_double), int(seed),
                           _ptr(out), capacity)
        if n >= 0:
            return out[:n].copy()
        capacity *= 4


def _check_tables(L, k, nchoosek, La):
    if not 1 <= L <= 63 or not 0 <= k <= L:
        raise ValueError(f'need 1 <= L <= 63 and 0 <= k <= L, got L={L}, '
                         f'k={k}')
    if nchoosek.ndim != 2 or nchoosek.shape[0] < k + 1 \
            or nchoosek.shape[1] != L + 1:
        raise ValueError(f'nchoosek must be ({k + 1}, {L + 1}), got '
                         f'{nchoosek.shape}')
    if not 0 <= La <= L - 1:
        raise ValueError(f'La={La} outside [0, L - 1]')
    # the kernels index the table with row stride L + 1
    return np.ascontiguousarray(nchoosek[:k + 1])


def spinconserve_s2i(states, L, k, nchoosek, La, off_tk, na_tk):
    """Sector-major rank of each state of SpinConserve(L, k) (the layout of
    :mod:`.ops.sectors`); -1 for a state outside the subspace."""
    L, k, La = int(L), int(k), int(La)
    nchoosek = _check_tables(L, k, _i64(nchoosek), La)
    off_tk, na_tk = _i64(off_tk), _i64(na_tk)
    slots = 2 * (L - La)
    if off_tk.shape != (slots,) or na_tk.shape != (slots,):
        raise ValueError(f'off_tk and na_tk must hold {slots} slots')
    states = _i64(states)
    out = np.empty(states.shape, dtype=np.int64)
    _library('host_sectors').spinconserve_s2i(
        _ptr(states), states.size, L, k, _ptr(nchoosek), La, _ptr(off_tk),
        _ptr(na_tk), _ptr(out))
    return out


def spinconserve_i2s(idxs, L, k, nchoosek, La, sec_off, sec_t, sec_kr,
                     sec_ka, sec_na):
    """The state of each sector-major index of SpinConserve(L, k); every
    index must lie in [0, C(L, k))."""
    L, k, La = int(L), int(k), int(La)
    nchoosek = _check_tables(L, k, _i64(nchoosek), La)
    secs = [_i64(a) for a in (sec_off, sec_t, sec_kr, sec_ka, sec_na)]
    n_sectors = len(secs[0])
    if n_sectors == 0 or any(a.shape != (n_sectors,) for a in secs):
        raise ValueError('the five sector arrays must be non-empty and of '
                         'one length')
    idxs = _i64(idxs)
    dim = int(nchoosek[k, L])
    if idxs.size and (idxs.min() < 0 or idxs.max() >= dim):
        raise ValueError(f'indices outside [0, {dim})')
    out = np.empty(idxs.shape, dtype=np.int64)
    _library('host_sectors').spinconserve_i2s(
        _ptr(idxs), idxs.size, L, k, _ptr(nchoosek), La,
        *(_ptr(a) for a in secs), n_sectors, _ptr(out))
    return out


def parity_and(states, mask):
    """parity(state & mask) of each state, as uint8."""
    states = _i64(states)
    out = np.empty(states.shape, dtype=np.uint8)
    _library('host_sectors').parity_and(_ptr(states), states.size,
                                        int(np.int64(mask)),
                                        _ptr(out, ctypes.c_uint8))
    return out
