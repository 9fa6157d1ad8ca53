"""
Host-side native code of the port: the breadth-first sector discovery of
``subspaces.Auto`` (``csrc/host_bfs.cpp``), built with ``g++`` into
``_build/<hash>/libhost_bfs.so`` at first use and bound with ctypes, as
:mod:`.ops.xor_apply` builds the CUDA library. A failed build raises with
the compiler's log: there is no quiet fallback to a Python loop, which
takes minutes over the 65 M edges of an L=24 sector.
"""

import ctypes
import functools
import os

import numpy as np

from .utils.build import CSRC, build_shared_library

SOURCE = CSRC / 'host_bfs.cpp'
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')


def build_library():
    """Compile ``csrc/host_bfs.cpp`` with g++ (or ``$CXX``) unless the
    library for this source and these flags exists already; returns its
    path (see :func:`.utils.build.build_shared_library`)."""
    return build_shared_library(os.environ.get('CXX', 'g++'), CXX_FLAGS,
                                SOURCE, 'libhost_bfs.so')['path']


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.bfs_sector.restype = ctypes.c_int64
    lib.bfs_sector.argtypes = [i64p, i64p, ctypes.c_int64, i64p, f64p, f64p,
                               ctypes.c_int64, i64p, ctypes.c_int64]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def bfs_sector(group_masks, group_offsets, signs, coeffs, seed,
               capacity=1 << 20):
    """The states reachable from ``seed`` over the operator's hopping graph
    (see ``csrc/host_bfs.cpp``), in discovery order, as int64."""
    lib = _library()
    group_masks = np.ascontiguousarray(group_masks, dtype=np.int64)
    group_offsets = np.ascontiguousarray(group_offsets, dtype=np.int64)
    signs = np.ascontiguousarray(signs, dtype=np.int64)
    coeffs = np.asarray(coeffs, dtype=np.complex128)
    cre = np.ascontiguousarray(coeffs.real)
    cim = np.ascontiguousarray(coeffs.imag)
    while True:
        out = np.empty(capacity, dtype=np.int64)
        n = lib.bfs_sector(_ptr(group_masks, ctypes.c_int64),
                           _ptr(group_offsets, ctypes.c_int64),
                           len(group_masks), _ptr(signs, ctypes.c_int64),
                           _ptr(cre, ctypes.c_double),
                           _ptr(cim, ctypes.c_double), int(seed),
                           _ptr(out, ctypes.c_int64), capacity)
        if n >= 0:
            return out[:n].copy()
        capacity *= 4
