"""
The port's host library (``dynamite_tpu_torch/_native.py``,
``csrc/host_bfs.cpp`` and ``csrc/host_sectors.cpp``) against the JAX
package's ``_native`` API and the numpy routes: the same entry points with
the same parameters; the SpinConserve maps bitwise equal to the numpy
layout of both packages (``ops/sectors.py``) over every state of
[0, 2^L), states outside the subspace mapping to -1; ``SpinConserve``
taking the C++ maps at every size; a failed build raising with the
compiler's log.
"""

import inspect
import math

import numpy as np
import pytest

from dynamite_tpu import _native as ref_native
from dynamite_tpu.ops import sectors as ref_sectors

from dynamite_tpu_torch import _native, subspaces
from dynamite_tpu_torch.ops import sectors
from dynamite_tpu_torch.utils import build
from dynamite_tpu_torch.utils.bitwise import parity

API = ['available', 'bfs_sector', 'spinconserve_s2i', 'spinconserve_i2s',
       'parity_and']


@pytest.mark.parametrize('name', API)
def test_api_matches_reference(name):
    assert list(inspect.signature(getattr(_native, name)).parameters) == \
        list(inspect.signature(getattr(ref_native, name)).parameters)


def test_available_builds():
    assert _native.available() is True


CASES = [(1, 0), (1, 1), (2, 1), (5, 2), (7, 0), (7, 7), (9, 4), (12, 5),
         (13, 6)]


@pytest.mark.parametrize('L,k', CASES)
def test_spinconserve_maps_match_numpy(L, k):
    """Every index and every state of [0, 2^L) (and a few beyond it)
    through the C++ maps, bitwise against both packages' numpy layouts."""
    lay = sectors.layout(L, k)
    nck = sectors.nchoosek_table(L, k)
    dim = math.comb(L, k)
    idxs = np.arange(dim, dtype=np.int64)
    states = _native.spinconserve_i2s(idxs, L, k, nck, lay.La, lay.off,
                                      lay.t, lay.kr, lay.ka, lay.na)
    assert states.dtype == np.int64
    assert np.array_equal(states, sectors.idx_to_state(lay, idxs))
    ref_lay = ref_sectors.layout(L, k)
    assert np.array_equal(states, ref_sectors.idx_to_state(ref_lay, idxs))

    every = np.arange(1 << L, dtype=np.int64)
    beyond = np.array([1 << L, (1 << L) | int(states[0]), -1,
                       np.iinfo(np.int64).max], dtype=np.int64)
    got = _native.spinconserve_s2i(np.concatenate([every, beyond]), L, k,
                                   nck, lay.La, lay.off_tk, lay.na_tk)
    numpy_route = sectors.state_to_idx(lay, every)
    assert np.array_equal(got[:len(every)], numpy_route)
    assert np.array_equal(sectors.state_to_idx(lay, beyond), [-1] * 4)
    assert np.all(got[len(every):] == -1)
    # the JAX package's numpy route agrees on every state of [0, 2^L)
    assert np.array_equal(numpy_route,
                          ref_sectors.state_to_idx(ref_lay, every))
    assert np.array_equal(got[states], idxs)


def test_i2s_refuses_indices_outside():
    L, k = 6, 3
    lay = sectors.layout(L, k)
    args = (L, k, sectors.nchoosek_table(L, k), lay.La, lay.off, lay.t,
            lay.kr, lay.ka, lay.na)
    for bad in ([-1], [20]):
        with pytest.raises(ValueError, match='outside'):
            _native.spinconserve_i2s(np.array(bad), *args)
    with pytest.raises(ValueError, match='nchoosek'):
        _native.spinconserve_i2s(np.arange(3), L, k, np.ones((2, 2)),
                                 *args[3:])


def test_parity_and_matches_numpy():
    rng = np.random.RandomState(0)
    states = rng.randint(0, 1 << 62, size=1000, dtype=np.int64)
    for mask in (0, 1, 0b1011, (1 << 40) - 1, (1 << 63) - 1):
        got = _native.parity_and(states, mask)
        assert got.dtype == np.uint8
        assert np.array_equal(got, parity(states & np.int64(mask)))


def test_spinconserve_takes_the_native_maps(monkeypatch):
    """SpinConserve's maps run in C++ at every size, from one entry to all
    3,432 states of SpinConserve(14, 7), with the numpy layout's
    integers. (The JAX package takes its C++ from 1,024 entries; on the
    port the C++ is the faster at every size,
    ``tests/torch_native_timing.py``.)"""
    calls = []
    for name in ('spinconserve_s2i', 'spinconserve_i2s'):
        fn = getattr(_native, name)
        monkeypatch.setattr(_native, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n)
                            or _fn(*a))
    sub = subspaces.SpinConserve(14, 7)
    lay = sub.sector_layout
    idxs = np.arange(sub.get_dimension())
    for n in (len(idxs), 1023, 1):
        states = sub.idx_to_state(idxs[:n])
        assert np.array_equal(sub.state_to_idx(states), idxs[:n])
        assert np.array_equal(states, sectors.idx_to_state(lay, idxs[:n]))
    state = sub.idx_to_state(5)
    assert state == sectors.idx_to_state(lay, np.array([5]))[0]
    assert sub.state_to_idx(state) == 5
    assert calls == ['spinconserve_i2s', 'spinconserve_s2i'] * 4


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setenv('CXX', 'false')
    _native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='false failed'):
            _native.available()
    finally:
        _native._library.cache_clear()
