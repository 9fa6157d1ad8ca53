"""
The port's Explicit and Auto subspaces against the JAX package, on the CPU:
state lists (sorted, unsorted, duplicates, check_L), repr, checksum,
equality and hash; Auto's discovered sectors in both orders and its host
C++ search against the plain numpy BFS; the device index map
(``ExplicitMap``) against the JAX package's; XParity over an Explicit
parent; the infinity norm, the conservation check, RDMs and entropies of
states on them, and state files cross-loaded both ways.

The cases of tests/unit/test_subspaces.py (TestExplicit, TestAuto,
TestAutoBFS, TestReprs, TestChecksum) and
tests/integration/test_subspaces.py:46-96 run here as parametrised cases
over both packages. Inputs are made in numpy and handed to both packages;
host results compare exactly, vectors and norms at 1e-12 (float64).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import operators as ref_ops
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.computations import entanglement_entropy as ref_entropy
from dynamite_tpu.computations import reduced_density_matrix as ref_rdm
from dynamite_tpu.ops.index_maps import ExplicitMap as RefExplicitMap
from dynamite_tpu.states import State as RefState

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import operators as ops
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.computations import (entanglement_entropy,
                                             reduced_density_matrix)
from dynamite_tpu_torch.ops.index_maps import ExplicitMap, device_map
from dynamite_tpu_torch.states import State

# one torch thread per xdist worker (ROADMAP.md queue 3)
torch.set_num_threads(1)

L = 6


@pytest.fixture(autouse=True)
def reset_config():
    """Fresh configs, the port on the CPU, numpy's BLAS at one thread."""
    saved_device = config._device
    config.device = 'cpu'
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    with threadpool_limits(limits=1, user_api='blas'):
        yield
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    config._device = saved_device


def _vec(dim, seed):
    rng = np.random.RandomState(seed)
    v = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    return v / np.linalg.norm(v)


def _both(make):
    """make(subspaces module, models module, operators module) for the
    port and for the JAX package."""
    return (make(subspaces, models, ops),
            make(ref_subspaces, ref_models, ref_ops))


def _states(sub):
    return sub.idx_to_state(np.arange(sub.get_dimension()))


# -- Explicit -------------------------------------------------------------------

EXPLICIT_LISTS = {
    'sorted': [0b00, 0b11, 0b101],
    'unsorted': [0b101, 0b00, 0b11],
    'reversed_sc': None,  # SpinConserve(5, 2)'s states, reversed
}


def _explicit_list(name):
    if name == 'reversed_sc':
        return _states(subspaces.SpinConserve(5, 2))[::-1].copy()
    return EXPLICIT_LISTS[name]


@pytest.mark.parametrize('name', sorted(EXPLICIT_LISTS))
def test_explicit_maps_match_reference(name):
    states = np.asarray(_explicit_list(name), dtype=np.int64)
    n_bits = 5 if name == 'reversed_sc' else 3
    port, ref = _both(lambda sp, _m, _o: sp.Explicit(states, L=n_bits))
    dim = len(states)
    assert port.get_dimension() == ref.get_dimension() == dim
    assert np.array_equal(port.idx_to_state(np.arange(dim)), states)
    assert np.array_equal(port.state_to_idx(states), np.arange(dim))
    probe = np.arange(1 << n_bits)
    assert np.array_equal(port.state_to_idx(probe), ref.state_to_idx(probe))
    assert (port.rmap_indices is None) == (ref.rmap_indices is None)
    assert np.array_equal(port.rmap_states, ref.rmap_states)
    assert port.get_checksum() == ref.get_checksum()
    assert hash(port) == hash(ref)
    assert repr(port) == repr(ref)


@pytest.mark.parametrize('args,match', [
    (([1, 2, 1], 2), 'duplicate'),
    (([0b111], 2), 'more spins'),
])
def test_explicit_errors(args, match):
    for sp in (subspaces, ref_subspaces):
        with pytest.raises(ValueError, match=match):
            sp.Explicit(args[0], L=args[1])


def test_explicit_equality_and_checksum():
    """tests/unit/test_subspaces.py TestExplicit/TestChecksum and
    tests/integration/test_subspaces.py:90-96."""
    for sp in (subspaces, ref_subspaces):
        sc = sp.SpinConserve(5, 2)
        ex = sp.Explicit(_states(sc), L=5)
        assert ex == sc and not ex.identical(sc)
        assert ex.get_checksum() == sc.get_checksum()
        a, b = sp.Explicit([1, 2, 4], L=3), sp.Explicit([4, 2, 1], L=3)
        assert a.get_checksum() != b.get_checksum()
        assert a.identical(a.copy())


def test_explicit_repr():
    """repr evaluates back to an equal subspace, and a long list is cut."""
    Explicit = subspaces.Explicit  # noqa: F841 - for eval
    s = subspaces.Explicit([1, 2, 3], L=3)
    s2 = eval(repr(s))  # noqa: S307 - controlled input
    assert s2 == s and s2.get_dimension() == 3
    port, ref = _both(lambda sp, _m, _o: sp.Explicit(list(range(0, 512, 2)),
                                                     L=10))
    assert repr(port) == repr(ref) and len(repr(port)) < 500


# -- Auto -----------------------------------------------------------------------

AUTO_CASES = [
    ('localized', 8, 'UUUUDDDD'),
    ('localized', 6, 0b000111),
    ('heisenberg', 6, 'UUUDDD'),
    ('ising', 6, 'UUUDDD'),          # one Parity sector of 32 states
    ('long_range', 7, 'UDUDUDU'),
]


@pytest.mark.parametrize('sort', [True, False])
@pytest.mark.parametrize('model,n,seed', AUTO_CASES)
def test_auto_state_lists_match_reference(model, n, seed, sort):
    port, ref = _both(lambda sp, m, _o: sp.Auto(getattr(m, model)(n), seed,
                                                sort=sort))
    assert np.array_equal(port.state_map, ref.state_map)
    assert port.state_map.dtype == np.int64
    assert repr(port) == repr(ref)
    assert port.state == ref.state
    assert port.get_checksum() == ref.get_checksum()


@pytest.mark.parametrize('model,n,seed', AUTO_CASES)
def test_native_bfs_matches_reference_order(model, n, seed):
    """The host C++ search and the plain numpy BFS give the same states in
    the same discovery order."""
    H = getattr(models, model)(n)
    H.reduce_msc()
    seed = State.str_to_state(seed, n)
    native = subspaces._bfs_sector(H.msc, seed)
    plain = subspaces._bfs_sector_reference(H.msc, seed)
    assert np.array_equal(native, plain)
    assert native[0] == seed


def _brute_force_sector(H, seed):
    """All states reachable from seed through nonzero matrix elements."""
    M = np.abs(H.to_numpy(subspaces=(subspaces.Full(L=H.L),) * 2).toarray())
    seen, frontier = {seed}, [seed]
    while frontier:
        nxt = []
        for s in frontier:
            for t in np.nonzero(M[:, s])[0]:
                if int(t) not in seen:
                    seen.add(int(t))
                    nxt.append(int(t))
        frontier = nxt
    return np.array(sorted(seen))


def test_auto_matches_brute_force():
    """tests/integration/test_subspaces.py:46-56."""
    H = models.localized(L)
    seed = int('0b' + '01' * (L // 2), 2)
    sub = subspaces.Auto(H, seed)
    assert np.array_equal(np.sort(_states(sub)), _brute_force_sector(H, seed))
    sc = subspaces.SpinConserve(L, bin(seed).count('1'))
    assert sub == sc and np.array_equal(_states(sub), _states(sc))


@pytest.mark.parametrize('case', ['component', 'diagonal', 'str_int',
                                  'nosort_permutation'])
def test_auto_bfs_cases(case):
    """tests/unit/test_subspaces.py TestAuto and TestAutoBFS, and
    tests/integration/test_subspaces.py:59-76, in both packages."""
    for sp, m, o in ((subspaces, models, ops),
                     (ref_subspaces, ref_models, ref_ops)):
        if case == 'component':
            auto = sp.Auto(m.heisenberg(4), 'UUDD')
            assert auto.get_dimension() == 6
            assert sp.Auto(m.heisenberg(6), 'UUUDDD') == sp.SpinConserve(6, 3)
        elif case == 'diagonal':
            auto = sp.Auto(o.index_sum(o.sigmaz(), size=4), 'UDUD')
            assert auto.get_dimension() == 1
        elif case == 'str_int':
            assert sp.Auto(m.heisenberg(4), 'UDDU') == \
                sp.Auto(m.heisenberg(4), 0b0110)
            assert sp.Auto(m.localized(L), 'UUUDDD').identical(
                sp.Auto(m.localized(L), 0b111000))
        else:
            a = sp.Auto(m.localized(L), 0b000111, sort=True)
            b = sp.Auto(m.localized(L), 0b000111, sort=False)
            assert set(a.state_map) == set(b.state_map)
            assert not np.array_equal(a.state_map, b.state_map)


# -- the device index map ------------------------------------------------------

@pytest.mark.parametrize('name', sorted(EXPLICIT_LISTS))
def test_explicit_map_matches_reference(name):
    """i2s and s2i (with the valid mask) of every state of the chain, in
    and out of the subspace, against the JAX package's ExplicitMap."""
    states = np.asarray(_explicit_list(name), dtype=np.int64)
    n_bits = 5 if name == 'reversed_sc' else 3
    sub = subspaces.Explicit(states, L=n_bits)
    dmap = device_map(sub)
    assert isinstance(dmap, ExplicitMap)
    ref = RefExplicitMap(n_bits, sub.state_map, sub.rmap_states,
                         sub.rmap_indices)
    idx = np.arange(len(states))
    assert np.array_equal(dmap.i2s(torch.as_tensor(idx)).numpy(),
                          np.asarray(ref.i2s(jnp.asarray(idx))))
    probe = np.arange(1 << n_bits)
    got_idx, got_valid = dmap.s2i(torch.as_tensor(probe))
    want_idx, want_valid = ref.s2i(jnp.asarray(probe))
    want_valid = np.asarray(want_valid)
    assert np.array_equal(got_valid.numpy(), want_valid)
    assert np.array_equal(got_idx.numpy()[want_valid],
                          np.asarray(want_idx)[want_valid])
    assert np.array_equal(got_idx.numpy()[want_valid],
                          sub.state_to_idx(probe[want_valid]))
    assert dmap.table_bytes() == sum(
        a.nbytes for a in {id(a): a for a in (sub.state_map,
                                              sub.rmap_states,
                                              sub.rmap_indices)
                           if a is not None}.values())


# -- XParity over an Explicit parent -----------------------------------------

def _sc_explicit(sp, n=L, order=None):
    states = _states(sp.SpinConserve(n, n // 2))
    if order is not None:
        states = states[order]
    return sp.Explicit(states, L=n)


@pytest.mark.parametrize('sector', ['+', '-'])
def test_xparity_over_explicit(sector):
    """An Explicit parent in SpinConserve's order (representatives first)
    is accepted by both packages, with the same dimension and states."""
    port, ref = _both(lambda sp, _m, _o: sp.XParity(_sc_explicit(sp),
                                                    sector))
    assert port.get_dimension() == ref.get_dimension() == 10
    assert np.array_equal(_states(port), _states(ref))
    assert repr(port) == repr(ref)


def test_xparity_explicit_parent_validation():
    """Odd dimensions and representatives with spin L-1 down are refused by
    both packages. A parent whose first half lacks its complements is
    refused by the port, as the reference dynamite refuses it; the JAX
    package accepts it (it looks up each representative itself, not its
    complement: a fault of the reference, ROADMAP.md queue 3)."""
    for sp in (subspaces, ref_subspaces):
        with pytest.raises(ValueError, match='even dimension'):
            sp.XParity(sp.Explicit([0, 1, 2], L=2))
        with pytest.raises(ValueError, match='spin L-1'):
            sp.XParity(sp.Explicit([2, 0], L=2))
    # the complement of the representative 0b000, 0b111, is missing
    no_complements = [0b000, 0b001, 0b011, 0b110]
    ref_subspaces.XParity(ref_subspaces.Explicit(no_complements, L=3))
    with pytest.raises(ValueError, match='complement'):
        subspaces.XParity(subspaces.Explicit(no_complements, L=3))


# -- operators and states on Explicit/Auto -----------------------------------

def _auto_pair(sort=True):
    H, H_ref = models.localized(8), ref_models.localized(8)
    sub = subspaces.Auto(H, 'UUUUDDDD', sort=sort)
    sub_ref = ref_subspaces.Auto(H_ref, 'UUUUDDDD', sort=sort)
    return H, sub, H_ref, sub_ref


@pytest.mark.parametrize('sort', [True, False])
def test_norm_and_conserves_on_auto(sort):
    """The infinity norm and the conservation check reach the subspace
    only through device_map, so they run on Auto unchanged."""
    H, sub, H_ref, sub_ref = _auto_pair(sort)
    H.add_subspace(sub)
    H_ref.add_subspace(sub_ref)
    want = H_ref.infinity_norm()
    assert H.infinity_norm() == pytest.approx(want, rel=1e-12)
    assert H._infinity_norm_host() == pytest.approx(want, rel=1e-12)
    assert H.conserves(sub) and H_ref.conserves(sub_ref)
    # a field along X leaves the sector
    X, X_ref = (o.index_sum(o.sigmax(), size=8) for o in (ops, ref_ops))
    assert X.conserves(sub) is X_ref.conserves(sub_ref) is False
    assert X._conserves_host(sub) is False
    # rectangular: sigma_minus from the sector into a smaller Explicit
    small = subspaces.Explicit(_states(sub)[:7], L=8)
    small_ref = ref_subspaces.Explicit(_states(sub_ref)[:7], L=8)
    assert H.conserves(small, sub) is H_ref.conserves(small_ref, sub_ref)


@pytest.mark.parametrize('keep', [(0, 1, 2, 3), (1, 4, 6)])
def test_rdm_and_entropy_on_auto(keep):
    """The RDM of an Auto state goes through the Full-vector route
    (``_full_rho`` scattering with ExplicitMap.i2s), against the JAX
    package's."""
    H, sub, H_ref, sub_ref = _auto_pair(sort=False)
    vec = _vec(sub.get_dimension(), seed=9)
    psi, psi_ref = State(subspace=sub), RefState(subspace=sub_ref)
    psi.set_all_numpy(vec)
    psi_ref.set_all_numpy(vec)
    got = reduced_density_matrix(psi, keep)
    want = np.asarray(ref_rdm(psi_ref, keep))
    assert np.max(np.abs(got - want)) < 1e-12
    assert entanglement_entropy(psi, keep) == pytest.approx(
        float(ref_entropy(psi_ref, keep)), abs=1e-12)


@pytest.mark.parametrize('space', ['explicit', 'auto', 'auto_nosort',
                                   'xparity_explicit'])
def test_state_files_cross_load(tmp_path, space):
    def make(sp, m, _o):
        if space == 'explicit':
            return sp.Explicit([0b101, 0b000, 0b011, 0b110], L=3)
        if space == 'xparity_explicit':
            return sp.XParity(_sc_explicit(sp), '-')
        return sp.Auto(m.localized(L), 'UUUDDD', sort=space == 'auto')

    port, ref = _both(make)
    vec = _vec(port.get_dimension(), seed=5)
    psi = State(subspace=port)
    psi.set_all_numpy(vec)
    psi.save(str(tmp_path / 'port'))
    loaded_ref = RefState.from_file(str(tmp_path / 'port'))
    assert type(loaded_ref.subspace) is type(ref)
    assert loaded_ref.subspace.identical(ref)
    assert repr(loaded_ref.subspace) == repr(ref)
    assert np.max(np.abs(loaded_ref.to_numpy() - vec)) < 1e-15

    psi_ref = RefState(subspace=ref)
    psi_ref.set_all_numpy(vec)
    psi_ref.save(str(tmp_path / 'ref'))
    loaded = State.from_file(str(tmp_path / 'ref'))
    assert type(loaded.subspace) is type(port)
    assert loaded.subspace.identical(port)
    assert repr(loaded.subspace) == repr(port)
    assert np.max(np.abs(loaded.to_numpy() - vec)) < 1e-15
