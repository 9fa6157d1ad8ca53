"""
The port's reduced density matrices and entanglement entropies
(``dynamite_tpu_torch/ops/rdm.py``, ``computations.reduced_density_matrix``,
``entanglement_entropy``, ``renyi_entropy`` and the ``dm_*`` formulas)
against the JAX package's, on the CPU; the cases of
``tests/integration/test_rdm.py`` and ``test_entropies.py``.

States are made in numpy from a seed and set in both packages. RDMs agree
with the JAX package's and with the host route ``rdm_from_full_vector`` to
1e-12 (float64) and 1e-5 (float32), on Full, both Parity sectors and
SpinConserve at several k, with even and uneven cuts. Entropies taken on
the device (block by block on SpinConserve) agree with the ``dm_*`` route
and the JAX package's to 1e-10.
"""

import gc
from itertools import combinations

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from dynamite_tpu import computations as ref_comp
from dynamite_tpu import config as ref_config
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.states import State as RefState

from dynamite_tpu_torch import config
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.computations import (dm_entanglement_entropy,
                                             dm_renyi_entropy,
                                             entanglement_entropy,
                                             reduced_density_matrix,
                                             renyi_entropy)
from dynamite_tpu_torch.ops import rdm
from dynamite_tpu_torch.states import State

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 6
SUBSPACES = {
    'full': lambda pkg: pkg.Full(L=L),
    'parity_even': lambda pkg: pkg.Parity('even', L=L),
    'parity_odd': lambda pkg: pkg.Parity('odd', L=L),
    'sc1': lambda pkg: pkg.SpinConserve(L, 1),
    'sc2': lambda pkg: pkg.SpinConserve(L, 2),
    'sc3': lambda pkg: pkg.SpinConserve(L, 3),
}
# half, uneven, scattered and single-spin cuts, and every spin
KEEPS = [(0,), (0, 1, 2), (1, 4), (0, 2, 3, 5), (2, 3, 4, 5),
         tuple(range(L))]


@pytest.fixture(autouse=True)
def reset_config():
    """Fresh configs, the port on the CPU (it runs on the card unless asked
    for the CPU), numpy's BLAS at one thread (ROADMAP.md queue 3)."""
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


@pytest.fixture
def single_precision(monkeypatch):
    """The port in float32 for one test."""
    config._initialize()
    monkeypatch.setattr(config, '_precision', 'single')


def _vec(dim, seed):
    rng = np.random.RandomState(seed)
    v = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    return v / np.linalg.norm(v)


def _states(name, seed=11):
    """The same random state in both packages, and its full-space vector."""
    sub, sub_ref = SUBSPACES[name](subspaces), SUBSPACES[name](ref_subspaces)
    vec = _vec(sub.get_dimension(), seed)
    s, s_ref = State(subspace=sub), RefState(subspace=sub_ref)
    s.set_all_numpy(vec)
    s_ref.set_all_numpy(vec)
    full = np.zeros(1 << L, dtype=np.complex128)
    full[sub.idx_to_state(np.arange(len(vec)))] = vec
    return s, s_ref, full


def _err(got, want):
    return np.max(np.abs(got - want))


@pytest.mark.parametrize('keep', KEEPS)
@pytest.mark.parametrize('name', list(SUBSPACES))
def test_rdm_against_jax_and_host(name, keep):
    s, s_ref, full = _states(name)
    got = reduced_density_matrix(s, keep)
    assert got.dtype == np.complex128
    assert got.shape == (1 << len(keep),) * 2
    assert _err(got, ref_comp.reduced_density_matrix(s_ref, keep)) <= 1e-12
    assert _err(got, rdm.rdm_from_full_vector(full, keep, L)) <= 1e-12
    assert _err(got, rdm.rdm_host(s, keep)) <= 1e-12
    assert abs(np.trace(got).real - 1) <= 1e-12
    assert _err(got, got.conj().T) <= 1e-15


@pytest.mark.parametrize('name', ['full', 'parity_odd', 'sc2', 'sc3'])
def test_rdm_float32(name, single_precision):
    s, s_ref, full = _states(name, seed=12)
    assert s.data.dtype == torch.float32
    for keep in ((0, 1, 2), (1, 4), (0, 2, 3, 5)):
        got = reduced_density_matrix(s, keep)
        want = rdm.rdm_from_full_vector(full, keep, L)
        assert _err(got, want) <= 1e-5
        assert _err(got, ref_comp.reduced_density_matrix(s_ref, keep)) <= 1e-5


@pytest.mark.parametrize('name', list(SUBSPACES))
def test_entropies_on_the_device(name):
    """The spectrum taken on the device gives the numbers of the dm_*
    route and of the JAX package."""
    s, s_ref, _full = _states(name, seed=13)
    for keep in KEEPS[:-1]:
        rho = reduced_density_matrix(s, keep)
        got = entanglement_entropy(s, keep)
        assert abs(got - dm_entanglement_entropy(rho)) <= 1e-10
        assert abs(got - ref_comp.entanglement_entropy(s_ref, keep)) <= 1e-10
        # a fractional alpha only where no eigenvalue rounds below 0
        full_rank = np.linalg.eigvalsh(rho).min() > 1e-8
        for alpha in (0, 1, 2, 'inf') + ((0.5,) if full_rank else ()):
            r = renyi_entropy(s, keep, alpha)
            assert abs(r - dm_renyi_entropy(rho, alpha)) <= 1e-10
            assert abs(r - ref_comp.renyi_entropy(s_ref, keep, alpha)) \
                <= 1e-10
        assert abs(renyi_entropy(s, keep, 3, method='matrix_power')
                   - renyi_entropy(s, keep, 3)) <= 1e-10


def test_spinconserve_route_builds_no_full_vector(monkeypatch):
    """SpinConserve takes the weight blocks (one GEMM each) and never the
    2^L scatter; its index tables are built once per (subspace, keep,
    device), counted by index_cache_bytes and freed by clear_index_cache
    or with the subspace."""
    def no_full(*_args):
        raise AssertionError('the SpinConserve route built a 2^L vector')

    monkeypatch.setattr(rdm, '_full_rho', no_full)
    s, _s_ref, full = _states('sc3', seed=14)
    rdm.clear_index_cache()
    assert rdm.index_cache_bytes() == 0
    builds = tracing.counter('rdm.spinconserve_index_builds')
    for _ in range(2):
        got = reduced_density_matrix(s, (0, 1, 2))
    assert tracing.counter('rdm.spinconserve_index_builds') == builds + 1
    assert rdm.index_cache_bytes() == 2 * s.subspace.get_dimension() * 8
    assert _err(got, rdm.rdm_from_full_vector(full, (0, 1, 2), L)) <= 1e-12
    blocks, index = rdm.spinconserve_index(s.subspace, (0, 1, 2),
                                           torch.device('cpu'))
    assert [b[0] for b in blocks] == [0, 1, 2, 3]
    assert index.numel() == 2 * s.subspace.get_dimension()
    # every amplitude is read once per plane
    assert torch.equal(index.sort().values,
                       torch.arange(2 * s.subspace.get_dimension()))
    del s, index
    gc.collect()
    assert rdm.index_cache_bytes() == 0


def test_keep_all_is_pure():
    s, _s_ref, full = _states('full', seed=3)
    rho = reduced_density_matrix(s, list(range(L)))
    assert _err(rho, np.outer(full, full.conj())) <= 1e-12


def test_product_state_zero_entropy():
    for sub in (subspaces.Full(L=L), subspaces.SpinConserve(L, 3)):
        s = State(state='UUDUDD', subspace=sub)
        for keep in combinations(range(L), 2):
            assert abs(entanglement_entropy(s, keep)) < 1e-12
    s = State(state='UUDDUU', subspace=subspaces.Full(L=L))
    expected = np.zeros((4, 4))
    expected[0, 0] = 1  # spins 0, 1 are both U (0)
    assert np.allclose(reduced_density_matrix(s, [0, 1]), expected)


@pytest.mark.parametrize('name', ['full', 'sc3'])
def test_complement_symmetry(name):
    """S(A) == S(B) for a pure state split A|B."""
    s, _s_ref, _full = _states(name, seed=5)
    for keep in ([0, 2], [0, 1, 2], [1]):
        comp = [i for i in range(L) if i not in keep]
        assert abs(entanglement_entropy(s, keep)
                   - entanglement_entropy(s, comp)) <= 1e-10


def test_bell_entropy():
    # (|00> + |11>)/sqrt(2): entanglement entropy log(2)
    vec = np.zeros(4, dtype=complex)
    vec[0b00] = vec[0b11] = 1 / np.sqrt(2)
    s = State(subspace=subspaces.Full(L=2))
    s.set_all_numpy(vec)
    assert abs(s.entanglement_entropy([0]) - np.log(2)) < 1e-12
    assert abs(renyi_entropy(s, [1], 'inf') - np.log(2)) < 1e-12


def test_dm_entropy_formulas():
    # maximally mixed 2x2: S = log 2, renyi_alpha = log 2 for all alpha
    dm = np.eye(2) / 2
    assert abs(dm_entanglement_entropy(dm) - np.log(2)) < 1e-12
    for alpha in (0, 1, 2, 0.5, 'inf'):
        assert abs(dm_renyi_entropy(dm, alpha) - np.log(2)) < 1e-12
        assert dm_renyi_entropy(dm, alpha) == pytest.approx(
            ref_comp.dm_renyi_entropy(dm, alpha), abs=1e-15)
    rng = np.random.RandomState(7)
    A = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    rho = A @ A.conj().T
    rho /= np.trace(rho).real
    w = np.linalg.eigvalsh(rho)
    expected = np.log(np.sum(w ** 2)) / (1 - 2)
    assert abs(dm_renyi_entropy(rho, 2) - expected) < 1e-12
    assert abs(dm_renyi_entropy(rho, 2, method='matrix_power')
               - expected) < 1e-12
    assert dm_entanglement_entropy(rho) == pytest.approx(
        ref_comp.dm_entanglement_entropy(rho), abs=1e-14)
    with pytest.raises(TypeError):
        dm_renyi_entropy(rho, 1.5, method='matrix_power')
    with pytest.raises(ValueError):
        dm_renyi_entropy(rho, 2, method='bogus')


def test_validation():
    s, s_ref, _full = _states('full', seed=1)
    for keep in ([1, 0], [1, 1], [-1], [L]):
        for fn in (reduced_density_matrix, entanglement_entropy):
            with pytest.raises(ValueError):
                fn(s, keep)
        with pytest.raises(ValueError):
            ref_comp.reduced_density_matrix(s_ref, keep)
    empty = reduced_density_matrix(s, [])
    assert np.array_equal(empty, np.array([[1]], dtype=complex))
    assert entanglement_entropy(s, []) == 0

    # XParity's basis is not a product basis: both packages raise
    xp = State(state='random', seed=2,
               subspace=subspaces.XParity(subspaces.Full(L=L), '+'))
    xp_ref = RefState(state='random', seed=2,
                      subspace=ref_subspaces.XParity(
                          ref_subspaces.Full(L=L), '+'))
    for state, fn in ((xp, reduced_density_matrix),
                      (xp, entanglement_entropy),
                      (xp_ref, ref_comp.reduced_density_matrix)):
        with pytest.raises(ValueError, match='product state basis'):
            fn(state, [0])
