"""
The port's interior eigensolve, ``eigsolve(target=)``, against the JAX
package and numpy oracles, at L=6 (and L=8) on the CPU: both methods
(MINRES shift-invert and spectral folding) on Full, Parity and
SpinConserve, the folded operator, and the Rayleigh-Ritz extract with its
streamed Grams and its memory.

Both packages start their Lanczos iterations from the same numpy vectors
(each package's ``random_start`` is replaced by one drawn from a numpy
seed; the two random streams differ by design), so they take the same
path. The reference's target solves compile for seconds each, so each case
is solved once, in one test. Tolerances: eigenvalues 1e-10
against eigvalsh and against the JAX package; eigenvector residuals
||Hv - lambda v|| <= 1e-8; the folded MSC 1e-12; the extract 1e-12
against the JAX one on the same candidates, its Grams 1e-12 relative
against a stacked numpy Gram.
"""

import gc
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from dynamite_tpu import computations as ref_computations
from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.ops import msc as ref_msc
from dynamite_tpu.parallel.mesh import make_mesh
from dynamite_tpu.solvers import eigs as ref_eigs
from dynamite_tpu.states import State as RefState

from dynamite_tpu_torch import computations, config, models, subspaces
from dynamite_tpu_torch.solvers import eigs
from dynamite_tpu_torch.states import State

from tests.torch_examples_reference import mbl_hamiltonian

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 6
METHODS = ['shift_invert', 'fold']
# the solves' tol: fold at its default (1e-6 on the folded operator's
# scale) leaves residuals of ~1e-8 (3.9e-8 on Full(6)), so both packages
# fold to 1e-10 here; shift-invert runs at its defaults
TOL = {'shift_invert': None, 'fold': 1e-10}
SPACES = ['full', 'parity', 'sc']


def _numpy_start(dim, seed):
    w = np.random.RandomState(seed).standard_normal((2, dim))
    return w / np.linalg.norm(w)


@pytest.fixture(autouse=True)
def same_start(monkeypatch):
    """Fresh configs, the port on the CPU, numpy's BLAS at one thread, and
    both packages' Lanczos start vectors (the first and the injected ones
    of the verification cycles) drawn from the same numpy seeds (the
    reference's padded to its storage length and put on its mesh).

    The reference solves on a mesh of one device: on the 8-device virtual
    mesh its applies run XLA CPU collectives, which abort the process when
    CPU load makes a device thread miss their rendezvous timeout (ROADMAP.md
    queue 3), as the fold case did in a full run of the suite on 6 workers.
    Every global the fixture sets (the port's device and precision, both
    packages' L, subspace and the reference's mesh) is restored after the
    test."""
    def ref_start(dim, dtype, seed=0, sharding=None, storage_dim=None):
        w = np.zeros((2, storage_dim or dim))
        w[:, :dim] = _numpy_start(dim, seed)
        w = jnp.asarray(w, dtype=dtype)
        return w if sharding is None else jax.device_put(w, sharding)

    monkeypatch.setattr(ref_eigs, 'random_start', ref_start)
    monkeypatch.setattr(
        eigs, 'random_start',
        lambda dim, dtype, device, seed=0:
        torch.tensor(_numpy_start(dim, seed), dtype=dtype, device=device))
    saved = config._device, config._precision, ref_config.mesh
    config.device = 'cpu'
    ref_config._mesh = make_mesh(mesh_shape=(1,))
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    try:
        with threadpool_limits(limits=1, user_api='blas'):
            yield
    finally:
        for cfg in (ref_config, config):
            cfg._L = None
            cfg._subspace = None
        config._device, config._precision, ref_config._mesh = saved


def _sub(pkg, space, L=L):
    if space == 'full':
        return pkg.Full(L=L)
    if space == 'parity':
        return pkg.Parity('even', L=L)
    return pkg.SpinConserve(L, L // 2)


def _pair(space, L=L):
    """localized(L) on the space, in the port and in the JAX package."""
    H = models.localized(L)
    H.add_subspace(_sub(subspaces, space, L))
    H_ref = ref_models.localized(L)
    H_ref.add_subspace(_sub(ref_subspaces, space, L))
    return H, H_ref


def _target(dense):
    """tests/integration/test_eigsolve.py::test_target's target: off the
    midpoint of the two middle levels, so the nearest two are unambiguous."""
    mid = len(dense) // 2
    return float(0.7 * dense[mid] + 0.3 * dense[mid + 1])


def _solve(space, method):
    """(port eigenvalues, port residuals, JAX eigenvalues, the two nearest
    eigvalsh values, the port's last_solve_stats) of one case."""
    H, H_ref = _pair(space)
    dense = np.linalg.eigvalsh(H.to_numpy().toarray())
    target = _target(dense)
    evals, evecs = computations.eigsolve(
        H, nev=2, target=target, target_method=method, tol=TOL[method],
        getvecs=True)
    stats = dict(computations.last_solve_stats)
    residuals = [(H.dot(v) - float(lam) * v).norm()
                 for lam, v in zip(evals, evecs)]
    evals_ref = H_ref.eigsolve(nev=2, target=target, target_method=method,
                               tol=TOL[method])
    nearest = dense[np.argsort(np.abs(dense - target))[:2]]
    return evals, residuals, evals_ref, nearest, stats


@pytest.mark.parametrize('method', METHODS)
@pytest.mark.parametrize('space', SPACES)
def test_target_vs_reference_and_eigvalsh(space, method):
    """One test per case (the solve is its cost): the pair against
    eigvalsh and the JAX package, the eigenvector residuals, and the
    counters."""
    evals, residuals, evals_ref, nearest, stats = _solve(space, method)
    assert np.max(np.abs(np.sort(evals) - np.sort(nearest))) < 1e-10
    assert np.max(np.abs(np.sort(evals) - np.sort(evals_ref))) < 1e-10
    assert max(residuals) <= 1e-8
    # the counters of the target path: the extract applies H twice to each
    # of its n >= nev + 4 candidates
    n_applies = stats['extract_applies']
    assert stats['method'] == method
    assert n_applies >= 2 * (2 + 4) and n_applies % 2 == 0
    if method == 'shift_invert':
        assert stats['minres_solves'] == stats['outer_applies'] > 0
        assert stats['matvecs'] == stats['minres_iterations'] + n_applies
        assert stats['host_syncs'] > stats['minres_iterations']
    else:
        assert stats['minres_solves'] == 0
        assert stats['matvecs'] == stats['outer_applies'] + n_applies


def test_target_requires_value():
    H, _ = _pair('full')
    with pytest.raises(ValueError, match='requires the target'):
        computations.eigsolve(H, which='target')


def test_bad_target_method():
    H, _ = _pair('full')
    with pytest.raises(ValueError, match='target_method'):
        computations.eigsolve(H, target=0.1, target_method='lanczos')


@pytest.mark.parametrize('target', [0.0, -1.3])
def test_folded_msc_vs_reference(target):
    """(H - target)^2 as the JAX package builds it in its fold path."""
    H, H_ref = _pair('full')
    got = computations._folded_msc(H, target)
    H_ref.reduce_msc()
    shifted = ref_msc.msc_sum(
        [H_ref.msc, ref_msc.msc_from_arrays([0], [0], [-target])])
    want = ref_msc.combine_terms(ref_msc.msc_product([shifted, shifted]))
    want = ref_msc.truncate(
        want, 1e-12 * float(np.abs(want['coeffs']).max()))
    assert np.array_equal(got['masks'], want['masks'])
    assert np.array_equal(got['signs'], want['signs'])
    assert np.max(np.abs(got['coeffs'] - want['coeffs'])) < \
        1e-12 * np.max(np.abs(want['coeffs']))


def _candidates(dim, n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
            for _ in range(n)]


def _states(pkg_state, sub, vecs):
    out = []
    for vec in vecs:
        s = pkg_state(subspace=sub)
        s.set_all_numpy(vec / np.linalg.norm(vec))
        out.append(s)
    return out


def test_extract_vs_reference():
    """The port's extract and the JAX package's on the same six candidate
    states: eigenvalues to 1e-12, eigenvectors to 1e-10 up to phase."""
    H, H_ref = _pair('full')
    vecs = _candidates(1 << L, 6)
    target = 0.2
    evals, evecs = computations._rayleigh_ritz_extract(
        H, _states(State, H.subspace, vecs), target, 3, True)
    evals_ref, evecs_ref = ref_computations._rayleigh_ritz_extract(
        H_ref, _states(RefState, H_ref.subspace, vecs), target, 3, True)
    scale = np.max(np.abs(evals_ref))
    assert np.max(np.abs(evals - np.asarray(evals_ref))) < 1e-12 * scale
    for v, v_ref in zip(evecs, evecs_ref):
        overlap = np.vdot(v_ref.to_numpy(), v.to_numpy())
        assert abs(abs(overlap) - 1) < 1e-10
        assert abs(v.norm() - 1) < 1e-12


def test_streamed_grams_vs_stacked_numpy():
    H, _ = _pair('full')
    n = 5
    vecs = _candidates(1 << L, n, seed=7)
    V = torch.tensor(np.stack([np.stack([v.real, v.imag]) for v in vecs]))
    stats = {}
    A, B, W = computations._streamed_grams(H.get_mat(), V, stats)
    Hd = H.to_numpy().toarray()
    X = np.stack(vecs, axis=1)
    basis = np.hstack([X, Hd @ X])
    hbasis = np.hstack([Hd @ X, Hd @ Hd @ X])
    A_want = basis.conj().T @ hbasis
    B_want = basis.conj().T @ basis
    assert np.max(np.abs(A - A_want)) < 1e-12 * np.max(np.abs(A_want))
    assert np.max(np.abs(B - B_want)) < 1e-12 * np.max(np.abs(B_want))
    assert np.allclose((W[:, 0] + 1j * W[:, 1]).numpy(), (Hd @ X).T,
                       rtol=0, atol=1e-12 * np.max(np.abs(Hd @ X)))
    assert stats == {'applies': 2 * n, 'host_syncs': 1}


def _live_vectors(nbytes):
    """The torch storages of at least one vector's bytes alive in the
    process, in vectors (views of one storage counted once)."""
    seen = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor):
            storage = obj.untyped_storage()
            if storage.nbytes() >= nbytes:
                seen[storage.data_ptr()] = storage.nbytes()
    return sum(seen.values()) / nbytes


def test_extract_holds_2n_plus_1_vectors():
    """At every H apply of the extract, the live vector storage grew by at
    most 2n + 1 vectors over what was alive before the candidates were
    made (the candidates themselves included), n = nev + 4. The operator's
    own tables, which its first apply builds (on the CPU the plain XOR
    version's group factors), are alive before."""
    L_mem = 10
    H, _ = _pair('full', L_mem)
    kernel = H.get_mat()
    dim = 1 << L_mem
    nbytes = 2 * dim * 8
    nev = 2
    n = nev + 4
    kernel.apply(torch.zeros((2, dim), dtype=torch.float64))
    apply = kernel.apply
    peaks = []

    def counting_apply(x):
        y = apply(x)
        peaks.append(_live_vectors(nbytes))
        return y

    kernel.apply = counting_apply
    gc.collect()
    before = _live_vectors(nbytes)
    states = _states(State, H.subspace, _candidates(dim, n, seed=3))
    computations._rayleigh_ritz_extract(H, states, 0.0, nev, False)
    assert len(peaks) == 2 * n
    assert max(peaks) - before <= 2 * n + 1


def test_inner_its_passed_through():
    """Mid-spectrum at L=8 with inner_its=20, far below what MINRES needs
    there: both packages run the capped inner solves from the same start
    and return the same inexact pair, more than 1e-2 off eigvalsh (the
    reference fault of ROADMAP.md queue 3, reproduced in both). The outer
    iteration on an inexact inverse amplifies roundoff, so the packages
    agree only to 1e-3 (2.6e-5 measured on the CPU)."""
    H, H_ref = _pair('full', 8)
    dense = np.linalg.eigvalsh(H.to_numpy().toarray())
    target = _target(dense)
    got = np.sort(computations.eigsolve(H, nev=2, target=target,
                                        inner_its=20))
    stats = computations.last_solve_stats
    want = np.sort(H_ref.eigsolve(nev=2, target=target, inner_its=20))
    nearest = np.sort(dense[np.argsort(np.abs(dense - target))[:2]])
    assert stats['minres_max_iterations'] == 20
    assert stats['minres_max_rel_residual'] > 1e-5
    assert np.max(np.abs(got - nearest)) > 1e-2
    assert np.max(np.abs(want - nearest)) > 1e-2
    assert np.max(np.abs(got - want)) < 1e-3


def _mbl(L):
    """The MBL example's Hamiltonian at ``-L L --seed 7`` and its first
    field strength, with the script's target for energy point 0.5."""
    H = mbl_hamiltonian(L, 7)
    dense = np.linalg.eigvalsh(H.to_numpy().toarray())
    return H, dense, float(dense[0] + 0.5 * (dense[-1] - dense[0]))


def _localized(L):
    H = models.localized(L)
    H.add_subspace(subspaces.SpinConserve(L, L // 2))
    dense = np.linalg.eigvalsh(H.to_numpy().toarray())
    return H, dense, _target(dense)


@pytest.mark.parametrize('case, nev', [('localized', 2), ('mbl', 3)])
def test_default_inner_cap_mid_spectrum(case, nev):
    """ROADMAP.md queue 3's fault, repaired in the port: mid-spectrum on
    SpinConserve(10, 5) (dim 252), float64, at the default inner cap, every
    inner MINRES solve stops on inner_tol (no warning) and the levels match
    eigvalsh to 1e-10: localized(10) at the target of the tests above, and
    the MBL example's Hamiltonian (seed 7) at its energy point 0.5 with
    nev 3 (test_torch_examples.py's). inner_tol is 1e-13, tighter than the
    default, so that the solves need 538 and 620 iterations where the JAX
    package's cap,
    min(2 dim, 2000), is 504: with that cap they stop above inner_tol
    (the port warns) and this test fails. (At L=12 the levels themselves
    land 1e-4 to 1e-2 off with that cap; this size keeps the test under
    30 s.)"""
    H, dense, target = (_localized if case == 'localized' else _mbl)(10)
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        got = np.sort(computations.eigsolve(H, nev=nev, target=target,
                                            inner_tol=1e-13))
    stats = computations.last_solve_stats
    nearest = np.sort(dense[np.argsort(np.abs(dense - target))[:nev]])
    dim = len(dense)
    assert stats['minres_unconverged'] == 0
    assert min(2 * dim, 2000) < stats['minres_max_iterations'] \
        < computations.default_inner_its(dim)
    assert np.max(np.abs(got - nearest)) < 1e-10


def test_inexact_inner_solve_warns():
    """An inner solve that stops at the cap above inner_tol makes eigsolve
    warn, naming inner_its (test_inner_its_passed_through's solve)."""
    H, _ = _pair('full', 8)
    target = _target(np.linalg.eigvalsh(H.to_numpy().toarray()))
    with pytest.warns(RuntimeWarning, match='inner_its=20'):
        computations.eigsolve(H, nev=2, target=target, inner_its=20)
    stats = computations.last_solve_stats
    assert stats['minres_unconverged'] == stats['minres_solves'] > 0
