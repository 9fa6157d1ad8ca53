"""
The port's Krylov solvers — Lanczos, evolve (Expokit stepping) and
eigsolve (thick-restart Lanczos) — against the JAX package and scipy/numpy
oracles, at L=10 on the CPU.

Inputs are made in numpy from fixed seeds and handed to both packages (the
two random streams differ by design). The reference's solvers run on
unsharded arrays (its Krylov building blocks with ``sharded=False``), so
these tests add no collective programs on the 8-device test mesh. Tolerances: Lanczos coefficients
1e-10 relative to max|alpha| (same float64 recurrence, summed in another
order); evolve 1e-10 against the reference (same substeps) and 1e-6 against
expm_multiply (the solver's own tol is 1e-7 per unit time); eigenvalues
1e-10 relative. The float32 cases hold the port at 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse.linalg
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.solvers import krylov as ref_krylov
from dynamite_tpu.solvers.eigs import eigsolve_trlanczos as ref_trlanczos
from dynamite_tpu.solvers.expmv import expmv as ref_expmv

from dynamite_tpu_torch import computations, config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.computations import eigsolve, evolve
from dynamite_tpu_torch.solvers import krylov
from dynamite_tpu_torch.solvers.eigs import eigsolve_trlanczos
from dynamite_tpu_torch.states import State


# One torch thread per xdist worker. torch on every core in several workers
# overloads the machine, and the JAX package's CPU collectives then miss
# XLA's rendezvous timeout and abort the worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 10


@pytest.fixture(autouse=True)
def reset_config():
    """Fresh configs, and numpy's BLAS at one thread like torch: the dense
    eigvalsh oracles would otherwise run on every core (ROADMAP.md queue
    3)."""
    # the port runs on the card unless asked for the CPU
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
    """The port in float32 for one test (the reference's precision is never
    changed: it is fixed for the whole process)."""
    config._initialize()
    monkeypatch.setattr(config, '_precision', 'single')


def _pair(model, space):
    def sub(pkg):
        return pkg.Full(L=L) if space == 'full' else pkg.Parity(space, L=L)
    H_ref = getattr(ref_models, model)(L)
    s_ref = sub(ref_subspaces)
    H_ref.add_subspace(s_ref)
    H = getattr(models, model)(L)
    s = sub(subspaces)
    H.add_subspace(s)
    return H_ref, s_ref, H, s


_REF = {}


def _ref_kernel(model, space):
    """The reference's (unsharded) matvec kernel and its infinity norm,
    built once per module so its Krylov programs compile once."""
    if (model, space) not in _REF:
        H_ref, _s_ref, _H, _s = _pair(model, space)
        _REF[model, space] = (H_ref.get_mat(), H_ref.infinity_norm())
    return _REF[model, space]


_SPECTRUM = {}


def _exact_spectrum(model, space):
    """np.linalg.eigvalsh of the dense operator, once per (model, space)."""
    if (model, space) not in _SPECTRUM:
        _H_ref, _s_ref, H, _s = _pair(model, space)
        _SPECTRUM[model, space] = np.linalg.eigvalsh(H.to_numpy().toarray())
    return _SPECTRUM[model, space]


def _start(dim, seed=0):
    v = np.random.RandomState(seed).standard_normal((2, dim))
    return v / np.linalg.norm(v)


def test_lanczos_coefficients_vs_reference():
    H_ref, s_ref, H, s = _pair('localized', 'full')
    m = 12
    v0 = _start(s.get_dimension())
    _V, a_ref, b_ref = ref_krylov.lanczos(H_ref.get_mat().traceable(),
                                          jnp.asarray(v0), m)
    V, a, b = krylov.lanczos(H.get_mat().apply, torch.from_numpy(v0), m)
    scale = np.max(np.abs(np.asarray(a_ref)))
    assert np.max(np.abs(a.numpy() - np.asarray(a_ref))) < 1e-10 * scale
    assert np.max(np.abs(b.numpy() - np.asarray(b_ref))) < 1e-10 * scale
    # the basis is orthonormal as complex vectors
    Vc = (V[:, 0] + 1j * V[:, 1]).numpy()
    assert np.max(np.abs(Vc.conj() @ Vc.T - np.eye(m + 1))) < 1e-12


def test_trlanczos_from_numpy_start_vs_reference():
    H_ref, s_ref, H, s = _pair('localized', 'full')
    dim = s.get_dimension()
    v0 = _start(dim, seed=4)
    want, _S, _V = ref_trlanczos(H_ref.get_mat().krylov_ops(20), dim,
                                 np.float64, nev=2, v0=jnp.asarray(v0))
    got, _S, _V = eigsolve_trlanczos(H.get_mat().krylov_ops(20), dim,
                                     torch.float64, torch.device('cpu'),
                                     nev=2, v0=v0)
    assert np.allclose(got[:2], want[:2], rtol=1e-10, atol=0)


@pytest.mark.parametrize('space', ['full', 'even', 'odd'])
def test_evolve_vs_reference_and_expm_multiply(space):
    _H_ref, _s_ref, H, s = _pair('localized', space)
    ref_kernel, anorm = _ref_kernel('localized', space)
    dim = s.get_dimension()
    v = _start(dim, seed=1)
    vec = v[0] + 1j * v[1]
    psi = State(subspace=s)
    psi.set_all_numpy(vec)

    got = evolve(H, psi, t=1.0).to_numpy()
    assert H.infinity_norm() == pytest.approx(anorm, rel=1e-12)
    # what computations.evolve runs: ncv 30, tol 1e-7, the infinity norm
    w = np.asarray(ref_expmv(ref_kernel.krylov_ops(30), jnp.asarray(v),
                             -1j * 1.0, anorm, ncv=30, tol=1e-7))
    want_ref = w[0] + 1j * w[1]
    oracle = scipy.sparse.linalg.expm_multiply(-1j * H.to_numpy(), vec)
    assert np.linalg.norm(got - want_ref) < 1e-10
    assert np.linalg.norm(got - oracle) < 1e-6
    stats = computations.last_solve_stats
    assert stats['substeps'] >= 1 and stats['host_syncs'] == stats['substeps']


@pytest.mark.parametrize('which', ['lowest', 'highest'])
@pytest.mark.parametrize('nev', [1, 3])
@pytest.mark.parametrize('model,space', [('localized', 'full'),
                                         ('heisenberg', 'even')])
def test_eigsolve_vs_reference_and_eigvalsh(model, space, which, nev):
    _H_ref, _s_ref, H, s = _pair(model, space)
    evals, evecs = eigsolve(H, nev=nev, which=which, getvecs=True)
    # computations.eigsolve's default ncv is 20 at these sizes
    ref_kernel, _ = _ref_kernel(model, space)
    want_ref, _S, _V = ref_trlanczos(ref_kernel.krylov_ops(20),
                                     s.get_dimension(), np.float64, nev=nev,
                                     which=which)
    exact = _exact_spectrum(model, space)
    exact = exact[:nev] if which == 'lowest' else exact[::-1][:nev]
    assert np.allclose(evals[:nev], exact, rtol=1e-10, atol=1e-12)
    assert np.allclose(evals[:nev], want_ref[:nev], rtol=1e-10, atol=1e-12)
    Hm = H.to_numpy()
    for lam, v in zip(evals, evecs):
        x = v.to_numpy()
        assert abs(np.linalg.norm(x) - 1) < 1e-10
        assert np.linalg.norm(Hm @ x - lam * x) < 1e-6 * abs(lam)


def test_eigsolve_target_not_ported():
    """target= is ported (tests/test_torch_target.py holds it against the
    JAX package): near the spectrum's edge at L=10 it gives eigvalsh's two
    levels nearest the target."""
    H = models.localized(L)
    exact = _exact_spectrum('localized', 'full')
    target = float(0.7 * exact[1] + 0.3 * exact[2])
    evals = eigsolve(H, nev=2, target=target)
    nearest = exact[np.argsort(np.abs(exact - target))[:2]]
    assert np.allclose(np.sort(evals), np.sort(nearest), rtol=1e-10,
                       atol=1e-12)


def test_single_precision_evolve_and_eigsolve(single_precision):
    H = models.localized(L)
    s = subspaces.Full(L=L)
    H.add_subspace(s)
    v = _start(s.get_dimension(), seed=2)
    vec = v[0] + 1j * v[1]
    psi = State(subspace=s)
    psi.set_all_numpy(vec)
    assert psi.data.dtype == torch.float32

    got = evolve(H, psi, t=1.0)
    assert got.data.dtype == torch.float32
    oracle = scipy.sparse.linalg.expm_multiply(-1j * H.to_numpy(), vec)
    assert np.linalg.norm(got.to_numpy() - oracle) < 1e-5

    evals = eigsolve(H, nev=1)
    exact = np.linalg.eigvalsh(H.to_numpy().toarray())[0]
    assert abs(evals[0] - exact) < 1e-5 * abs(exact)
