"""
The port's MINRES inner solve (``solvers/minres.py``) against the JAX
package's ``minres_solver`` and a dense numpy solve, at L=6 on the CPU.

Each case hands both packages the same numpy right-hand side. Tolerances:
float64 x against the JAX package's 1e-10 relative to max|x| (the same
recurrence, reductions summed in another order), against the dense solve
1e-10 in the relative residual ||A x - b|| / ||b|| and in the 2-norm
relative to the dense solution; the stopping iteration
(x after maxiter = 1, 3, 7) 1e-12; float32 1e-5 against the float64 JAX
solve.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.solvers.minres import minres_solver as ref_minres

from dynamite_tpu_torch import config, models, subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.solvers.minres import minres_solver

# One torch thread per xdist worker (ROADMAP.md queue 3).
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


def _sub(pkg, space):
    if space == 'full':
        return pkg.Full(L=L)
    return pkg.SpinConserve(L, L // 2)


def _case(model, space):
    """The port's and the JAX package's kernels of one operator, and its
    dense matrix."""
    H = getattr(models, model)(L)
    sub = _sub(subspaces, space)
    H.add_subspace(sub)
    H_ref = getattr(ref_models, model)(L)
    sub_ref = _sub(ref_subspaces, space)
    H_ref.add_subspace(sub_ref)
    dense = H.to_numpy(subspaces=(sub, sub)).toarray()
    return (H.get_mat(subspaces=(sub, sub)),
            H_ref.get_mat(subspaces=(sub_ref, sub_ref)), dense)


def _shift(dense, where):
    lam = np.linalg.eigvalsh(dense)
    if where == 'below':
        return float(lam[0] - 1.0)
    mid = len(lam) // 2
    return float(0.6 * lam[mid] + 0.4 * lam[mid + 1])


def _rhs(dim, seed=42):
    return np.random.RandomState(seed).standard_normal((2, dim))


def _solve_both(kernel, ref_kernel, b, shift, maxiter, rtol,
                dtype=torch.float64):
    stats = {}
    x = minres_solver(kernel.apply, shift=shift, maxiter=maxiter, rtol=rtol,
                      stats=stats)(torch.tensor(b, dtype=dtype)).numpy()
    solve_ref = ref_minres(ref_kernel.traceable(False), shift=shift,
                           maxiter=maxiter, rtol=rtol)
    x_ref = np.asarray(solve_ref(jnp.asarray(b)))
    return x, x_ref, stats


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# the cases of tests/integration/test_minres.py
CASES = {
    'indefinite_interior_shift': ('localized', 'full', 'interior'),
    'definite_shift': ('ising', 'full', 'below'),
    'subspace_shift': ('heisenberg', 'sc', 'interior'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_solve_vs_reference_and_dense(case):
    model, space, where = CASES[case]
    kernel, ref_kernel, dense = _case(model, space)
    dim = dense.shape[0]
    shift = _shift(dense, where)
    b = _rhs(dim)
    x, x_ref, stats = _solve_both(kernel, ref_kernel, b, shift,
                                  maxiter=4 * dim, rtol=1e-11)
    assert _rel(x, x_ref) < 1e-10
    A = dense - shift * np.eye(dim)
    bc = b[0] + 1j * b[1]
    xc = x[0] + 1j * x[1]
    assert np.linalg.norm(A @ xc - bc) / np.linalg.norm(bc) < 1e-10
    want = np.linalg.solve(A, bc)
    assert np.linalg.norm(xc - want) < 1e-10 * np.linalg.norm(want)
    assert stats['solves'] == 1
    assert stats['host_syncs'] == stats['iterations'] + 1
    assert 0 < stats['iterations'] == stats['max_iterations'] <= 4 * dim
    assert stats['max_rel_residual'] <= 1e-11


def test_zero_rhs():
    kernel, ref_kernel, _dense = _case('ising', 'full')
    b = np.zeros((2, 1 << L))
    x, x_ref, stats = _solve_both(kernel, ref_kernel, b, 0.3, maxiter=None,
                                  rtol=None)
    assert np.all(x == 0) and np.all(x_ref == 0)
    assert stats['iterations'] == 0


@pytest.mark.parametrize('maxiter', [1, 3, 7])
def test_stops_at_the_reference_iteration(maxiter):
    """A cap below convergence: both loops run exactly ``maxiter``
    iterations, and x agrees to 1e-12."""
    kernel, ref_kernel, dense = _case('localized', 'full')
    b = _rhs(dense.shape[0], seed=1)
    x, x_ref, stats = _solve_both(kernel, ref_kernel, b, _shift(dense,
                                  'interior'), maxiter=maxiter, rtol=1e-10)
    assert stats['iterations'] == maxiter
    assert _rel(x, x_ref) < 1e-12


def test_counts_iterations_on_the_function():
    kernel, _ref_kernel, dense = _case('ising', 'full')
    before = tracing.counter('minres.iterations')
    minres_solver(kernel.apply, shift=0.1, maxiter=5, rtol=0.0)(
        torch.tensor(_rhs(dense.shape[0])))
    assert tracing.counter('minres.iterations') == before + 5


def test_breakdown_on_an_eigenvector():
    """b an eigenvector of H: the first Lanczos step leaves ~0 (beta and
    the residual estimate ~ eps), the loop ends within two iterations, and
    x = b / (lambda - shift), finite and equal to the JAX package's."""
    kernel, ref_kernel, dense = _case('localized', 'full')
    lam, vecs = np.linalg.eigh(dense)
    v = vecs[:, 5]
    b = np.stack([v.real, v.imag])
    shift = float(lam[5] + 0.37)
    x, x_ref, stats = _solve_both(kernel, ref_kernel, b, shift,
                                  maxiter=50, rtol=1e-14)
    assert np.all(np.isfinite(x))
    assert _rel(x, x_ref) < 1e-12
    assert _rel(x, b / (lam[5] - shift)) < 1e-12
    assert stats['iterations'] <= 2


def test_float32_vs_reference():
    kernel, ref_kernel, dense = _case('ising', 'full')
    b = _rhs(dense.shape[0], seed=3)
    shift = _shift(dense, 'below')
    x, x_ref, _stats = _solve_both(kernel, ref_kernel, b, shift,
                                   maxiter=200, rtol=1e-6,
                                   dtype=torch.float32)
    assert x.dtype == np.float32
    assert _rel(x, x_ref) < 1e-5
