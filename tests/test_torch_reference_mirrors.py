"""
Mirrors of the JAX package's test cases that cannot run unchanged on the
port and had no port test of their own (``tests/torch_reference_suite.py``
names each case's mirror): the cvec helpers of ``unit/test_tools.py``,
``test_expectation`` and ``test_sub_to_full_embedding`` of
``integration/test_multiply.py``, and the mesh cases of
``integration/test_sector_shard.py`` and ``integration/test_sharded.py``
on virtual ranks (``ops/apply.py::VirtualTransport``, the per-rank code of
a process group). Inputs are made in numpy; each result is held against a
numpy/scipy oracle and the JAX package's (on one device), 1e-12 relative
in float64.
"""

import numpy as np
import pytest
import torch
from scipy.sparse.linalg import expm_multiply
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.ops import cvec as ref_cvec
from dynamite_tpu.parallel.mesh import make_mesh
from dynamite_tpu.states import State as RefState

from dynamite_tpu_torch import config, models, subspaces
from dynamite_tpu_torch.ops import cvec
from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
from dynamite_tpu_torch.parallel import mesh
from dynamite_tpu_torch.solvers.expmv import expmv
from dynamite_tpu_torch.states import State

# one torch thread per xdist worker (ROADMAP.md queue 3)
torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(autouse=True)
def reset_config():
    """Fresh configs, the port on the CPU, the JAX package on a mesh of one
    device (its collectives on the 8-device virtual mesh can abort a loaded
    run, ROADMAP.md queue 3), numpy's BLAS at one thread."""
    saved_device, saved_mesh = config._device, ref_config.mesh
    config.device = 'cpu'
    ref_config._mesh = make_mesh(mesh_shape=(1,))
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    ref_config._initialize()
    with threadpool_limits(limits=1, user_api='blas'):
        yield
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    config._device, ref_config._mesh = saved_device, saved_mesh


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(
        np.max(np.abs(want)), 1e-30)


def _pair(seed, n=256):
    rng = np.random.RandomState(seed)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return v, np.stack([v.real, v.imag])


def _complex(planes):
    planes = np.asarray(planes)
    return planes[0] + 1j * planes[1]


CVEC = {
    'vdot': (lambda m, a, b: np.array(m.vdot(a, b), dtype=float),
             lambda a, b: np.array([np.vdot(a, b).real, np.vdot(a, b).imag])),
    'norm': (lambda m, a, b: np.array(float(m.norm(a))),
             lambda a, b: np.array(np.linalg.norm(a))),
    'axpby': (lambda m, a, b: _complex(m.axpby(0.5, -2.0, a, 1.5, 0.25, b)),
              lambda a, b: (0.5 - 2j) * a + (1.5 + 0.25j) * b),
    'mul_elementwise': (lambda m, a, b: _complex(m.mul_elementwise(a, b)),
                        lambda a, b: a * b),
    'scale_complex': (lambda m, a, b: _complex(m.scale_complex(a, 0.3, -1.2)),
                      lambda a, b: (0.3 - 1.2j) * a),
}


@pytest.mark.parametrize('op', sorted(CVEC))
def test_cvec(op):
    """unit/test_tools.py::TestCvec: each helper on (2, n) planes against
    numpy and the JAX package's."""
    run, oracle = CVEC[op]
    a, ad = _pair(0)
    b, bd = _pair(1)
    got = run(cvec, torch.as_tensor(ad), torch.as_tensor(bd))
    want = oracle(a, b)
    assert _rel(got, want) < TOL
    ref = run(ref_cvec, jnp.asarray(ad), jnp.asarray(bd))
    assert _rel(got, ref) < TOL


def _state(pkg_state, sub, planes):
    s = pkg_state(subspace=sub)
    s.set_all_numpy(_complex(planes))
    return s


def test_expectation():
    """integration/test_multiply.py::test_expectation: <s|H|s> of the
    Ising chain on Full(6) from a numpy state."""
    L = 6
    planes = np.random.RandomState(5).standard_normal((2, 1 << L))
    planes /= np.linalg.norm(planes)
    H = models.ising(L)
    H.add_subspace(subspaces.Full(L=L))
    got = H.expectation(_state(State, H.subspace, planes))
    v = _complex(planes)
    want = np.vdot(v, H.to_numpy() @ v).real
    assert abs(got - want) < TOL * abs(want)
    H_ref = ref_models.ising(L)
    H_ref.add_subspace(ref_subspaces.Full(L=L))
    ref = H_ref.expectation(_state(RefState, H_ref.subspace, planes))
    assert abs(got - ref) < TOL * abs(want)


def test_sub_to_full_embedding():
    """integration/test_multiply.py::test_sub_to_full_embedding: H from
    SpinConserve(6, 3) into Full(6) against to_numpy of the pair and the
    JAX package's product."""
    L = 6
    planes = np.random.RandomState(3).standard_normal((2, 20))
    outs = []
    for m, sp, st in ((models, subspaces, State),
                      (ref_models, ref_subspaces, RefState)):
        H = m.heisenberg(L)
        H.allow_projection = True
        sc = sp.SpinConserve(L, L // 2)
        H.add_subspace(sp.Full(L=L), sc)
        outs.append(np.asarray(H.dot(_state(st, sc, planes)).to_numpy()))
        if m is models:
            want = H.to_numpy(subspaces=(sp.Full(L=L), sc)) @ \
                _complex(planes)
    got, ref = outs
    assert got.shape == (1 << L,)
    assert _rel(got, want) < TOL and _rel(got, ref) < TOL


def _over(H, sub, world):
    return OperatorKernel(H._msc_on(sub), sub, sub,
                          transport=VirtualTransport(world))


def _padded(v, world):
    out = torch.zeros((2, mesh.storage_dim(v.shape[1], world)),
                      dtype=torch.float64)
    out[:, :v.shape[1]] = torch.as_tensor(v)
    return out


SPINCONSERVE = {
    'heisenberg': lambda m: m.heisenberg(8),
    'long_range': lambda m: m.long_range(8),
    'syk': lambda m: m.syk(3),
}


@pytest.mark.parametrize('world', [3, 4])
@pytest.mark.parametrize('model', sorted(SPINCONSERVE))
def test_spinconserve_over_ranks(model, world):
    """integration/test_sector_shard.py::test_heisenberg_ring,
    ::test_long_range_many_groups and integration/test_sharded.py::
    test_spinconserve_syk_scan_path: the model on SpinConserve(L, L/2)
    over ``world`` virtual ranks by its default route, against to_numpy
    and the JAX package's one-device product; pad rows exactly 0."""
    H = SPINCONSERVE[model](models)
    H.allow_projection = True
    L = H.get_length() if model == 'syk' else 8
    sub = subspaces.SpinConserve(L, L // 2)
    H.add_subspace(sub)
    dim = sub.get_dimension()
    v = np.random.RandomState(7).standard_normal((2, dim))
    y = _over(H, sub, world).apply(_padded(v, world))
    assert not y[:, dim:].any()
    got = _complex(y[:, :dim].numpy())
    assert _rel(got, H.to_numpy() @ _complex(v)) < TOL
    H_ref = SPINCONSERVE[model](ref_models)
    H_ref.allow_projection = True
    sub_ref = ref_subspaces.SpinConserve(L, L // 2)
    H_ref.add_subspace(sub_ref)
    ref = H_ref.dot(_state(RefState, sub_ref, v)).to_numpy()
    assert _rel(got, ref) < TOL


def test_parity_evolution_over_ranks():
    """integration/test_sharded.py::test_parity_sharded_evolution:
    localized(8) on Parity('even') over 8 virtual ranks (the XOR route),
    evolved to t = 0.5 against expm_multiply and the JAX package's evolve
    on one device, from one numpy state."""
    L, world = 8, 8
    H = models.localized(L)
    H.allow_projection = True
    sub = subspaces.Parity('even', L=L)
    H.add_subspace(sub)
    k = _over(H, sub, world)
    assert k.engine == 'xor'
    v = np.random.RandomState(21).standard_normal((2, 1 << (L - 1)))
    v /= np.linalg.norm(v)
    out = expmv(k.krylov_ops(30), torch.as_tensor(v), -0.5j,
                H.infinity_norm(), ncv=30, tol=1e-12).numpy()
    got = _complex(out)
    want = expm_multiply(-0.5j * H.to_numpy(), _complex(v))
    assert np.linalg.norm(got - want) < 1e-10
    H_ref = ref_models.localized(L)
    H_ref.allow_projection = True
    sub_ref = ref_subspaces.Parity('even', L=L)
    H_ref.add_subspace(sub_ref)
    ref = H_ref.evolve(_state(RefState, sub_ref, v), t=0.5,
                       tol=1e-12).to_numpy()
    assert np.linalg.norm(got - ref) < 1e-10
