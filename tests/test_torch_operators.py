"""
The port's host-side core — MSC algebra, text forms, to_numpy, save/load of
operators and states, conservation — against the JAX package, on the same
expressions. Files saved by either package load in the other. Host results
are exact (same numpy code paths), so they compare with ==; state data
compares at 1e-15 (float64 round trips).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import operators as ref_ops
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.states import State as RefState

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import operators as ops
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.states import State


# One torch thread per xdist worker. torch on every core in several workers
# overloads the machine, and the JAX package's CPU collectives then miss
# XLA's rendezvous timeout and abort the worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 8


@pytest.fixture(autouse=True)
def reset_config():
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    yield
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None


def _expressions(m):
    """The same operator expressions, built from module ``m``."""
    return {
        'paulis': m.sigmax(0) + 2 * m.sigmay(1) - 0.5j * m.sigmaz(2) *
        m.sigmax(2),
        'product': m.op_product([m.sigmax(0), m.sigmay(1), m.sigmaz(3)]),
        'plus_minus': m.sigma_plus(1) * m.sigma_minus(2) + 3,
        'index_sum': m.index_sum(m.sigmaz(0) * m.sigmaz(1), size=L),
        'periodic': m.index_sum(m.sigmax(0) * m.sigmay(1), size=L,
                                boundary='closed'),
        'index_product': m.index_product(m.sigmax(), size=4),
        'scaled_sum': 0.25 * m.op_sum(m.sigmax(i) for i in range(5)) / 2,
        'zero': m.zero() + m.identity(),
    }


@pytest.mark.parametrize('name', sorted(_expressions(ops)))
def test_algebra_and_text_match_reference(name):
    H_ref = _expressions(ref_ops)[name]
    H = _expressions(ops)[name]
    H_ref.reduce_msc()
    H.reduce_msc()
    assert np.array_equal(H.msc, H_ref.msc)
    assert str(H) == str(H_ref)
    assert repr(H) == repr(H_ref)
    assert H._repr_latex_() == H_ref._repr_latex_()
    assert H.table() == H_ref.table()
    assert H.serialize() == H_ref.serialize()
    assert H.nnz == H_ref.nnz and H.max_spin_idx == H_ref.max_spin_idx


@pytest.mark.parametrize('model', ['localized', 'ising', 'heisenberg', 'mbl',
                                   'long_range', 'xxz'])
def test_models_and_to_numpy_match_reference(model):
    H_ref = getattr(ref_models, model)(L)
    H = getattr(models, model)(L)
    H_ref.reduce_msc()
    H.reduce_msc()
    assert np.array_equal(H.msc, H_ref.msc)
    for space in ('even', 'odd'):
        H_ref.allow_projection = H.allow_projection = True
        sub_ref = ref_subspaces.Parity(space, L=L)
        sub = subspaces.Parity(space, L=L)
        got = H.to_numpy(subspaces=(sub, sub)).toarray()
        want = H_ref.to_numpy(subspaces=(sub_ref, sub_ref)).toarray()
        assert np.array_equal(got, want)
    assert np.array_equal(H.to_numpy(sparse=False),
                          H_ref.to_numpy(sparse=False))


def test_from_msc_carries_reference_operator():
    H_ref = ref_models.localized(L)
    H = ops.Operator.from_msc(H_ref.msc)
    assert np.array_equal(H.to_numpy().toarray(),
                          H_ref.to_numpy().toarray())


def test_operator_files_cross_load(tmp_path):
    H_ref = ref_models.mbl(L)
    H = models.mbl(L)
    ref_file, port_file = tmp_path / 'ref.msc', tmp_path / 'port.msc'
    H_ref.save(str(ref_file))
    H.save(str(port_file))
    assert ref_file.read_bytes() == port_file.read_bytes()
    loaded, loaded_ref = (ops.Operator.load(str(ref_file)),
                          ref_ops.Operator.load(str(port_file)))
    for op in (H_ref, loaded, loaded_ref):
        op.reduce_msc()
    assert np.array_equal(loaded.msc, H_ref.msc)
    assert np.array_equal(loaded_ref.msc, H_ref.msc)


@pytest.mark.parametrize('space', ['full', 'even', 'odd'])
def test_state_files_cross_load(tmp_path, space):
    def make(pkg):
        return pkg.Full(L=L) if space == 'full' else pkg.Parity(space, L=L)

    rng = np.random.RandomState(5)
    dim = make(subspaces).get_dimension()
    vec = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)

    psi = State(subspace=make(subspaces))
    psi.set_all_numpy(vec)
    psi.save(str(tmp_path / 'port'))
    loaded_ref = RefState.from_file(str(tmp_path / 'port'))
    assert type(loaded_ref.subspace) is type(make(ref_subspaces))
    assert loaded_ref.subspace == make(ref_subspaces)
    assert np.max(np.abs(loaded_ref.to_numpy() - vec)) < 1e-15

    psi_ref = RefState(subspace=make(ref_subspaces))
    psi_ref.set_all_numpy(vec)
    psi_ref.save(str(tmp_path / 'ref'))
    loaded = State.from_file(str(tmp_path / 'ref'))
    assert type(loaded.subspace) is type(make(subspaces))
    assert loaded.subspace == make(subspaces)
    assert np.max(np.abs(loaded.to_numpy() - vec)) < 1e-15


def test_state_carried_as_planes_and_printed():
    sub_ref = ref_subspaces.Parity('odd', L=L)
    sub = subspaces.Parity('odd', L=L)
    psi_ref = RefState(state='00000001', subspace=sub_ref)
    psi = State(subspace=sub)
    psi.set_planes(np.asarray(psi_ref.data))
    assert str(psi) == str(psi_ref)
    assert repr(State(state='00000001', subspace=sub)) == repr(psi_ref)

    for s in ('UUDDUDUD', 5):
        a_ref = RefState(state=s, subspace=ref_subspaces.Full(L=L))
        a = State(state=s, subspace=subspaces.Full(L=L))
        assert np.array_equal(a.to_numpy(), a_ref.to_numpy())
        assert str(a) == str(a_ref)


def test_state_arithmetic_matches_numpy():
    rng = np.random.RandomState(2)
    sub = subspaces.Full(L=L)
    dim = sub.get_dimension()
    u = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    v = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    a, b = State(subspace=sub), State(subspace=sub)
    a.set_all_numpy(u)
    b.set_all_numpy(v)
    assert abs(a.dot(b) - np.vdot(u, v)) < 1e-12 * abs(np.vdot(u, v))
    assert abs(a.norm() - np.linalg.norm(u)) < 1e-12 * np.linalg.norm(u)
    got = ((2 - 1j) * a + b - 0.5 * a + (1 + 1j)).to_numpy()
    assert np.allclose(got, (2 - 1j) * u + v - 0.5 * u + (1 + 1j),
                       rtol=1e-13, atol=1e-13)
    a.project(3, 1)
    states = np.arange(dim)
    w = np.where((states >> 3) & 1 == 1, u, 0)
    assert np.allclose(a.to_numpy(), w / np.linalg.norm(w), atol=1e-14)
    r = State(state='random', subspace=sub, seed=11)
    assert abs(r.norm() - 1) < 1e-12
    assert torch.equal(r.data,
                       State(state='random', subspace=sub, seed=11).data)


def test_conserves_matches_reference():
    for model in ('heisenberg', 'ising'):
        H_ref = getattr(ref_models, model)(L)
        H = getattr(models, model)(L)
        for l_sp, r_sp in (('even', 'even'), ('odd', 'even'), ('odd', 'odd')):
            want = H_ref.conserves(ref_subspaces.Parity(l_sp, L=L),
                                   ref_subspaces.Parity(r_sp, L=L))
            got = H.conserves(subspaces.Parity(l_sp, L=L),
                              subspaces.Parity(r_sp, L=L))
            assert got == want
        assert H.conserves(subspaces.Full(L=L))
    H = models.ising(L)
    H.add_subspace(subspaces.Parity('even', L=L))
    with pytest.raises(ValueError, match='projection'):
        H.get_mat()


def test_unported_subspaces_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        subspaces.SpinConserve(L, L // 2)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        subspaces.Explicit([0, 1])


def test_port_imports_no_jax():
    code = ('import sys; import dynamite_tpu_torch, '
            'dynamite_tpu_torch.operators, dynamite_tpu_torch.computations, '
            'dynamite_tpu_torch.models, dynamite_tpu_torch.extras, '
            'dynamite_tpu_torch.msc_tools; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "dynamite_tpu")]; '
            'assert not bad, bad')
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
