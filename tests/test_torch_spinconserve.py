"""
The port's SpinConserve and XParity subspaces at the operator, state and
solver level, against the JAX package, on the CPU: conservation checks
(symbolic and on the device, rectangular pairs included), subspace
equality, infinity norms, XParity state conversion, state files, state
set-up and projection, and evolve/eigsolve in the half-filling sector.

Inputs are made in numpy and handed to both packages. Host results compare
exactly; vectors at 1e-12 (float64); evolve 1e-10 against the JAX package
(same substeps) and 1e-6 against expm_multiply; eigenvalues 1e-10
relative. The JAX package's solvers run on unsharded arrays (its Krylov
blocks with ``sharded=False``).
"""

import numpy as np
import pytest
import scipy.sparse.linalg
import torch
import jax.numpy as jnp
from threadpoolctl import threadpool_limits

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import operators as ref_ops
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.solvers.eigs import eigsolve_trlanczos as ref_trlanczos
from dynamite_tpu.solvers.expmv import expmv as ref_expmv
from dynamite_tpu.states import State as RefState

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import operators as ops
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.computations import eigsolve, evolve
from dynamite_tpu_torch.states import State

# One torch thread per xdist worker. torch on every core in several workers
# overloads the machine, and the JAX package's CPU collectives then miss
# XLA's rendezvous timeout and abort the worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 6


@pytest.fixture(autouse=True)
def reset_config():
    """Fresh configs, and numpy's BLAS at one thread like torch (ROADMAP.md
    queue 3)."""
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


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(
        np.max(np.abs(want)), 1e-30)


def _vec(dim, seed):
    rng = np.random.RandomState(seed)
    return rng.standard_normal(dim) + 1j * rng.standard_normal(dim)


# -- conservation ---------------------------------------------------------------

def _conserve_cases(m, mod, sp):
    """(operator, left, right) triples built from the operators module m,
    the models module mod and the subspaces module sp:
    tests/integration/test_operators.py:39-63, the unit test of
    tests/unit/test_operators.py:530-536, a rectangular SpinConserve pair
    in both orders for sigma_plus and sigma_minus, and XParity pairs."""
    def index_sum(op):
        return m.index_sum(op, size=L)
    sc = sp.SpinConserve
    return [
        (mod.localized(L), sc(L, L // 2), None),
        (mod.ising(L), sc(L, L // 2), None),
        (mod.ising(L), sp.Parity('even', L=L), None),
        (index_sum(m.sigmaz(0) * m.sigmaz(1)), sp.Parity('even', L=L), None),
        (index_sum(m.sigmax(0) * m.sigmax(1)), sp.Parity('odd', L=L), None),
        (index_sum(m.sigmax()), sp.Parity('even', L=L), None),
        (mod.heisenberg(4), sc(4, 2), None),
        (mod.ising(4), sc(4, 2), None),
        (index_sum(m.sigma_plus()), sc(L, 3), sc(L, 2)),
        (index_sum(m.sigma_plus()), sc(L, 2), sc(L, 3)),
        (index_sum(m.sigma_minus()), sc(L, 3), sc(L, 2)),
        (index_sum(m.sigma_minus()), sc(L, 2), sc(L, 3)),
        (mod.heisenberg(L), sp.XParity(sc(L, L // 2), '-'), None),
        (mod.localized(L), sp.XParity(sc(L, L // 2), '+'), None),
    ]


N_CONSERVE = len(_conserve_cases(ops, models, subspaces))


@pytest.mark.parametrize('case', range(N_CONSERVE))
def test_conserves_matches_reference(case):
    H, left, right = _conserve_cases(ops, models, subspaces)[case]
    H_ref, left_ref, right_ref = _conserve_cases(ref_ops, ref_models,
                                                 ref_subspaces)[case]
    H.L = H_ref.L = left.L
    want = H_ref.conserves(left_ref, right_ref)
    assert H.conserves(left, right) is want
    assert H._conserves_host(left, right) is want


def test_rectangular_pair_conserves_one_way():
    """sigma_plus (X + iY) lowers the weight of a state, sigma_minus raises
    it: each conserves the pair in one order only, as the reference says."""
    H = ops.index_sum(ops.sigma_plus(), size=L)
    H.L = L
    got = [H.conserves(subspaces.SpinConserve(L, a),
                       subspaces.SpinConserve(L, b))
           for a, b in ((2, 3), (3, 2))]
    assert sorted(got) == [False, True]


def test_projection_gate_and_rectangular_engine():
    H = models.ising(4)
    H.add_subspace(subspaces.SpinConserve(4, 2))
    with pytest.raises(ValueError, match='projection'):
        H.build_mat()
    H.allow_projection = True
    H.build_mat()
    # a rectangular pair runs the ELL engine, and agrees with the oracle
    H = models.heisenberg(L)
    left, right = subspaces.SpinConserve(L, 2), subspaces.SpinConserve(L, 3)
    H.allow_projection = True
    H.add_subspace(left, right)
    assert H.get_mat(subspaces=(left, right)).engine == 'ell'
    v = _vec(right.get_dimension(), 5)
    psi = State(subspace=right)
    psi.set_all_numpy(v)
    out = State(subspace=left)
    H.dot(psi, result=out)
    want = H.to_numpy(subspaces=(left, right)) @ v
    assert _rel(out.to_numpy(), want) <= 1e-12


# -- subspaces ------------------------------------------------------------------

def _equality_cases(sp):
    """tests/integration/test_subspaces.py:87-100, with XParity pairs."""
    return [
        (sp.Full(L=L), sp.Full(L=L)),
        (sp.Full(L=L), sp.Full(L=L + 1)),
        (sp.Parity('even', L=L), sp.Parity('even', L=L)),
        (sp.Parity('even', L=L), sp.Parity('odd', L=L)),
        (sp.SpinConserve(L, 2), sp.SpinConserve(L, 2)),
        (sp.SpinConserve(L, 2), sp.SpinConserve(L, 3)),
        (sp.XParity(sp.SpinConserve(L, 3), '+'),
         sp.XParity(sp.SpinConserve(L, 3), '-')),
        (sp.XParity(sp.Full(L=L)), sp.Full(L=L - 1)),
    ]


def test_subspace_equality_matches_reference():
    for (a, b), (a_ref, b_ref) in zip(_equality_cases(subspaces),
                                      _equality_cases(ref_subspaces)):
        assert (a == b) is (a_ref == b_ref)
        assert a.get_dimension() == a_ref.get_dimension()
        assert repr(a) == repr(a_ref).replace('dynamite_tpu.', '')
        assert a.identical(a.copy())


def test_subspace_arguments():
    with pytest.raises(ValueError):
        subspaces.SpinConserve(4, 5)
    with pytest.raises(DeprecationWarning):
        subspaces.SpinConserve(4, 2, spinflip='+')
    with pytest.raises(ValueError, match='k=L/2'):
        subspaces.XParity(subspaces.SpinConserve(6, 2))
    with pytest.raises(ValueError, match='even'):
        subspaces.XParity(subspaces.Parity('even', L=5))
    with pytest.raises(ValueError, match='sector'):
        subspaces.XParity(sector=0)
    sub = subspaces.SpinConserve(8, 4)
    assert (sub.L, sub.k, sub.nchoosek[4, 8]) == (8, 4, 70)
    assert sub.sector_layout.dim == 70
    assert hash(sub) == hash(subspaces.SpinConserve(8, 4))


@pytest.mark.parametrize('space', ['sc', 'xparity'])
def test_infinity_norm_matches_reference(space):
    def make(sp):
        base = sp.SpinConserve(8, 4)
        return base if space == 'sc' else sp.XParity(base, '-')
    for model in ('localized', 'long_range'):
        H = getattr(models, model)(8)
        H_ref = getattr(ref_models, model)(8)
        sub, sub_ref = make(subspaces), make(ref_subspaces)
        H.add_subspace(sub)
        H_ref.add_subspace(sub_ref)
        want = H_ref.infinity_norm()
        assert H.infinity_norm() == pytest.approx(want, rel=1e-12)
        assert H._infinity_norm_host() == pytest.approx(want, rel=1e-12)


def _xparity_pairs(sector):
    return [(sp.XParity(base, sector), ref.XParity(base_ref, sector))
            for sp, ref, base, base_ref in (
                (subspaces, ref_subspaces, subspaces.Full(L=L),
                 ref_subspaces.Full(L=L)),
                (subspaces, ref_subspaces, subspaces.Parity('odd', L=L),
                 ref_subspaces.Parity('odd', L=L)),
                (subspaces, ref_subspaces, subspaces.SpinConserve(L, L // 2),
                 ref_subspaces.SpinConserve(L, L // 2)))]


@pytest.mark.parametrize('sector', ['+', '-'])
def test_xparity_convert_state_matches_reference(sector):
    for xp, xp_ref in _xparity_pairs(sector):
        for to_parent in (True, False):
            src, src_ref = (xp, xp_ref) if to_parent else \
                (xp.parent, xp_ref.parent)
            vec = _vec(src.get_dimension(), seed=src.get_dimension())
            psi, psi_ref = State(subspace=src), RefState(subspace=src_ref)
            psi.set_all_numpy(vec)
            psi_ref.set_all_numpy(vec)
            out = xp.convert_state(psi)
            out_ref = xp_ref.convert_state(psi_ref)
            assert out.subspace is (xp.parent if to_parent else xp)
            assert _rel(out.to_numpy(), out_ref.to_numpy()) <= 1e-12
            if to_parent:
                back = xp.convert_state(out).to_numpy()
                assert _rel(back, vec) <= 1e-12


@pytest.mark.parametrize('space', ['sc', 'xparity_sc', 'xparity_parity'])
def test_state_files_cross_load(tmp_path, space):
    def make(sp):
        if space == 'sc':
            return sp.SpinConserve(L, 2)
        if space == 'xparity_sc':
            return sp.XParity(sp.SpinConserve(L, 3), '-')
        return sp.XParity(sp.Parity('even', L=L), '+')

    vec = _vec(make(subspaces).get_dimension(), seed=5)
    psi = State(subspace=make(subspaces))
    psi.set_all_numpy(vec)
    psi.save(str(tmp_path / 'port'))
    loaded_ref = RefState.from_file(str(tmp_path / 'port'))
    assert type(loaded_ref.subspace) is type(make(ref_subspaces))
    assert loaded_ref.subspace.identical(make(ref_subspaces))
    assert np.max(np.abs(loaded_ref.to_numpy() - vec)) < 1e-15

    psi_ref = RefState(subspace=make(ref_subspaces))
    psi_ref.set_all_numpy(vec)
    psi_ref.save(str(tmp_path / 'ref'))
    loaded = State.from_file(str(tmp_path / 'ref'))
    assert type(loaded.subspace) is type(make(subspaces))
    assert loaded.subspace.identical(make(subspaces))
    assert np.max(np.abs(loaded.to_numpy() - vec)) < 1e-15


@pytest.mark.parametrize('space', ['sc', 'xparity'])
def test_state_setup_matches_reference(space):
    def make(sp):
        base = sp.SpinConserve(8, 4)
        return base if space == 'sc' else sp.XParity(base, '+')
    sub, sub_ref = make(subspaces), make(ref_subspaces)
    # spin 7 up: both states are XParity representatives too
    for s in ('UUDDUDDU', 0b00110101):
        a, a_ref = State(state=s, subspace=sub), RefState(state=s,
                                                          subspace=sub_ref)
        assert np.array_equal(a.to_numpy(), a_ref.to_numpy())
        assert str(a) == str(a_ref)
    with pytest.raises(ValueError):
        State(state='UUUUUUUD', subspace=sub)

    def fn(states):
        return np.cos(states) + 1j * (states & 5)
    a, a_ref = State(subspace=sub), RefState(subspace=sub_ref)
    a.set_all_by_function(fn, vectorize=True)
    a_ref.set_all_by_function(fn, vectorize=True)
    assert _rel(a.to_numpy(), a_ref.to_numpy()) <= 1e-15
    a.project(2, 1)
    a_ref.project(2, 1)
    assert _rel(a.to_numpy(), a_ref.to_numpy()) <= 1e-12


# -- solvers --------------------------------------------------------------------

def _pair(space):
    def make(sp):
        base = sp.SpinConserve(12, 6)
        return base if space == 'sc' else sp.XParity(base, '+')
    H, H_ref = models.heisenberg(12), ref_models.heisenberg(12)
    sub, sub_ref = make(subspaces), make(ref_subspaces)
    H.add_subspace(sub)
    H_ref.add_subspace(sub_ref)
    return H, sub, H_ref


@pytest.mark.parametrize('space', ['sc', 'xparity'])
def test_evolve_and_eigsolve_vs_reference(space):
    """heisenberg(12) on SpinConserve(12, 6) (dim 924) and its XParity '+'
    half (dim 462): evolve against the JAX package's expmv and
    expm_multiply, eigsolve(nev=2) against its thick-restart Lanczos and
    eigvalsh."""
    H, sub, H_ref = _pair(space)
    ref_kernel = H_ref.get_mat()
    dim = sub.get_dimension()
    vec = _vec(dim, seed=dim)
    vec /= np.linalg.norm(vec)
    psi = State(subspace=sub)
    psi.set_all_numpy(vec)

    got = evolve(H, psi, t=1.0).to_numpy()
    anorm = H_ref.infinity_norm()
    assert H.infinity_norm() == pytest.approx(anorm, rel=1e-12)
    w = np.asarray(ref_expmv(ref_kernel.krylov_ops(30),
                             jnp.asarray(np.stack([vec.real, vec.imag])),
                             -1j * 1.0, anorm, ncv=30, tol=1e-7))
    Hm = H.to_numpy()
    assert np.linalg.norm(got - (w[0] + 1j * w[1])) < 1e-10
    oracle = scipy.sparse.linalg.expm_multiply(-1j * Hm, vec)
    assert np.linalg.norm(got - oracle) < 1e-6

    evals, evecs = eigsolve(H, nev=2, getvecs=True)
    want_ref, _S, _V = ref_trlanczos(ref_kernel.krylov_ops(20), dim,
                                     np.float64, nev=2)
    exact = np.linalg.eigvalsh(Hm.toarray())[:2]
    assert np.allclose(evals[:2], exact, rtol=1e-10, atol=1e-12)
    assert np.allclose(evals[:2], want_ref[:2], rtol=1e-10, atol=1e-12)
    for lam, v in zip(evals, evecs):
        x = v.to_numpy()
        assert np.linalg.norm(Hm @ x - lam * x) < 1e-6 * abs(lam)


def test_operator_projected_away_is_zero():
    """A Z field anticommutes with the global spin flip, so XParity drops
    every term: the operator builds and applies as zero."""
    H = ops.index_sum(ops.sigmaz(), size=L)
    H.allow_projection = True
    sub = subspaces.XParity(subspaces.SpinConserve(L, L // 2), '+')
    H.add_subspace(sub)
    psi = State(state='random', subspace=sub, seed=1)
    assert not np.any(H.dot(psi).to_numpy())
    assert H.to_numpy().nnz == 0


def test_sector_engine_and_xparity_refuse_ranks(monkeypatch, tmp_path):
    """With a process group of two ranks, SpinConserve pairs, plain and
    XParity-wrapped, take the sector engine's alpha ring (ops/sector_shard.py,
    whose build needs no collective), XParity over Full now takes the XOR
    route (ROADMAP.md queue 1, item 12) as Full does, and an
    XParity(SpinConserve) state converts to its parent and back, and loads
    from a file, each rank holding its rows of one process's result,
    bitwise (the two ranks run here in turn, the input's all-gather handed
    the whole vector; tests/test_torch_distributed.py spawns them)."""
    from dynamite_tpu_torch.ops import apply as apply_mod
    from dynamite_tpu_torch.ops.apply import OperatorKernel
    from dynamite_tpu_torch.parallel import mesh, multihost
    H = models.heisenberg(L)
    H.reduce_msc()
    xsc = subspaces.XParity(subspaces.SpinConserve(L, L // 2), '-')
    planes = np.random.RandomState(2).standard_normal(
        (2, xsc.get_dimension()))
    child = State(subspace=xsc)
    child.set_planes(planes)
    parent = xsc.convert_state(child)
    back = xsc.convert_state(parent).data
    assert torch.allclose(back, child.data, rtol=0, atol=1e-14)
    child.save(str(tmp_path / 'psi'))
    monkeypatch.setattr(multihost, 'world_size', lambda: 2)
    for sub in (subspaces.SpinConserve(L, L // 2),
                subspaces.XParity(subspaces.SpinConserve(L, L // 2))):
        msc = H.msc if sub.product_state_basis else sub.reduce_msc(H.msc)
        assert OperatorKernel(msc, sub, sub).engine == 'sector_ring'
    sub = subspaces.XParity(subspaces.Full(L=L))
    assert OperatorKernel(sub.reduce_msc(H.msc), sub, sub).engine == 'xor'
    full = subspaces.Full(L=L)
    assert OperatorKernel(H.msc, full, full).tables is not None
    for r in range(2):
        with monkeypatch.context() as m:
            m.setattr(multihost, 'rank', lambda: r)
            for src, to, want in ((child, xsc.parent, parent.data),
                                  (parent, xsc, back)):
                mine = State(subspace=src.subspace)
                mine.set_planes(src.data)
                n = len(src)
                padded = torch.zeros((2, 2 * mesh.local_dim(n)),
                                     dtype=src.data.dtype)
                padded[:, :n] = src.data
                m.setattr(apply_mod, 'all_gather_rows',
                          lambda t, padded=padded: padded)
                got = xsc.convert_state(mine)
                assert got.subspace is to
                assert torch.equal(got.data, mesh.local_rows(
                    want, want.shape[1]))
            loaded = State.from_file(str(tmp_path / 'psi'))
            assert torch.equal(loaded.data, mesh.local_rows(
                torch.as_tensor(planes), xsc.get_dimension()))
