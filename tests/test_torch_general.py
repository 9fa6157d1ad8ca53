"""
The port's general engine against the JAX package, on the CPU: the ELL
tables (``ops/ell.py``: cols, fr, fi and the conservation flag of the same
pass) against ``dynamite_tpu.ops.ell.build_tables`` at the same plan; the
kernel's plain version (``ell_apply_reference``, what ``ell_apply`` runs on
a CPU tensor) and the on-the-fly sweep (``general_sweep``) against each
other and against the JAX package's ``H.dot``; the dispatch (ELL within
``config.ell_budget``, the sweep over it and with ``config.use_ell`` off);
eigsolve and evolve on an Auto sector; ``estimate_memory`` and ``spy``.

The pairs: Explicit (sorted and not), Auto (both orders), XParity over
Explicit, the rectangular SpinConserve pair of e^{i pi/7} sigma_plus plus
its adjoint (imaginary coefficients: the fi table), the Full <-> Parity
projections of tests/integration/test_matrices.py:67-113, and a many-mask
XOR operator below the XOR-dense engine's minimum dimension.

Tolerances: cols exactly; fr and fi within 1e-15 of the largest
coefficient (the two packages sum a chunk's terms in different orders);
applies 1e-12 relative in float64 and 1e-5 in float32; eigenvalues 1e-10.
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
from dynamite_tpu.ops import ell as ref_ell
from dynamite_tpu.ops.apply import _Plan as RefPlan
from dynamite_tpu.solvers.eigs import eigsolve_trlanczos as ref_trlanczos
from dynamite_tpu.solvers.expmv import expmv as ref_expmv
from dynamite_tpu.states import State as RefState

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import operators as ops
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.computations import eigsolve, evolve
from dynamite_tpu_torch.ops import ell
from dynamite_tpu_torch.ops.apply import _Plan, general_sweep
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
    # the JAX package's float64 path (x64 on), before any table is built
    ref_config._initialize()
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
    v = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    return v / np.linalg.norm(v)


def _states(sub):
    return sub.idx_to_state(np.arange(sub.get_dimension()))


def _case(name, sp, m, o):
    """(operator, left, right) of a named case, in one package's modules;
    every operator allows projection."""
    if name in ('auto', 'auto_nosort'):
        H = m.localized(8)
        sub = sp.Auto(H, 'UUUUDDDD', sort=name == 'auto')
        left = right = sub
    elif name == 'explicit_unsorted':
        H = m.localized(L)
        sub = sp.Explicit(_states(sp.SpinConserve(L, 3))[::-1].copy(), L=L)
        left = right = sub
    elif name == 'explicit_sorted':
        # tests/integration/test_matrices.py:67-80
        H = m.localized(5)
        sub = sp.Explicit([0b00111, 0b01011, 0b01101, 0b10110, 0b11001],
                          L=5)
        left = right = sub
    elif name == 'xparity_explicit':
        H = m.heisenberg(L)
        parent = sp.Explicit(_states(sp.SpinConserve(L, 3)), L=L)
        left = right = sp.XParity(parent, '-')
    elif name == 'rectangular':
        c = np.exp(1j * np.pi / 7)
        H = o.index_sum(c * o.sigma_plus() + np.conj(c) * o.sigma_minus(),
                        size=L)
        left, right = sp.SpinConserve(L, 3), sp.SpinConserve(L, 2)
    elif name == 'full_to_even':
        H = m.ising(L)
        left, right = sp.Parity('even', L=L), sp.Full(L=L)
    elif name == 'even_to_full':
        H = m.ising(L)
        left, right = sp.Full(L=L), sp.Parity('even', L=L)
    elif name == 'many_mask_xor':
        # syk(11) on Parity(11): past the XOR kernel's shared-memory
        # tables, below the XOR-dense engine's minimum dimension
        H = m.syk(11)
        left = right = sp.Parity('even', L=11)
    else:
        raise ValueError(name)
    H.allow_projection = True
    H.add_subspace(left, right)
    return H, left, right


CASES = ['auto', 'auto_nosort', 'explicit_unsorted', 'explicit_sorted',
         'xparity_explicit', 'rectangular', 'full_to_even', 'even_to_full',
         'many_mask_xor']


def _plans(name):
    """The port's and the JAX package's plans of a case, with the port's
    operator and subspaces."""
    H, left, right = _case(name, subspaces, models, ops)
    H_ref, left_ref, right_ref = _case(name, ref_subspaces, ref_models,
                                       ref_ops)
    return (_Plan(H._msc_on(left), left, right),
            RefPlan(H_ref._msc_on(left_ref) if hasattr(H_ref, '_msc_on')
                    else _ref_msc(H_ref, left_ref), left_ref, right_ref),
            H, left, right, H_ref, left_ref, right_ref)


def _ref_msc(H_ref, left_ref):
    H_ref.reduce_msc()
    if left_ref.product_state_basis:
        return H_ref.msc
    return left_ref.reduce_msc(H_ref.msc)


@pytest.mark.parametrize('name', CASES)
def test_tables_match_reference(name):
    plan, ref_plan = _plans(name)[:2]
    cols, fr, fi, conserved = ell.build_tables(plan, torch.float64, 'cpu',
                                               with_conserves=True)
    *ref_tables, ref_conserved = ref_ell.build_tables(
        ref_plan, ref_plan.dim_left, jnp.float64, with_conserves=True)
    G, rows = len(plan.groups), plan.dim_left
    assert len(ref_plan.groups) == G
    ref_cols, ref_fr = (np.asarray(t).reshape(-1, rows)[:G]
                        for t in ref_tables[:2])
    assert cols.dtype == torch.int32 and cols.shape == (G, rows)
    assert np.array_equal(cols.numpy(), ref_cols)
    scale = np.max(np.abs(ref_fr))
    assert np.max(np.abs(fr.numpy() - ref_fr)) <= 1e-15 * scale
    assert (fi is None) is (ref_tables[2] is None)
    if fi is not None:
        ref_fi = np.asarray(ref_tables[2]).reshape(-1, rows)[:G]
        assert np.max(np.abs(fi.numpy() - ref_fi)) <= \
            1e-15 * max(scale, np.max(np.abs(ref_fi)))
    assert conserved is bool(ref_conserved)
    assert ell.table_bytes(plan) == ref_ell.table_bytes(ref_plan)


def test_conservation_flag():
    """The flag of the build pass, a row-wise test (every row's images lie
    in the right subspace): True on the sectors an operator conserves,
    False on the square pairs it projects, as the device reduction and the
    host oracle decide; True for Parity -> Full, whose right subspace
    holds every image (so the build gate uses the flag on square pairs
    only)."""
    flags = {name: ell.build_tables(_plans(name)[0], torch.float64, 'cpu',
                                    with_conserves=True)[3]
             for name in ('auto', 'explicit_unsorted', 'explicit_sorted',
                          'full_to_even', 'rectangular')}
    assert flags == {'auto': True, 'explicit_unsorted': True,
                     'explicit_sorted': False, 'full_to_even': True,
                     'rectangular': False}
    H, sub, _ = _case('explicit_sorted', subspaces, models, ops)
    assert H.conserves(sub) is H._conserves_host(sub) is False


def _reference_apply(name, ref_plan, H_ref, left_ref, right_ref, vec):
    """The JAX package's y = H x: its ``H.dot``, or, for the many-mask
    case (whose ``H.dot`` on the 8-device test mesh takes minutes on the
    CPU), its ELL engine's own apply (``make_apply`` over its tables, the
    route its dispatch takes on one device)."""
    if name == 'many_mask_xor':
        cols, fr, fi = ref_ell.build_tables(ref_plan, ref_plan.dim_left,
                                            jnp.float64)
        apply_fn = ref_ell.make_apply(ref_plan.dim_left, fi is not None)
        x = jnp.asarray(np.stack([vec.real, vec.imag]))
        y = np.asarray(apply_fn(x, cols, fr) if fi is None
                       else apply_fn(x, cols, fr, fi))
        return y[0] + 1j * y[1]
    psi_ref = RefState(subspace=right_ref)
    psi_ref.set_all_numpy(vec)
    out_ref = RefState(subspace=left_ref)
    H_ref.dot(psi_ref, result=out_ref)
    return out_ref.to_numpy()


@pytest.mark.parametrize('name', CASES)
def test_applies_match_reference(name):
    """ell_apply over the packed tables (its plain version on the CPU),
    sell_apply_reference, ell_apply_reference over the (G, rows) tables
    and general_sweep against the JAX package's apply and the numpy oracle
    (``to_numpy``), in float64 and float32."""
    plan, ref_plan, H, left, right, H_ref, left_ref, right_ref = \
        _plans(name)
    vec = _vec(right.get_dimension(), seed=11)
    want = _reference_apply(name, ref_plan, H_ref, left_ref, right_ref, vec)
    assert _rel(H.to_numpy(subspaces=(left, right)) @ vec, want) <= 1e-12
    psi = State(subspace=right)
    psi.set_all_numpy(vec)
    out = State(subspace=left)
    H.dot(psi, result=out)
    kernel = H.get_mat(subspaces=(left, right))
    assert kernel.engine == 'ell'
    assert _rel(out.to_numpy(), want) <= 1e-12
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        x = torch.as_tensor(np.stack([vec.real, vec.imag]), dtype=dtype)
        tables = kernel.ell_tables.on(dtype, 'cpu')
        for y in (ell.ell_apply(x, tables),
                  ell.sell_apply_reference(x, tables),
                  ell.ell_apply_reference(
                      x, *ell.build_tables(plan, dtype, 'cpu')),
                  general_sweep(x, plan)):
            assert y.dtype == dtype and y.shape == (2, left.get_dimension())
            y = y.double().numpy()
            assert _rel(y[0] + 1j * y[1], want) <= tol


def test_cpu_wrapper_counts_no_launch():
    plan = _plans('auto')[0]
    tables = ell.pack_tables(*ell.build_tables(plan, torch.float64, 'cpu'),
                             plan.dim_right)
    before = tracing.counter('ell.launches')
    ell.ell_apply(torch.zeros((2, plan.dim_right), dtype=torch.float64),
                  tables)
    assert tracing.counter('ell.launches') == before


@pytest.mark.parametrize('route', ['ell', 'over_budget', 'use_ell_off'])
def test_dispatch(route, monkeypatch):
    """ELL within the budget; the sweep over it and with use_ell off;
    the same result either way. The budget is compared with the tables'
    bytes as the JAX package counts them (fi included)."""
    H, sub, _ = _case('auto', subspaces, models, ops)
    plan = _Plan(H._msc_on(sub), sub, sub)
    need = ell.table_bytes(plan)
    assert need == len(plan.groups) * plan.dim_left * (4 + 8 + 8)
    if route == 'over_budget':
        monkeypatch.setattr(config, 'ell_budget', need - 1)
    elif route == 'use_ell_off':
        monkeypatch.setattr(config, 'use_ell', False)
    else:
        monkeypatch.setattr(config, 'ell_budget', need)
    kernel = H.get_mat()
    assert kernel.engine == ('ell' if route == 'ell' else 'sweep')
    assert (kernel.ell_tables is None) is (route != 'ell')
    vec = _vec(sub.get_dimension(), seed=3)
    before = tracing.counter('sweep.applies')
    y = kernel.apply(torch.as_tensor(np.stack([vec.real, vec.imag])))
    assert tracing.counter('sweep.applies') == before + (route != 'ell')
    want = H.to_numpy() @ vec
    assert _rel(y[0].numpy() + 1j * y[1].numpy(), want) <= 1e-12
    # the conservation gate without the build's flag: the device reduction
    assert kernel.conserves_hint is (True if route == 'ell' else None)


@pytest.mark.parametrize('sort', [True, False])
def test_evolve_and_eigsolve_on_auto(sort):
    """heisenberg(12) on its half-filling Auto sector (dim 924): evolve
    against the JAX package's expmv and expm_multiply, eigsolve(nev=2)
    against its thick-restart Lanczos and eigvalsh."""
    H, H_ref = models.heisenberg(12), ref_models.heisenberg(12)
    sub = subspaces.Auto(H, 'UD' * 6, sort=sort)
    sub_ref = ref_subspaces.Auto(H_ref, 'UD' * 6, sort=sort)
    H.add_subspace(sub)
    H_ref.add_subspace(sub_ref)
    assert H.get_mat().engine == 'ell'
    ref_kernel = H_ref.get_mat()
    dim = sub.get_dimension()
    vec = _vec(dim, seed=dim)
    psi = State(subspace=sub)
    psi.set_all_numpy(vec)
    got = evolve(H, psi, t=1.0).to_numpy()
    anorm = H_ref.infinity_norm()
    assert H.infinity_norm() == pytest.approx(anorm, rel=1e-12)
    w = np.asarray(ref_expmv(ref_kernel.krylov_ops(30),
                             jnp.asarray(np.stack([vec.real, vec.imag])),
                             -1j * 1.0, anorm, ncv=30, tol=1e-7))
    assert np.linalg.norm(got - (w[0] + 1j * w[1])) < 1e-10
    Hm = H.to_numpy()
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


# -- estimate_memory and spy ----------------------------------------------------

def _estimate_case(name, sp, m, o):
    if name == 'sector':
        H, sub = m.heisenberg(8), sp.SpinConserve(8, 4)
        H.add_subspace(sub)
        return H
    if name == 'xor':
        H = m.localized(8)
        H.add_subspace(sp.Full(L=8))
        return H
    return _case(name, sp, m, o)[0]


@pytest.mark.parametrize('name', ['sector', 'rectangular', 'full_to_even',
                                  'xor', 'auto'])
def test_estimate_memory_matches_reference(name):
    """Where both packages build the same tables (the sector engine) the
    estimates are equal. The port counts what it builds: no fi table for
    real coefficients, one plane of the XOR diagonal stream for a real
    diagonal, an Explicit subspace's state tables once per array (the JAX
    package counts fi and two planes always, and a square pair's tables
    twice); before the build, the most its packed ELL tables can take
    (``ell.packed_bound``: the (G, rows) count and the slice pointers),
    and after it the bytes they hold, never more."""
    H = _estimate_case(name, subspaces, models, ops)
    H_ref = _estimate_case(name, ref_subspaces, ref_models, ref_ops)
    got, want = H.estimate_memory(1), H_ref.estimate_memory(1)
    plan = _Plan(H._msc_on(H.left_subspace), H.left_subspace,
                 H.right_subspace)
    cb = 8  # float64
    G, rows = len(plan.groups), plan.dim_left
    slices = 8 * (-(-rows // ell.SLICE) + 1)  # the slice pointers
    if name == 'sector':
        assert got == want
    elif name == 'rectangular':
        assert got - want == pytest.approx(slices / 1e9, rel=1e-12)
    elif name == 'full_to_even':
        assert want - got == pytest.approx((G * rows * cb - slices) / 1e9,
                                           rel=1e-12)
    elif name == 'xor':
        assert want - got == pytest.approx(rows * cb / 1e9, rel=1e-12)
    else:
        sub = H.left_subspace
        maps = sum(a.nbytes for a in (sub.state_map, sub.rmap_states,
                                      sub.rmap_indices) if a is not None)
        assert want - got == pytest.approx(
            (G * rows * cb + maps - slices) / 1e9, rel=1e-12)
    # the measured tables of the ELL build
    kernel = H.get_mat(subspaces=(H.left_subspace, H.right_subspace))
    after = H.estimate_memory(1)
    if kernel.engine == 'ell':
        t = kernel.ell_tables.on(torch.float64, 'cpu')
        built = sum(v.numel() * v.element_size()
                    for v in (t.slice_ptr, t.cols, t.fr, t.fi)
                    if v is not None)
        assert built == kernel.ell_tables.nbytes(torch.float64) \
            == H._engine_table_bytes(1)
        assert built <= ell.packed_bound(plan, torch.float64)
    assert got >= after
    # the Krylov workspace
    assert (H.estimate_memory(1, ncv=20) - after) == pytest.approx(
        H_ref.estimate_memory(1, ncv=20) - H_ref.estimate_memory(1),
        rel=1e-12)


def test_spy(monkeypatch):
    import matplotlib
    matplotlib.use('Agg')
    from matplotlib import pyplot as plt
    shown = []
    monkeypatch.setattr(plt, 'show', lambda: shown.append(True))
    H, sub, _ = _case('auto', subspaces, models, ops)
    H.spy()
    assert shown == [True]
    plt.close('all')
    with pytest.raises(ValueError, match='too big'):
        H.spy(max_size=8)
