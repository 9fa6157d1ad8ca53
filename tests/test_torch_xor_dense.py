"""
The port's XOR-dense channel engine (``dynamite_tpu_torch/ops/xor_dense.py``)
against the JAX package's (``dynamite_tpu/ops/xor_dense.py``), on the CPU.

SYK on Full and on both Parity sectors at the smallest sizes whose terms
overflow the XOR kernel's shared-memory tables (syk(12) on Full(12), syk(11)
on Parity(11)), the engine's minimum dimension lowered as
``tests/integration/test_multiply.py`` lowers the JAX package's. At a fixed split La the channel keys, matrices, row indices and
row signs equal the JAX package's bitwise; the applies agree with its
apply, with the port's XOR kernel's plain version and with
``msc_to_matrix`` (1e-12 relative in float64, 1e-5 in float32). The port's
split chooser, fed the JAX package's cost constants, makes its choice.
Dispatch: the XOR kernel first wherever its tables hold the operator
(few-mask operators, small SYK), the engine past that (over two ranks
too), and what neither takes runs the ELL engine. Eigenvalues of a small SYK agree with eigvalsh
to 1e-10.
"""

import numpy as np
import pytest
import torch
import jax
from threadpoolctl import threadpool_limits

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.ops import xor_dense as ref_xd
from dynamite_tpu.ops.pallas_apply import _effective_sign_mask as ref_eff

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.computations import eigsolve
from dynamite_tpu_torch.ops import apply as port_apply
from dynamite_tpu_torch.ops import xor_dense
from dynamite_tpu_torch.ops.xor_apply import (_effective_sign_mask,
                                              xor_apply_reference)
from dynamite_tpu_torch.states import State

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

SPACES = ['full', 'even', 'odd']
# per space, the smallest syk(n) on L = n spins whose terms overflow the XOR
# kernel's shared-memory tables (in float64), so that it takes the engine
ENGINE_N = {'full': 12, 'even': 11, 'odd': 11}
# the JAX package's split cost constants (TPU v5e), in the port's model
JAX_MODEL = xor_dense.CostModel(ref_xd._MXU_FLOPS, ref_xd._HBM_BPS,
                                ref_xd._STEP_S, 128, 384)


@pytest.fixture(autouse=True)
def reset_config(monkeypatch):
    """Fresh configs, the port on the CPU, numpy's BLAS at one thread, and
    both engines' minimum dimension lowered to 2**6."""
    saved_device = config._device
    config.device = 'cpu'
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    monkeypatch.setattr(xor_dense, 'MIN_DIM', 1 << 6)
    monkeypatch.setattr(ref_xd, 'MIN_DIM', 1 << 6)
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


def _sub(pkg, space, L):
    return pkg.Full(L=L) if space == 'full' else pkg.Parity(space, L=L)


_SYK = {}
_MATRIX = {}


def _syk(pkg, n):
    """A copy of ``pkg.syk(n)``, built once per package and n."""
    key = (pkg.__name__, n)
    if key not in _SYK:
        _SYK[key] = pkg.syk(n)
    return _SYK[key].copy()


def _matrix(H, space):
    """The port's msc_to_matrix of H on its subspace, built once per space
    (H is always the default syk of ``_pair``)."""
    if space not in _MATRIX:
        _MATRIX[space] = H.to_numpy()
    return _MATRIX[space]


def _pair(space, n=None, L=None):
    """syk(n) on the same subspace in both packages (by default the
    smallest that takes the engine)."""
    n = ENGINE_N[space] if n is None else n
    L = n if L is None else L
    H_ref = _syk(ref_models, n)
    s_ref = _sub(ref_subspaces, space, L)
    H_ref.add_subspace(s_ref)
    H = _syk(models, n)
    sub = _sub(subspaces, space, L)
    H.add_subspace(sub)
    return H_ref, s_ref, H, sub


def _ref_build(H_ref, s_ref, monkeypatch):
    """The JAX package's kernel and the tables its engine built: per class
    (Ms, rowidx, wh), as its ``_class_scan`` receives them."""
    captured = []
    real = ref_xd._class_scan

    def spy(Ms, rowidx, wh, *args, **kwargs):
        captured.append((Ms, rowidx, wh))
        return real(Ms, rowidx, wh, *args, **kwargs)

    monkeypatch.setattr(ref_xd, '_class_scan', spy)
    kernel = H_ref.get_mat(subspaces=(s_ref, s_ref))
    fn = jax.jit(kernel.traceable(sharded=False))
    assert kernel.xor_dense_info is not None
    return kernel, fn, captured


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize('space', SPACES)
@pytest.mark.parametrize('La', [3, 5])
def test_tables_bitwise(space, La, monkeypatch):
    """At a fixed La: the same channel keys, matrices (float64 and their
    float32 casts), row indices and row signs as the JAX package."""
    monkeypatch.setattr(ref_config, 'xor_dense_la', La, raising=False)
    monkeypatch.setattr(config, 'xor_dense_la', La, raising=False)
    H_ref, s_ref, H, sub = _pair(space)
    ref_kernel, _fn, captured = _ref_build(H_ref, s_ref, monkeypatch)
    kernel = H.get_mat(subspaces=(sub, sub))
    t = kernel.xor_dense
    assert kernel.tables is None and t.La == La
    assert kernel.xor_dense_info['La'] == ref_kernel.xor_dense_info['La']
    assert t.channels == ref_kernel.xor_dense_info['channels']

    plan = ref_kernel.plan
    eff = [[ref_eff(int(s), int(m), s_ref, s_ref) for s in signs]
           for m, _pm, signs, _c in plan.groups]
    want_keys = ref_xd._typed_channels_at(plan.groups, eff, La)
    assert {k for _typ, keys in t.classes for k in keys} == want_keys

    assert len(captured) == len(t.classes)
    for dtype, np_dtype in ((torch.float64, np.float64),
                            (torch.float32, np.float32)):
        runs = t.on(dtype, torch.device('cpu'))
        for (Ms, rowidx, wh), (_imag, Mt, ridx, wt, KB) in zip(captured,
                                                              runs):
            # the device tables hold B^T
            assert np.array_equal(Mt.transpose(1, 2).numpy(),
                                  Ms.astype(np_dtype))
            nb = ridx.shape[0]
            assert np.array_equal(
                ridx.view(nb, -1, KB).permute(0, 2, 1).reshape(-1, t.nh)
                .numpy(), rowidx)
            assert np.array_equal(
                wt.view(nb, -1, KB).permute(0, 2, 1).reshape(-1, t.nh)
                .numpy(), wh.astype(np_dtype))


@pytest.mark.parametrize('space', SPACES)
def test_apply_float64(space, monkeypatch):
    """The engine's apply against the JAX package's, the XOR kernel's plain
    version and msc_to_matrix, at 1e-12."""
    H_ref, s_ref, H, sub = _pair(space)
    _k, fn, _c = _ref_build(H_ref, s_ref, monkeypatch)
    kernel = H.get_mat(subspaces=(sub, sub))
    assert kernel.xor_dense is not None
    x = np.random.RandomState(3).standard_normal((2, sub.get_dimension()))
    got = kernel.apply(torch.as_tensor(x)).numpy()
    want_ref = np.asarray(fn(x))
    want = _matrix(H, space) @ (x[0] + 1j * x[1])
    plain = xor_apply_reference(
        torch.as_tensor(x), port_apply.XorTables(kernel.plan, sub)).numpy()
    assert _rel(got, want_ref) <= 1e-12
    assert _rel(got, plain) <= 1e-12
    assert _rel(got[0] + 1j * got[1], want) <= 1e-12


@pytest.mark.parametrize('space', SPACES)
def test_apply_float32(space, single_precision, monkeypatch):
    """Float32 tables and planes against the JAX package's float64 apply and
    msc_to_matrix, at 1e-5."""
    H_ref, s_ref, H, sub = _pair(space)
    _k, fn, _c = _ref_build(H_ref, s_ref, monkeypatch)
    kernel = H.get_mat(subspaces=(sub, sub))
    assert kernel.xor_dense.on(torch.float32, torch.device('cpu'))
    x = np.random.RandomState(4).standard_normal((2, sub.get_dimension()))
    got = kernel.apply(torch.as_tensor(x, dtype=torch.float32)).numpy()
    assert got.dtype == np.float32
    want = _matrix(H, space) @ (x[0] + 1j * x[1])
    assert _rel(got.astype(np.float64), np.asarray(fn(x))) <= 1e-5
    assert _rel(got[0] + 1j * got[1], want) <= 1e-5


@pytest.mark.parametrize('n,space', [(7, 'full'), (7, 'even'), (8, 'full'),
                                     (8, 'odd')])
def test_pick_split_with_jax_constants(n, space):
    """Fed the JAX package's constants and an unbinding budget, the port's
    split chooser makes the JAX package's choice (La, channels, modeled
    time)."""
    from dynamite_tpu.ops.apply import _Plan as RefPlan
    H_ref, s_ref, H, sub = _pair(space, n)
    ref_plan = RefPlan(H_ref.msc, s_ref, s_ref)
    plan = port_apply._Plan(H.msc, sub, sub)
    nbits = sub.get_dimension().bit_length() - 1
    ref_e = [[ref_eff(int(s), int(m), s_ref, s_ref) for s in signs]
             for m, _pm, signs, _c in ref_plan.groups]
    e = [[_effective_sign_mask(int(s), int(m), sub, sub) for s in signs]
         for m, _pm, signs, _c in plan.groups]
    want = ref_xd.pick_split(ref_plan.groups, ref_e, nbits, 1 << 40, 8)
    got = xor_dense.pick_split(plan.groups, e, nbits, 1 << 40, 8,
                               model=JAX_MODEL)
    assert got[1:3] == want[1:3]
    assert got[0] == pytest.approx(want[0], rel=1e-12)


def test_padded_channels_count_in_the_budget():
    """The budget counts what the engine allocates: every class padded to
    whole batches, with its row indices and signs. syk(8) on Full(8) at
    La = 1 has classes of more than one batch that do not fill their last
    one."""
    H = models.syk(8)
    sub = subspaces.Full(L=8)
    H.add_subspace(sub)
    plan = port_apply._Plan(H.msc, sub, sub)
    e = [[_effective_sign_mask(int(s), int(m), sub, sub) for s in signs]
         for m, _pm, signs, _c in plan.groups]
    La = 1
    t = xor_dense.XorDenseTables(plan, e, La, 8)
    counts = [len(keys) for _typ, keys in t.classes]
    assert any(c > xor_dense.CHANNEL_BATCH and c % xor_dense.CHANNEL_BATCH
               for c in counts)
    assert t.padded_channels > t.channels
    allocated = sum(Mt.numel() * 8 + ridx.numel() * 8 + wt.numel() * 8
                    for _i, Mt, ridx, wt, _kb
                    in t.on(torch.float64, torch.device('cpu')))
    keys = xor_dense._typed_channels_at(plan.groups, e, La)
    assert xor_dense.table_bytes(keys, La, 8, 8) == t.table_bytes \
        == allocated
    # the JAX package's count leaves the padding out
    unpadded = t.channels * (t.na ** 2 * 8 + t.nh * 8 + t.nh * 8)
    assert allocated > unpadded
    # a budget between the two excludes the split
    for budget in (allocated - 1, unpadded):
        pick = xor_dense.pick_split(plan.groups, e, 8, budget, 8)
        assert pick is None or pick[1] != La


def test_split_override_over_the_budget_raises(monkeypatch):
    """config.xor_dense_la replaces the chosen split only within
    config.ell_budget; over it the build raises, naming both."""
    monkeypatch.setattr(config, 'xor_dense_la', 9, raising=False)
    monkeypatch.setattr(config, 'ell_budget', 1 << 20, raising=False)
    H = _syk(models, 11)
    H.add_subspace(subspaces.Parity('even', L=11))
    with pytest.raises(ValueError, match='xor_dense_la = 9.*ell_budget'):
        H.get_mat()


def test_dispatch(monkeypatch):
    """The XOR kernel first wherever its tables hold the operator, in
    float32 and float64: long_range and localized (not ``use_scan``), and
    SYK up to syk(11) on Full(11). Past that, the engine: syk(12) on
    Full(12), at the engine's own minimum dimension, and syk(11) on
    Parity(11) below it. Over a process group of two ranks the engine
    takes syk(12) on Full(12) too, its split capped at a rank's block."""
    def kernel_of(H, sub):
        H.add_subspace(sub)
        return H.get_mat(subspaces=(sub, sub))

    for n in (7, 11):
        k = kernel_of(_syk(models, n), subspaces.Full(L=n))
        assert k.plan.use_scan and port_apply._kernel_holds(k.tables)
        assert k.xor_dense is None

    for model in (models.long_range, models.localized):
        k = kernel_of(model(12), subspaces.Full(L=12))
        assert not k.plan.use_scan
        assert k.tables is not None and k.xor_dense is None

    k = kernel_of(_syk(models, 11), subspaces.Parity('even', L=11))
    assert k.xor_dense is not None and k.tables is None
    assert not port_apply._kernel_holds(
        port_apply.XorTables(k.plan, k.left))

    monkeypatch.setattr(xor_dense, 'MIN_DIM', 1 << 12)
    k = kernel_of(_syk(models, 12), subspaces.Full(L=12))
    assert k.plan.use_scan and k.xor_dense is not None
    x = torch.as_tensor(np.random.RandomState(1).standard_normal((2, 4096)))
    plain = xor_apply_reference(x, port_apply.XorTables(k.plan, k.left))
    assert _rel(k.apply(x).numpy(), plain.numpy()) <= 1e-12

    _check_general_route(_syk(models, 11), subspaces.Parity('even', L=11))

    monkeypatch.setattr(port_apply.multihost, 'world_size', lambda: 2)
    sub = subspaces.Full(L=12)
    k = port_apply.OperatorKernel(_syk(models, 12).msc, sub, sub)
    assert k.engine == 'xor_dense' and k.xor_dense.La <= 11
    assert port_apply.sharded_route(k.plan, sub, sub, 2) == 'xor'


def test_disabled_engine(monkeypatch):
    """With config.use_xor_dense off, SYK runs on the XOR kernel's tables
    where they hold it, and agrees with the oracle; past them it takes the
    general route (ELL), and agrees too."""
    monkeypatch.setattr(config, 'use_xor_dense', False, raising=False)
    H = models.syk(7)
    sub = subspaces.Parity('even', L=7)
    H.add_subspace(sub)
    k = H.get_mat()
    assert k.xor_dense is None and k.tables is not None
    x = np.random.RandomState(2).standard_normal((2, sub.get_dimension()))
    got = k.apply(torch.as_tensor(x)).numpy()
    want = H.to_numpy() @ (x[0] + 1j * x[1])
    assert _rel(got[0] + 1j * got[1], want) <= 1e-12

    _check_general_route(_syk(models, 11), subspaces.Parity('even', L=11))


def _check_general_route(H, sub):
    """A many-mask operator that neither the XOR kernel's tables nor the
    XOR-dense engine take runs the ELL engine, and agrees with the
    oracle."""
    H.add_subspace(sub)
    k = H.get_mat()
    assert k.engine == 'ell' and k.xor_dense is None and k.tables is None
    x = np.random.RandomState(3).standard_normal((2, sub.get_dimension()))
    got = k.apply(torch.as_tensor(x)).numpy()
    want = H.to_numpy() @ (x[0] + 1j * x[1])
    assert _rel(got[0] + 1j * got[1], want) <= 1e-12


def test_operator_calls_on_syk():
    """dot, conserves and the infinity norm through an SYK operator on the
    engine, against the oracles (the JAX package's test_norm SYK case, and
    the sector it conserves)."""
    H = _syk(models, 11)
    sub = subspaces.Parity('even', L=11)
    H.add_subspace(sub)
    assert H.conserves(sub)
    assert H.get_mat().xor_dense is not None
    vec = np.random.RandomState(5).standard_normal(sub.get_dimension()) \
        + 1j * np.random.RandomState(6).standard_normal(sub.get_dimension())
    psi = State(subspace=sub)
    psi.set_all_numpy(vec)
    M = H.to_numpy()
    assert _rel(H.dot(psi).to_numpy(), M @ vec) <= 1e-12
    want = np.max(np.abs(np.asarray(M.todense())).sum(axis=1))
    assert H.infinity_norm() == pytest.approx(want, rel=1e-10)

    # tests/integration/test_norm.py's case: syk(L // 2) on Full(L)
    H_ref = ref_models.syk(3)
    s_ref = ref_subspaces.Full(L=6)
    H_ref.add_subspace(s_ref)
    H = models.syk(3)
    sub = subspaces.Full(L=6)
    H.add_subspace(sub)
    want = np.max(np.abs(np.asarray(H.to_numpy().todense())).sum(axis=1))
    assert H.infinity_norm() == pytest.approx(want, rel=1e-10)
    assert H.infinity_norm() == pytest.approx(H_ref.infinity_norm(),
                                              rel=1e-10)


@pytest.mark.parametrize('space', ['even', 'odd'])
def test_eigsolve_syk(space):
    """The lowest eigenvalue of syk(11) through the engine, against
    eigvalsh of the matrix, to 1e-10."""
    H = _syk(models, 11)
    sub = _sub(subspaces, space, 11)
    H.add_subspace(sub)
    assert H.get_mat().xor_dense is not None
    lam = eigsolve(H, nev=1, tol=1e-12)[0]
    want = np.linalg.eigvalsh(np.asarray(H.to_numpy().todense()))[0]
    assert abs(lam - want) <= 1e-10 * abs(want)
