"""
The port's general routes over ranks (``ops/apply.py``'s
``_build_sharded_general``: the sector engine's alpha ring, each rank's ELL
tables, the sweeps by all-gather and by ring) on the CPU, with P in-process
virtual ranks (``VirtualTransport``, the same per-rank code as a process
group runs) at P = 1, 2, 3, 4, 8, against the JAX package and numpy
(mirroring tests/integration/test_uneven.py, test_sharded.py and
test_sector_shard.py):

* the padded layout: ``storage_dim`` against the JAX package's, and the
  per-rank helpers;
* the alpha layout's coordinates against the JAX package's
  ``AlphaLayout.engine_sources``;
* each rank's ELL rows against the JAX package's ``build_tables`` rows over
  the padded storage, and its conservation flag, AND-reduced over ranks;
* sharded ELL bitwise equal to the port's one-device ELL apply;
* every route against ``msc_to_matrix`` and, at P = 3, the JAX package's
  sharded apply on its virtual mesh (its sharded ELL tables), within 1e-12
  relative in float64, with the pad rows exactly 0;
* the dispatch table (pair, P, config) -> ``engine``, and the pairs left
  out until item 12's last slice routing;
* per-rank ring tables at P = 4 below 0.7x those at P = 2.

The spawned process-group runs of these routes (dot, evolve and eigsolve
on 2, 3 and 4 gloo ranks) are in tests/test_torch_distributed.py.
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
from dynamite_tpu.ops import ell as ref_ell
from dynamite_tpu.ops.apply import _Plan as RefPlan
from dynamite_tpu.ops.sector_apply import SectorPlan as RefSectorPlan
from dynamite_tpu.ops.sector_shard import AlphaLayout as RefAlphaLayout
from dynamite_tpu.parallel import mesh as ref_mesh

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import operators as ops
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.ops import ell
from dynamite_tpu_torch.ops.apply import (OperatorKernel, VirtualTransport,
                                          _Plan, sharded_route)
from dynamite_tpu_torch.ops.sector_apply import SectorPlan, table_bytes_estimate
from dynamite_tpu_torch.ops.sector_shard import (AlphaLayout,
                                                 _canonical_coords,
                                                 _local_coords)
from dynamite_tpu_torch.parallel import mesh

# one torch thread per xdist worker (ROADMAP.md queue 3)
torch.set_num_threads(1)

WORLDS = [1, 2, 3, 4, 8]


@pytest.fixture(autouse=True)
def reset_config():
    """Fresh configs, the port on the CPU, numpy's BLAS at one thread."""
    saved_device = config._device
    config.device = 'cpu'
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
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


def _ref_msc(H_ref, left_ref):
    H_ref.reduce_msc()
    if left_ref.product_state_basis:
        return H_ref.msc
    return left_ref.reduce_msc(H_ref.msc)


def _states(sub):
    return sub.idx_to_state(np.arange(sub.get_dimension()))


def _case(name, sp, m, o):
    """(operator, left, right) of a named pair in one package's modules;
    every operator allows projection."""
    if name == 'sc':
        H = m.localized(8)
        left = right = sp.SpinConserve(8, 4)
    elif name == 'xparity_sc':
        H = m.heisenberg(8)
        left = right = sp.XParity(sp.SpinConserve(8, 4), '-')
    elif name == 'auto':
        H = m.localized(8)
        left = right = sp.Auto(H, 'UUUUDDDD')
    elif name == 'explicit':
        H = m.localized(6)
        left = right = sp.Explicit(_states(sp.SpinConserve(6, 3))[::-1]
                                   .copy(), L=6)
    elif name == 'explicit_projected':
        # tests/integration/test_matrices.py:67-80: not conserved
        H = m.localized(5)
        left = right = sp.Explicit([0b00111, 0b01011, 0b01101, 0b10110,
                                    0b11001], L=5)
    elif name == 'rectangular':
        c = np.exp(1j * np.pi / 7)
        H = o.index_sum(c * o.sigma_plus() + np.conj(c) * o.sigma_minus(),
                        size=6)
        left, right = sp.SpinConserve(6, 3), sp.SpinConserve(6, 2)
    elif name == 'full_to_even':
        H = m.ising(6)
        left, right = sp.Parity('even', L=6), sp.Full(L=6)
    elif name == 'full':
        H = m.localized(8)
        left = right = sp.Full(L=8)
    elif name == 'sc_12':
        H = m.localized(12)
        left = right = sp.SpinConserve(12, 6)
    elif name == 'parity':
        H = m.heisenberg(8)
        left = right = sp.Parity('odd', L=8)
    else:
        raise ValueError(name)
    H.allow_projection = True
    H.add_subspace(left, None if right is left else right)
    return H, left, right


PAIRS = ['sc', 'xparity_sc', 'auto', 'explicit', 'explicit_projected',
         'rectangular', 'full_to_even', 'full', 'parity']
ROUTES = {'default': {},
          'ell': {'use_sector': False},
          'sweep': {'use_sector': False, 'use_ell': False,
                    'sharded_ring_general': False},
          'sweep_ring': {'use_sector': False, 'use_ell': False,
                         'sharded_ring_general': True}}


def _kernels(name, world, settings):
    """The port's operator, its one-device kernel and its kernel over
    ``world`` virtual ranks, both built under ``settings``."""
    H, left, right = _case(name, subspaces, models, ops)
    msc = H._msc_on(left)
    saved = {k: getattr(config, k) for k in settings}
    try:
        for k, v in settings.items():
            setattr(config, k, v)
        one = OperatorKernel(msc, left, right)
        over = OperatorKernel(msc, left, right,
                              transport=VirtualTransport(world))
    finally:
        for k, v in saved.items():
            setattr(config, k, v)
    return H, one, over


def _planes(dim, seed):
    v = np.random.RandomState(seed).standard_normal((2, dim))
    return v / np.linalg.norm(v)


def _padded(v, world):
    out = torch.zeros((2, mesh.storage_dim(v.shape[1], world)),
                      dtype=torch.float64)
    out[:, :v.shape[1]] = torch.as_tensor(v)
    return out


_JAX = {}


def _jax_sharded(name, world, v):
    """The JAX package's sharded apply of a pair on its virtual mesh of
    ``world`` devices, through its sharded ELL tables (its alpha ring and
    sweeps compute the same product but take 15-140 s to compile here),
    without the pad rows; kept per (pair, world)."""
    if (name, world) not in _JAX:
        saved = ref_config.mesh
        try:
            ref_config._mesh = ref_mesh.make_mesh(mesh_shape=(world,))
            ref_config.use_sector = False
            H, left, right = _case(name, ref_subspaces, ref_models, ref_ops)
            kernel = H.get_mat(subspaces=(left, right))
            x = ref_mesh.device_put_state(jnp.asarray(v), ref_config.mesh,
                                          right.get_dimension())
            y = np.asarray(kernel.traceable(sharded=True)(x))
        finally:
            ref_config._mesh = saved
            ref_config.use_sector = True
        _JAX[name, world] = y[:, :left.get_dimension()]
    return _JAX[name, world]


# -- the padded layout ----------------------------------------------------


@pytest.mark.parametrize('dim,world', [(184756, 8), (64, 8), (20, 8),
                                       (64, 6), (70, 3), (5, 4), (256, 3),
                                       (20, 1)])
def test_storage_dim(dim, world):
    """``storage_dim`` against the JAX package's (test_uneven.py), and the
    per-rank helpers: the ranks' real rows add up to dim, in order, and
    ``local_rows`` zeroes a rank's pad rows (dim 5 over 4 ranks: rank 3
    holds only pads)."""
    ref_config._initialize()
    assert mesh.storage_dim(dim, world) == ref_mesh.storage_dim(
        dim, ref_mesh.make_mesh(mesh_shape=(world,)))
    n = mesh.local_dim(dim, world)
    assert n * world == mesh.storage_dim(dim, world)
    counts = [mesh.valid_rows(dim, r, world) for r in range(world)]
    assert sum(counts) == dim
    assert counts == sorted(counts, reverse=True)
    planes = torch.arange(2 * dim, dtype=torch.float64).reshape(2, dim)
    joined = torch.cat([mesh.local_rows(planes, dim, r, world)
                        for r in range(world)], dim=1)
    assert torch.equal(joined[:, :dim], planes)
    assert not joined[:, dim:].any()
    if (dim, world) == (5, 4):
        assert counts == [2, 2, 1, 0]


# -- the alpha layout ------------------------------------------------------


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', ['sc', 'xparity_sc'])
def test_alpha_layout(name, world):
    """The port's AlphaLayout equals the JAX package's, field by field and
    in ``engine_sources`` for every rank; the torch coordinates equal the
    numpy ones, and each canonical row's (rank, position) in the alpha
    layout is the one that holds it."""
    H, left, right = _case(name, subspaces, models, ops)
    H_ref, left_ref, right_ref = _case(name, ref_subspaces, ref_models,
                                       ref_ops)
    plan = _Plan(H._msc_on(left), left, right)
    ref_plan = RefPlan(_ref_msc(H_ref, left_ref), left_ref, right_ref)
    alay = AlphaLayout(SectorPlan(plan, left, right, torch.float64,
                                  with_diag=False), world)
    ref_alay = RefAlphaLayout(RefSectorPlan(ref_plan, left_ref, right_ref,
                                            np.float64), world)
    for field in ('nb', 'na', 'off', 'w', 'aoff', 'local_dim', 'dim'):
        assert getattr(alay, field) == getattr(ref_alay, field), field
    meta = alay.meta('cpu')
    local_can = mesh.local_dim(alay.dim, world)
    sources = [alay.engine_sources(r) for r in range(world)]
    for r in range(world):
        assert np.array_equal(sources[r], ref_alay.engine_sources(r))
        assert np.array_equal(
            _local_coords(meta, alay.local_dim, r, 'cpu').numpy(),
            sources[r])
        d, p, valid = (t.numpy() for t in _canonical_coords(
            meta, local_can, alay.dim, r, 'cpu'))
        g = r * local_can + np.arange(local_can)
        assert np.array_equal(valid, g < alay.dim)
        for gi, di, pi in zip(g[valid], d[valid], p[valid]):
            assert sources[di][pi] == gi
    # every canonical row feeds exactly one engine position
    fed = np.concatenate(sources)
    assert np.array_equal(np.sort(fed[fed >= 0]), np.arange(alay.dim))


# -- each rank's ELL tables ------------------------------------------------


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', ['auto', 'rectangular'])
def test_ell_rows_match_reference(name, world):
    """Each rank's (G, rows) tables are its rows of the JAX package's
    ``build_tables`` over the padded storage (pad rows: column 0,
    coefficient 0), and the ranks' conservation flags, AND-ed, are the
    JAX package's."""
    H, left, right = _case(name, subspaces, models, ops)
    H_ref, left_ref, right_ref = _case(name, ref_subspaces, ref_models,
                                       ref_ops)
    plan = _Plan(H._msc_on(left), left, right)
    ref_plan = RefPlan(_ref_msc(H_ref, left_ref), left_ref, right_ref)
    G = len(plan.groups)
    sdim = mesh.storage_dim(plan.dim_left, world)
    *ref_tables, ref_conserved = ref_ell.build_tables(
        ref_plan, sdim, jnp.float64, with_conserves=True)
    ref = [None if t is None else np.asarray(t).reshape(-1, sdim)[:G]
           for t in ref_tables]
    n = mesh.local_dim(plan.dim_left, world)
    flags = []
    for r in range(world):
        rows = (r * n, (r + 1) * n)
        cols, fr, fi, conserved = ell.build_tables(
            plan, torch.float64, 'cpu', with_conserves=True, rows=rows)
        flags.append(conserved)
        sl = slice(*rows)
        assert np.array_equal(cols.numpy(), ref[0][:, sl])
        scale = np.max(np.abs(ref[1]))
        assert np.max(np.abs(fr.numpy() - ref[1][:, sl]),
                      initial=0) <= 1e-15 * scale
        assert (fi is None) is (ref[2] is None)
        if fi is not None:
            assert np.max(np.abs(fi.numpy() - ref[2][:, sl]),
                          initial=0) <= 1e-15 * scale
        pad = max(0, rows[1] - plan.dim_left)
        if pad:
            assert not cols[:, -pad:].any() and not fr[:, -pad:].any()
    assert all(flags) is bool(ref_conserved)
    assert ell.table_bytes(plan, sdim) == ref_ell.table_bytes(ref_plan, sdim)


@pytest.mark.parametrize('world', [2, 3, 4, 8])
@pytest.mark.parametrize('name', PAIRS)
def test_sharded_ell_bitwise(name, world):
    """Each rank's packed tables, applied to the gathered input, give its
    rows bitwise what the one-device tables give; the pads are 0; the
    ranks' nonzeros add up to the one-device count; the AND-ed
    conservation flag is the one-device flag."""
    _H, one, over = _kernels(name, world, {'use_sector': False,
                                           'use_ell': True})
    assert over.engine == ('xor' if name in ('full', 'parity')
                           and mesh.xor_layout(one.plan.dim_right, world)
                           else 'ell')
    if over.engine != 'ell':
        return
    cpu = torch.device('cpu')
    whole = ell.EllTables(one.plan)
    flag = whole.build_conserving(torch.float64, cpu)
    whole = whole.on(torch.float64, cpu)
    v = _planes(one.plan.dim_right, seed=world)
    y1 = ell.ell_apply(torch.as_tensor(v), whole)
    y = over.apply(_padded(v, world))
    dim = one.plan.dim_left
    assert torch.equal(y[:, :dim], y1)
    assert not y[:, dim:].any()
    tables = [over.sharded.tables[r].on(torch.float64, cpu)
              for r in range(world)]
    assert sum(t.nnz for t in tables) == whole.nnz
    assert all(t.dim_right == mesh.storage_dim(one.plan.dim_right, world)
               for t in tables)
    assert over.conserves_hint is flag


# -- every route -----------------------------------------------------------


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('route', list(ROUTES))
@pytest.mark.parametrize('name', PAIRS)
def test_routes_match_reference(name, route, world):
    """A route over virtual ranks against ``msc_to_matrix`` (through
    ``H.to_numpy``) and the
    port's one-device apply within 1e-12 relative (float64), and at P = 3
    against the JAX package's sharded apply on its virtual mesh; the pad
    rows of the result are exactly 0."""
    H, one, over = _kernels(name, world, ROUTES[route])
    dim_l, dim_r = one.plan.dim_left, one.plan.dim_right
    v = _planes(dim_r, seed=7)
    y = over.apply(_padded(v, world))
    assert y.shape == (2, mesh.storage_dim(dim_l, world))
    assert not y[:, dim_l:].any()
    got = y[:, :dim_l].numpy()
    got = got[0] + 1j * got[1]
    M = H.to_numpy(subspaces=(one.left, one.right))
    assert _rel(got, M @ (v[0] + 1j * v[1])) < 1e-12
    y1 = one.apply(torch.as_tensor(v)).numpy()
    assert _rel(got, y1[0] + 1j * y1[1]) < 1e-12
    if world == 3:
        ref = _jax_sharded(name, world, v)
        assert _rel(got, ref[0] + 1j * ref[1]) < 1e-12


# -- the dispatch ----------------------------------------------------------

DISPATCH = [
    # (pair, world, route settings, engine)
    ('sc', 1, 'default', 'sector_ring'),
    ('sc', 3, 'default', 'sector_ring'),
    ('xparity_sc', 4, 'default', 'sector_ring'),
    ('sc', 3, 'ell', 'ell'),
    ('sc', 3, 'sweep', 'sweep'),
    ('sc', 3, 'sweep_ring', 'sweep_ring'),
    ('auto', 2, 'default', 'ell'),
    ('explicit', 8, 'default', 'ell'),
    ('rectangular', 3, 'default', 'ell'),
    ('full_to_even', 4, 'default', 'ell'),
    ('full', 1, 'default', 'xor'),
    ('full', 2, 'default', 'xor'),
    ('full', 3, 'default', 'ell'),
    ('full', 8, 'default', 'xor'),
    ('parity', 3, 'default', 'ell'),
    ('parity', 3, 'sweep', 'sweep'),
    ('auto', 3, 'sweep', 'sweep'),
]


@pytest.mark.parametrize('name,world,route,engine', DISPATCH)
def test_dispatch(name, world, route, engine):
    """The route of a pair over P ranks in the JAX package's order: the
    XOR route on power-of-two worlds that divide the dimension, else the
    sector ring, ELL, the ring sweep, the all-gather sweep."""
    _H, _one, over = _kernels(name, world, ROUTES[route])
    assert over.engine == engine
    saved = {k: getattr(config, k) for k in ROUTES[route]}
    try:
        for k, v in ROUTES[route].items():
            setattr(config, k, v)
        assert sharded_route(over.plan, over.left, over.right,
                             world) == engine
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def test_ring_by_size(monkeypatch):
    """With ``sharded_ring_general`` None the sweep takes the ring once a
    gathered input would pass RING_GENERAL_BYTES."""
    from dynamite_tpu_torch.ops import apply
    settings = {'use_sector': False, 'use_ell': False,
                'sharded_ring_general': None}
    assert _kernels('sc', 3, settings)[2].engine == 'sweep'
    monkeypatch.setattr(apply, 'RING_GENERAL_BYTES', 2 * 72 * 8 - 1)
    assert _kernels('sc', 3, settings)[2].engine == 'sweep_ring'
    monkeypatch.setattr(apply, 'RING_GENERAL_BYTES', 2 * 72 * 8)
    assert _kernels('sc', 3, settings)[2].engine == 'sweep'


@pytest.mark.parametrize('world', [2, 3])
def test_left_out_pairs_raise(world, monkeypatch):
    """The pairs item 12 left out until now route over ranks (ROADMAP.md
    queue 1): XParity over Full takes the XOR route on a world it divides
    (2) and the general route (ELL) on another (3); a many-mask XOR
    operator past the kernel's tables takes the XOR-dense engine over the
    XOR route's layout once the engine takes its dimension, the ELL route
    below it and on another world. Each applies as on one device."""
    def check(H, sub, want):
        H.add_subspace(sub)
        msc = H._msc_on(sub)
        k = OperatorKernel(msc, sub, sub, transport=VirtualTransport(world))
        assert k.engine == want
        dim = sub.get_dimension()
        x = _planes(dim, seed=world)
        padded = torch.zeros((2, mesh.storage_dim(dim, world)),
                             dtype=torch.float64)
        padded[:, :dim] = torch.as_tensor(x)
        got = k.apply(padded)
        assert not got[:, dim:].any()
        want_y = OperatorKernel(msc, sub, sub).apply(torch.as_tensor(x))
        assert _rel(got[:, :dim].numpy(), want_y.numpy()) <= 1e-12

    check(models.heisenberg(6), subspaces.XParity(subspaces.Full(L=6), '+'),
          'xor' if world == 2 else 'ell')
    check(models.syk(11), subspaces.Parity('even', L=11), 'ell')
    from dynamite_tpu_torch.ops import xor_dense
    monkeypatch.setattr(xor_dense, 'MIN_DIM', 1 << 6)
    check(models.syk(11), subspaces.Parity('even', L=11),
          'xor_dense' if world == 2 else 'ell')


@pytest.mark.parametrize('case', ['parity_1', 'xparity_full_1',
                                  'full_2_over_4'])
def test_one_row_blocks(case):
    """Blocks of one row (local_bits 0) on the XOR route: Parity(L=1) and
    XParity(Full(1)) on one device, Full(2) over 4 virtual ranks. H x
    equals the matrix's product to 1e-14."""
    L, world = (2, 4) if case == 'full_2_over_4' else (1, 1)
    config.L = L
    if case == 'parity_1':
        H, sub = 0.5 * ops.sigmaz(0), subspaces.Parity('odd', L=1)
    elif case == 'xparity_full_1':
        H, sub = 0.7 * ops.sigmax(0), subspaces.XParity(subspaces.Full(L=1),
                                                          '-')
    else:
        H = (ops.sigmax(0) * ops.sigmax(1) + 0.4 * ops.sigmay(0)
             * ops.sigmaz(1) + 0.3 * ops.sigmaz(0) + 0.2 * ops.sigmax(1))
        sub = subspaces.Full(L=2)
    H.add_subspace(sub)
    k = OperatorKernel(H._msc_on(sub), sub, sub,
                       transport=VirtualTransport(world) if world > 1
                       else None)
    assert k.engine == 'xor'
    dim = sub.get_dimension()
    x = _planes(dim, seed=1)
    got = k.apply(_padded(x, world))[:, :dim].numpy()
    want = H.to_numpy() @ (x[0] + 1j * x[1])
    assert np.max(np.abs(got[0] + 1j * got[1] - want)) <= 1e-14


# -- memory ----------------------------------------------------------------


def test_ring_tables_scale_with_ranks():
    """Per-rank tables of the alpha ring (the M rows a rank owns, its ca
    slice and diagonal, and the N, W and bidx every rank holds) at P = 4
    are below 0.7x those at P = 2 (the port's form of
    test_sector_shard.py::test_memory_scales_with_devices)."""
    def per_rank(world):
        _H, _one, over = _kernels('sc_12', world, {})
        assert over.engine == 'sector_ring'
        return max(over.sharded.table_bytes(r, torch.float64,
                                            torch.device('cpu'))
                   for r in range(world))
    assert per_rank(4) < 0.7 * per_rank(2)


def _held_bytes(route, dtype):
    """The bytes of the tensors each virtual rank of a built route holds
    in ``dtype`` on the CPU, summed over the ranks."""
    cpu = torch.device('cpu')
    if route.engine == 'ell':
        return sum(route.tables[r].on(dtype, cpu).nbytes
                   for r in range(route.world))
    tabs = route.on(dtype, cpu)
    shared = sum(t.numel() * t.element_size() for t in tabs['shared'])
    return sum(shared + sum(t.numel() * t.element_size()
                            for t in tabs[r].own)
               for r in range(route.world))


@pytest.mark.parametrize('world', [2, 3, 4, 8])
@pytest.mark.parametrize('name,route', [('sc', 'default'),
                                        ('xparity_sc', 'default'),
                                        ('sc_12', 'default'),
                                        ('sc', 'ell'), ('auto', 'default'),
                                        ('rectangular', 'default')])
def test_estimate_over_ranks(name, route, world):
    """``estimate_memory(mpi_size=P)`` of a pair off the XOR route: before
    the build the tables' count over P ranks is at least what the ranks
    then hold, and after the build (the kernel over P virtual ranks)
    exactly that, summed over the ranks; the alpha ring's bytes, counted
    from its plan, are the bytes of its tensors (float64 and float32)."""
    settings = ROUTES[route]
    H, one, over = _kernels(name, world, settings)
    pair = (one.left, one.right)
    saved = {k: getattr(config, k) for k in settings}
    try:
        for k, v in settings.items():
            setattr(config, k, v)
        before = H._engine_table_bytes(world)
        H._kernels[pair] = over
        after = H._engine_table_bytes(world)
    finally:
        for k, v in saved.items():
            setattr(config, k, v)
    held = _held_bytes(over.sharded, config.real_dtype)
    assert after == held
    assert before >= after
    if over.engine == 'sector_ring':
        for dtype in (torch.float64, torch.float32):
            assert over.sharded.total_bytes(dtype, torch.device('cpu')) \
                == _held_bytes(over.sharded, dtype)


@pytest.mark.parametrize('L, world', [(22, 1), (22, 4), (24, 1)])
def test_ring_estimate_at_large_l(L, world):
    """The alpha ring's count before the build bounds the tensors its ranks
    then hold at the sizes where the column matrices dominate: from L=22
    at one rank, a count that shared one matrix between the sectors of
    equal alpha dimension (C(La, ka) = C(La, La - ka)) fell below them
    (0.935 of them at L=22)."""
    saved = config._L
    config.L = L
    try:
        H = models.heisenberg(L)
        sub = subspaces.SpinConserve(L, L // 2)
        H.add_subspace(sub)
        plan = _Plan(H._msc_on(sub), sub, sub)
        with threadpool_limits(1):
            over = OperatorKernel(H._msc_on(sub), sub, sub,
                                  transport=VirtualTransport(world))
    finally:
        config._L = saved
    assert over.engine == 'sector_ring'
    est = table_bytes_estimate(plan, sub, sub, world)
    assert est >= _held_bytes(over.sharded, config.real_dtype) > 0
