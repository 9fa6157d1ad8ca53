"""
The host tables of the port's XOR kernels (``ops/xor_apply.py``): the
diagonal stream's, and the matvec's slots with their per-tile coefficients
and the R-row sign classes, held against the JAX package.

The CUDA kernels cannot run here, so :func:`tile_apply` below computes y the
way the matvec kernel does, from the kernel's own tables: per tile, each
slot's coefficient from the tile's global high bits; per thread of R rows,
each sign class's sum from the thread's row offset; the R row factors by the
Walsh-Hadamard butterfly; plus the diagonal stream times x. Its output,
shard by shard at P = 1, 2, 4 and 8 and with the tile bits forced small (so
that a block holds several tiles and sign masks straddle the split), is held
against the port's plain version and against the JAX package's Pallas kernel
in interpret mode. :func:`fwht_diagonal` computes the diagonal stream the
way the diagonal kernel does: per tile, the coefficients g by low sign mask
from the tile's high bits, then a butterfly Walsh-Hadamard transform; it is
held against the port's plain version and the JAX package's
``compute_diagonal`` and ``PallasXorPlan``, on Full, Parity and XParity,
over 1 to 8 shards, at the kernel's tile and at tiles forced small.

Inputs are numpy-seeded planes. Tolerances, as max|dy| / max|y|: 1e-12 in
float64 and 1e-5 in float32 (the kernel's sums run in another order).
"""

import ctypes

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import operators as ref_operators
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.ops.pallas_apply import (PallasXorPlan, build_pallas_apply,
                                           compute_diagonal)

from dynamite_tpu_torch import computations
from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.operators import Operator
from dynamite_tpu_torch.ops import xor_apply as port_xor
from dynamite_tpu_torch.ops.xor_apply import (
    COMPLEX, DIAG_PRECOMPUTE_MIN_TERMS, DIAG_TILE_BITS, MIXED, DiagonalPlan,
    tile_shape, xor_apply_reference, xor_apply_sharded_reference,
    xor_diagonal)
from dynamite_tpu_torch.utils.bitwise import parity

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

# dim >= 2**10 on every sector for the Pallas kernel (MIN_BLOCK_BITS)
L = 11
MODELS = ['localized', 'heisenberg', 'ising', 'long_range', 'random',
          'random_few_diag']
SPACES = ['full', 'even', 'odd']
TOL = {np.float32: 1e-5, np.float64: 1e-12}
# (tile_bits, rows per thread) forced small: blocks of 2**7 rows and up hold
# several tiles
SMALL_TILES = [(4, 4), (3, 2), (2, 1)]
# the diagonal kernel's tile bits, and forced small: the shards of 2**7
# rows and up hold several tiles, and every shard is smaller than the
# kernel's tile of 2**12 rows
DIAG_TILES = [DIAG_TILE_BITS, 4, 1]
# the diagonal's cases: localized (the main path's), long_range (~50 terms),
# exactly the threshold's 4 terms, complex coefficients (two planes; see
# _diag_case), and (localized(8) - 0.3)^2 as eigsolve(target_method='fold')
# builds it
DIAG_MODELS = ['localized', 'long_range', 'four_diag', 'random_complex_diag',
               'folded_localized']
DIAG_SPACES = SPACES + ['xparity_plus', 'xparity_minus']


@pytest.fixture(autouse=True)
def reset_config():
    # the port runs on the card unless asked for the CPU
    saved_device = config._device
    config.device = 'cpu'
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    yield
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    config._device = saved_device


def _random_msc(n_diag, seed):
    """A random Hermitian operator with long sign masks, whose groups mix
    real and imaginary coefficients: 40 terms over 12 masks, plus n_diag
    mask-0 terms."""
    rng = np.random.RandomState(seed)
    masks = np.concatenate([rng.randint(1, 1 << L, 12)[rng.randint(0, 12, 40)],
                            np.zeros(n_diag, np.int64)])
    signs = rng.randint(0, 1 << L, len(masks))
    # Hermitian terms: imaginary where the string holds an odd number of Ys
    r = rng.uniform(-1, 1, len(masks))
    coeffs = np.where(parity(masks & signs) == 1, 1j * r, r)
    out = np.zeros(len(masks), dtype=[('masks', np.int64),
                                      ('signs', np.int64),
                                      ('coeffs', np.complex128)])
    out['masks'], out['signs'], out['coeffs'] = masks, signs, coeffs
    return out


def _diag_msc(model):
    """four_diag: the XX chain of L sites plus exactly
    DIAG_PRECOMPUTE_MIN_TERMS ZZ strings (of even weight: they keep the
    XParity sectors); folded_localized: (localized(8) - 0.3)^2."""
    if model == 'folded_localized':
        return computations._folded_msc(models.localized(8), 0.3)
    xx = models.xx(L).msc
    n = DIAG_PRECOMPUTE_MIN_TERMS
    out = np.zeros(len(xx) + n, dtype=xx.dtype)
    out[:len(xx)] = xx
    out['signs'][len(xx):] = [3, 6, (1 << 9) | 1, (1 << 10) | (1 << 4)]
    out['coeffs'][len(xx):] = [0.5, -0.25, 0.75, 0.125]
    return out


def _operator(pkg, model):
    if model == 'random':
        msc = _random_msc(6, seed=5)
    elif model == 'random_few_diag':
        msc = _random_msc(3, seed=6)
    elif model in ('four_diag', 'folded_localized'):
        msc = _diag_msc(model)
    else:
        return getattr(pkg.models, model)(L)
    if pkg is ref_pkg:
        return ref_operators.Operator(msc=msc)
    return Operator.from_msc(msc)


class ref_pkg:
    models = ref_models
    subspaces = ref_subspaces


class port_pkg:
    models = models
    subspaces = subspaces


def _pair(model, space):
    """The same operator and subspace in both packages (projection allowed:
    ising's X field leaves the Parity sectors, Z fields the XParity
    ones)."""
    out = []
    for pkg in (ref_pkg, port_pkg):
        H = _operator(pkg, model)
        H.allow_projection = True
        n = 8 if model == 'folded_localized' else L
        if space in ('full', 'even', 'odd'):
            sub = (pkg.subspaces.Full(L=n) if space == 'full'
                   else pkg.subspaces.Parity(space, L=n))
        else:
            sub = pkg.subspaces.XParity(pkg.subspaces.Full(L=n),
                                        '+' if space == 'xparity_plus'
                                        else '-')
        H.add_subspace(sub)
        out += [H, sub]
    return out


def _planes(dim, dtype, seed=0):
    x = np.random.RandomState(seed).standard_normal((2, dim)).astype(dtype)
    return x / np.linalg.norm(x)


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(
        np.max(np.abs(want)), 1e-30)


def _factors(plan, g, k, ctype):
    """Group g's factor f_g(k) at the global rows k, as the kernel builds
    it from its tables: the slot coefficients of each row's tile, summed per
    sign class with the sign of the thread's row offset, then the
    Walsh-Hadamard butterfly over the R rows of the thread."""
    R = plan.rows_per_thread
    lo = (1 << plan.tile_bits) - 1
    k_hi = k & ~lo
    q = k & lo & ~(R - 1)       # the thread's first row in its tile
    r = k & (R - 1)             # the row inside the thread
    f = np.zeros(len(k), ctype)
    for p in range(R):
        F = np.zeros(len(k), ctype)
        for s in range(plan.class_start[g * R + p],
                       plan.class_start[g * R + p + 1]):
            assert plan.slot_slo[s] & (R - 1) == p
            C = np.zeros(len(k), ctype)
            for i in range(plan.slot_term_start[s],
                           plan.slot_term_start[s + 1]):
                c = ctype(plan.term_cr[i] + 1j * plan.term_ci[i])
                C += c * (1 - 2 * parity(k_hi & plan.term_shi[i]))
            F += C * (1 - 2 * parity(q & plan.slot_slo[s]))
        f += F * (1 - 2 * parity(r & p))
    return f


def _slot_coefficients(plan, g, k_hi):
    """Group g's slot coefficients in the tile whose rows have the global
    high bits k_hi, as the kernel's ``stage`` builds them in float64."""
    R = plan.rows_per_thread
    out = []
    for s in range(plan.class_start[g * R], plan.class_start[(g + 1) * R]):
        terms = slice(plan.slot_term_start[s], plan.slot_term_start[s + 1])
        w = 1 - 2 * parity(k_hi & plan.term_shi[terms])
        out.append(np.sum((plan.term_cr[terms] + 1j * plan.term_ci[terms])
                          * w))
    return np.asarray(out)


def fwht_diagonal(layout, row0, tile_bits, dtype):
    """Rows [row0, row0 + local_dim) of the diagonal stream as the diagonal
    kernel computes them, in ``dtype``, as complex values: for each aligned
    tile of 2**tile_bits rows that holds rows of the block, g[u] summed
    over the terms of the slot of u in their order, each signed by the
    tile's high bits (0 where no slot has u); then the butterfly over each
    bit of the row offset (the lower row of a pair takes a + b, the upper
    a - b); then the block's rows of those tiles."""
    plan = layout.tables.diag_plan(tile_bits)
    tile = 1 << tile_bits
    n = layout.local_dim
    k_hi = np.arange(row0 & ~(tile - 1), row0 + n, tile, dtype=np.int64)
    planes = 2 if layout.tables.has_imag_diag else 1
    g = np.zeros((planes, len(k_hi), tile), dtype)
    s_lo = np.repeat(plan.slot_slo, np.diff(plan.slot_term_start))
    for i, u in enumerate(s_lo):  # each slot's terms in their order
        w = (1 - 2 * parity(k_hi & plan.term_shi[i])).astype(dtype)
        g[0, :, u] += w * dtype(plan.term_cr[i])
        if planes == 2:
            g[1, :, u] += w * dtype(plan.term_ci[i])
    h = 1
    while h < tile:
        pairs = g.reshape(planes, len(k_hi), -1, 2, h)
        a, b = pairs[:, :, :, 0], pairs[:, :, :, 1]
        g = np.stack([a + b, a - b], axis=3).reshape(g.shape)
        h *= 2
    rows = g.reshape(planes, -1)[:, row0 - k_hi[0]:row0 - k_hi[0] + n]
    return rows[0] + (1j * rows[1] if planes == 2 else 0)


def tile_apply(srcs, layout, row0, tile_bits, R):
    """Rows [row0, row0 + local_dim) of y = H x from the kernel's tables
    (see the module docstring); srcs as for xor_apply_sharded."""
    t = layout.tables
    dtype = srcs[0].dtype.type
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    plan = t.tiles(tile_bits, R)
    n = layout.local_dim
    j = np.arange(n, dtype=np.int64)
    k = row0 + j
    xs = [(s[0] + 1j * s[1]).astype(ctype) for s in srcs]
    y = np.zeros(n, ctype)
    if t.use_diag:
        y += fwht_diagonal(layout, row0, tile_bits, dtype) \
            * xs[layout.diag_src]
    for g, full_g in enumerate(t.kernel_groups):
        f = _factors(plan, g, k, ctype)
        y += f * xs[layout.src_idx[full_g]][j ^ layout.m_lo[full_g]]
    return np.stack([y.real, y.imag])


def _shards(x, tables, P):
    """(layout, [(srcs, row0)]) of P virtual shards of one vector."""
    st = tables.for_layout(tables.nbits - (P.bit_length() - 1))
    n = st.local_dim
    return st, [([x[:, (me ^ h) * n:((me ^ h) + 1) * n] for h in st.hi_list],
                 me * n) for me in range(P)]


@pytest.mark.parametrize('space', SPACES)
@pytest.mark.parametrize('model', MODELS)
def test_tile_tables_vs_reference(model, space):
    H_ref, sub_ref, H, sub = _pair(model, space)
    tables = H.get_mat().tables
    dim = tables.dim

    # the JAX package's Pallas kernel, interpret mode, float32
    fn = build_pallas_apply(H_ref.get_mat().plan, sub_ref, sub_ref,
                            interpret=True)
    assert fn is not None
    x32 = _planes(dim, np.float32)
    want32 = np.asarray(fn(jnp.asarray(x32)))
    x64 = _planes(dim, np.float64, seed=1)
    wants = {np.float32: want32,
             np.float64: xor_apply_reference(torch.from_numpy(x64),
                                             tables).numpy()}

    for x in (x32, x64):
        dtype = x.dtype.type
        for P in (1, 2, 4, 8):
            st, shards = _shards(x, tables, P)
            shapes = SMALL_TILES + [tile_shape(st.local_bits, x.itemsize)]
            for tile_bits, R in shapes:
                parts = []
                for srcs, row0 in shards:
                    y = tile_apply(srcs, st, row0, tile_bits, R)
                    plain = xor_apply_sharded_reference(
                        [torch.from_numpy(s) for s in srcs], st, row0)
                    assert _rel(y, plain.numpy()) < TOL[dtype]
                    parts.append(y)
                assert _rel(np.concatenate(parts, axis=1),
                            wants[dtype]) < TOL[dtype]

    # the tables exercise sign masks above the split, and the flags stand
    # exactly where a coefficient is complex and where a sign mask has bits
    # below R
    plan = tables.tiles(4, 4)
    shi = [plan.term_shi]
    if tables.use_diag:
        shi.append(tables.diag_plan(4).term_shi)
    assert np.concatenate(shi).any()
    for i, g in enumerate(tables.kernel_groups):
        terms = slice(tables.group_start[g], tables.group_start[g + 1])
        assert bool(plan.group_flags[i] & COMPLEX) == \
            bool(tables.term_ci[terms].any())
        assert bool(plan.group_flags[i] & MIXED) == \
            bool((tables.term_s[terms] & 3).any())


@pytest.mark.parametrize('space', ['full', 'even'])
@pytest.mark.parametrize('model', ['localized', 'heisenberg', 'long_range'])
def test_idle_tiles(model, space):
    """A tile skips a group whose slot coefficients are all exactly 0
    there. Where it skips, the group's factor is 0 on every row of the
    tile; XX + YY on two sites above the tile cancel in exactly half the
    tiles; long_range's X + Y field groups (a real and an imaginary term)
    never cancel."""
    _, _, H, _ = _pair(model, space)
    tables = H.get_mat().tables
    tile_bits, R = 4, 4
    plan = tables.tiles(tile_bits, R)
    n_tiles = tables.dim >> tile_bits
    k = np.arange(tables.dim, dtype=np.int64)
    above = 0
    for g, full_g in enumerate(tables.kernel_groups):
        idle = np.array([not _slot_coefficients(plan, g, t << tile_bits).any()
                         for t in range(n_tiles)])
        f = _factors(plan, g, k, np.complex128).reshape(n_tiles, -1)
        assert not f[idle].any()
        assert f[~idle].any(axis=1).all()
        assert not (model == 'long_range' and idle.any())
        m = int(tables.group_mask[full_g])
        if (model != 'long_range' and m >> tile_bits
                and not m & ((1 << tile_bits) - 1)):
            assert idle.sum() == n_tiles // 2
            above += 1
    assert model == 'long_range' or above >= 3


@pytest.mark.parametrize('space', SPACES)
@pytest.mark.parametrize('model', MODELS)
def test_diagonal_vs_reference(model, space):
    H_ref, sub_ref, H, sub = _pair(model, space)
    tables = H.get_mat().tables
    plan = PallasXorPlan(H_ref.get_mat().plan, sub_ref, sub_ref)

    # the same decision and the same terms as the JAX kernel's plan
    assert tables.use_diag == plan.use_diag
    assert tables.has_imag_diag == plan.has_imag_diag
    want_terms = sorted((s, cr, ci) for cr, ci, s in plan.diag_terms)
    got_terms = sorted((int(s), c.real, c.imag)
                       for s, c in zip(tables.diag_s, tables.diag_c))
    assert got_terms == want_terms
    n_kernel = len(tables.kernel_groups)
    assert n_kernel == tables.n_groups - (1 if tables.use_diag else 0)
    if model == 'random_few_diag':
        assert not tables.use_diag and 0 in tables.group_mask
    if not tables.use_diag:
        with pytest.raises(ValueError):
            xor_diagonal(tables.for_layout(tables.nbits), 0, torch.float64,
                         'cpu')
        return

    want = np.asarray(compute_diagonal(plan.diag_terms, tables.dim,
                                       np.int32, plan.has_imag_diag))
    _check_fwht_diagonal(tables, want)


def _planes_of(d, planes):
    return np.stack([d.real, d.imag])[:planes]


def _check_fwht_diagonal(tables, want):
    """The diagonal on P = 1, 2, 4, 8 shards: the plain version (float64)
    against the JAX package's float32 ``want``, and the kernel's algorithm
    (:func:`fwht_diagonal`) at each of DIAG_TILES against the plain
    version, in float64 and in float32."""
    for P in (1, 2, 4, 8):
        st = tables.for_layout(tables.nbits - (P.bit_length() - 1))
        n = st.local_dim
        for me in range(P):
            rows = want[:, me * n:(me + 1) * n]
            d64 = xor_diagonal(st, me * n, torch.float64, 'cpu').numpy()
            assert d64.shape == rows.shape
            assert _rel(d64, rows) < TOL[np.float32]  # JAX builds in float32
            for tile_bits in DIAG_TILES:
                for dtype in (np.float64, np.float32):
                    d = fwht_diagonal(st, me * n, tile_bits, dtype)
                    assert _rel(_planes_of(d, len(rows)), d64) < TOL[dtype]


def _diag_case(model, space):
    """(the port's XorTables, the JAX package's diagonal terms (cr, ci,
    s)) of a diagonal case, their terms held equal. A Hermitian operator's
    diagonal terms are real, so random_complex_diag is localized's
    diagonal with random complex coefficients put into both packages'
    terms (the tables' ``diag_c`` and ``has_imag_diag``): the two-plane
    stream of the kernel and of ``compute_diagonal``."""
    base = 'localized' if model == 'random_complex_diag' else model
    H_ref, sub_ref, H, _ = _pair(base, space)
    tables = H.get_mat().tables
    plan = PallasXorPlan(H_ref.get_mat().plan, sub_ref, sub_ref)
    assert tables.use_diag and plan.use_diag and not plan.has_imag_diag
    want_terms = sorted((s, cr, ci) for cr, ci, s in plan.diag_terms)
    got_terms = sorted((int(s), c.real, c.imag)
                       for s, c in zip(tables.diag_s, tables.diag_c))
    assert got_terms == want_terms
    if model == 'random_complex_diag':
        rng = np.random.RandomState(8)
        tables.diag_c = rng.uniform(-1, 1, (len(tables.diag_s), 2)) @ [1, 1j]
        tables.has_imag_diag = True
    return tables, [(c.real, c.imag, int(s))
                    for s, c in zip(tables.diag_s, tables.diag_c)]


@pytest.mark.parametrize('space', DIAG_SPACES)
@pytest.mark.parametrize('model', DIAG_MODELS)
def test_fwht_diagonal_vs_reference(model, space):
    """The diagonal kernel's algorithm on the diagonal's cases, Full,
    Parity and XParity: the diagonal's terms as the JAX package's plan
    takes them, and the stream against its ``compute_diagonal`` through
    :func:`_check_fwht_diagonal`."""
    tables, terms = _diag_case(model, space)
    if model == 'four_diag':
        assert len(tables.diag_s) == DIAG_PRECOMPUTE_MIN_TERMS
    want = np.asarray(compute_diagonal(terms, tables.dim, np.int32,
                                       tables.has_imag_diag))
    assert want.shape[0] == (2 if model == 'random_complex_diag' else 1)
    _check_fwht_diagonal(tables, want)


@pytest.mark.parametrize('tile_bits', [DIAG_TILE_BITS, 4, 0])
@pytest.mark.parametrize('model', ['long_range', 'folded_localized',
                                   'random_complex_diag'])
def test_diagonal_plan_tables(model, tile_bits):
    """The diagonal kernel's tables: the terms in CSR by s_lo, one slot per
    distinct s_lo in ascending order, each slot's terms in their order in
    the diagonal, every term once, its sign mask split at tile_bits and its
    coefficient kept."""
    t, _ = _diag_case(model, 'full')
    plan = t.diag_plan(tile_bits)
    assert t.diag_plan(tile_bits) is plan
    assert isinstance(plan, DiagonalPlan) and plan.tile_bits == tile_bits
    lo = (1 << tile_bits) - 1
    start, slo = plan.slot_term_start, plan.slot_slo
    assert start.dtype == slo.dtype == np.int32
    assert list(slo) == sorted(set(int(s) & lo for s in t.diag_s))
    assert plan.n_slots == len(slo) and len(start) == len(slo) + 1
    assert start[0] == 0 and start[-1] == len(t.diag_s)
    assert np.all(np.diff(start) > 0)
    order = []
    for j, u in enumerate(slo):
        mine = np.flatnonzero((t.diag_s & lo) == u)  # in the diagonal's order
        got = slice(start[j], start[j + 1])
        assert np.array_equal(plan.term_shi[got], t.diag_s[mine] & ~lo)
        assert np.array_equal(plan.term_cr[got] + 1j * plan.term_ci[got],
                              t.diag_c[mine])
        order.extend(mine)
    assert sorted(order) == list(range(len(t.diag_s)))


def test_cpu_diagonal_counts_no_launch():
    H = models.long_range(L)
    H.add_subspace(subspaces.Full(L=L))
    tables = H.get_mat().tables
    assert tables.use_diag and tables.has_imag_diag is False
    before = tracing.counter('xor.diagonal_launches')
    d = xor_diagonal(tables.for_layout(tables.nbits), 0, torch.float64, 'cpu')
    assert tracing.counter('xor.diagonal_launches') == before
    assert d.shape == (1, tables.dim)
    x = torch.from_numpy(_planes(tables.dim, np.float64))
    before = tracing.counter('xor.launches')
    port_xor.xor_apply(x, tables)
    assert tracing.counter('xor.launches') == before


@pytest.mark.parametrize('local_bits,itemsize,want', [
    (24, 4, (11, 4)), (24, 8, (10, 2)), (7, 4, (7, 4)), (1, 4, (1, 2)),
    (0, 8, (0, 1))])
def test_tile_shape(local_bits, itemsize, want):
    assert tile_shape(local_bits, itemsize) == want


@pytest.mark.parametrize('model,diag_planes', [
    ('localized', 1), ('long_range', 1), ('random_few_diag', 0)])
def test_block_args(model, diag_planes):
    """The kernel's arguments of one block, built at its first launch and
    kept on the layout: they mirror the block's tile plan, and the
    ctypes struct has the CUDA struct's size (512 bytes of source pointers,
    then 64 of scalars and 72 of table pointers)."""
    _, _, H, _ = _pair(model, 'full')
    tables = H.get_mat().tables
    st = tables.for_layout(7)
    n = st.local_dim
    cpu = torch.device('cpu')
    a = port_xor._block_args(st, n, torch.float32, cpu)
    assert port_xor._block_args(st, n, torch.float32, cpu) is a
    tile_bits, R = tile_shape(st.local_bits, 4)
    plan = tables.tiles(tile_bits, R)
    assert (a.tile_bits, a.rows_per_thread) == (tile_bits, R)
    assert (a.local_dim, a.row0) == (n, n)
    assert (a.n_groups, a.n_slots) == (plan.n_groups, plan.n_slots)
    assert a.diag_planes == diag_planes
    assert a.diag_src == (st.diag_src if diag_planes else 0)
    assert bool(a.diag) == bool(diag_planes)
    assert a.n_srcs == 0 and not a.y
    assert ctypes.sizeof(port_xor._XorArgs) == 648


@pytest.mark.parametrize('model', ['localized', 'random_complex_diag'])
def test_diagonal_args(model):
    """The diagonal kernel's arguments for one block: the tile, the block,
    its planes and the tables of ``diag_plan`` on the output's device (the
    matvec's fields left 0), and a row offset off a block start refused."""
    tables, _ = _diag_case(model, 'full')
    st = tables.for_layout(7)
    n = st.local_dim
    planes = 2 if model == 'random_complex_diag' else 1
    d = torch.empty((planes, n), dtype=torch.float32)
    a = port_xor._diagonal_args(st, 3 * n, d)
    on = tables.diag_plan().on(d.device, d.dtype)
    assert (a.tile_bits, a.n_slots) == (DIAG_TILE_BITS,
                                        tables.diag_plan().n_slots)
    assert (a.local_dim, a.row0, a.diag_planes) == (n, 3 * n, planes)
    assert a.y == d.data_ptr()
    assert on['term_cr'].dtype == torch.float32
    for name in ('slot_slo', 'slot_term_start', 'term_shi', 'term_cr',
                 'term_ci'):
        assert getattr(a, name) == on[name].data_ptr()
    assert not (a.n_groups or a.n_srcs or a.diag or a.class_start)
    with pytest.raises(ValueError):
        port_xor._diagonal_args(st, n + 1, d)
