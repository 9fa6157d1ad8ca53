"""
The port's sector-major layout (ops/sectors.py), its torch index map, the
sector engine's host build (SectorPlan) and its apply and plain version
(ops/sector_apply.py), against the JAX package, on the CPU.

The same numpy inputs go through both packages. Layouts, maps and sector
plans are host numpy in both and compare exactly; applies compare as
max|dy| / max|y| within 1e-12 (float64) and 1e-5 (float32), against the JAX
package's local engine (``traceable(sharded=False)``) and the numpy oracle
``to_numpy() @ v``. The XParity-wrapped Full and Parity spaces take the XOR
path, through the plain version of the CUDA kernel.
"""

import copy
from math import comb

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.ops import sectors as ref_sectors
from dynamite_tpu.ops.apply import _Plan as RefPlan
from dynamite_tpu.ops.sector_apply import SectorPlan as RefSectorPlan

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.ops import sectors
from dynamite_tpu_torch.ops.apply import _Plan
from dynamite_tpu_torch.ops.index_maps import device_map, popcount
from dynamite_tpu_torch.ops.sector_apply import (SectorPlan, sector_apply,
                                                 sector_apply_reference)
from dynamite_tpu_torch.ops.xor_apply import xor_apply_reference
from dynamite_tpu_torch.utils.bitwise import popcount as popcount_np

# One torch thread per xdist worker. torch on every core in several workers
# overloads the machine, and the JAX package's CPU collectives then miss
# XLA's rendezvous timeout and abort the worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

LAYOUTS = [(1, 0), (2, 1), (5, 2), (10, 3), (12, 6), (14, 7)]


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


@pytest.fixture
def single_precision(monkeypatch):
    """The port in float32 for one test (the reference's precision is
    fixed for the whole process)."""
    config._initialize()
    monkeypatch.setattr(config, '_precision', 'single')


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(
        np.max(np.abs(want)), 1e-30)


# -- layout and index maps ---------------------------------------------------

@pytest.mark.parametrize('L,k', LAYOUTS)
def test_layout_and_maps_equal_reference(L, k):
    """The layout's arrays and both host maps equal the JAX package's
    exactly; (14, 7) has dim 3432 > 1024, where the JAX package's
    SpinConserve takes its native C++ maps."""
    lay, ref = sectors.layout(L, k), ref_sectors.layout(L, k)
    for name in ('t', 'kr', 'ka', 'nb', 'na', 'off', 'off_tk', 'na_tk',
                 'sec_tk'):
        assert np.array_equal(getattr(lay, name), getattr(ref, name)), name
    assert (lay.La, lay.Lr, lay.dim) == (ref.La, ref.Lr, ref.dim)

    sub = subspaces.SpinConserve(L, k)
    sub_ref = ref_subspaces.SpinConserve(L, k)
    dim = sub.get_dimension()
    assert dim == sub_ref.get_dimension() == comb(L, k)
    idx = np.arange(dim)
    st = sub.idx_to_state(idx)
    assert np.array_equal(st, sub_ref.idx_to_state(idx))
    every = np.arange(1 << L)
    assert np.array_equal(sub.state_to_idx(every),
                          sub_ref.state_to_idx(every))
    assert sub.get_checksum() == sub_ref.get_checksum()

    # the torch map agrees with the host map, valid flag included
    dmap = device_map(sub)
    assert np.array_equal(dmap.i2s(torch.from_numpy(idx)).numpy(), st)
    got, valid = dmap.s2i(torch.from_numpy(every))
    assert np.array_equal(np.where(valid.numpy(), got.numpy(), -1),
                          sub.state_to_idx(every))


@pytest.mark.parametrize('L,k', [(1, 0), (1, 1), (4, 2), (7, 4), (12, 6)])
def test_layout_roundtrip(L, k):
    lay = sectors.layout(L, k)
    idx = np.arange(lay.dim)
    st = sectors.idx_to_state(lay, idx)
    assert np.all(popcount_np(st) == k)
    assert len(np.unique(st)) == lay.dim
    assert np.array_equal(sectors.state_to_idx(lay, st), idx)


@pytest.mark.parametrize('L', [4, 6, 8])
def test_layout_half_filling_invariants(L):
    """k = L/2: top-bit-0 states occupy exactly the first half (the XParity
    representative convention) and complementation is index reversal."""
    lay = sectors.layout(L, L // 2)
    st = sectors.idx_to_state(lay, np.arange(lay.dim))
    assert np.all(st[:lay.dim // 2] >> (L - 1) == 0)
    assert np.array_equal(sectors.state_to_idx(lay, ((1 << L) - 1) ^ st),
                          np.arange(lay.dim)[::-1])


def test_layout_sectors_contiguous():
    lay = sectors.layout(9, 4)
    sizes = lay.nb * lay.na
    assert np.array_equal(lay.off, np.concatenate([[0],
                                                   np.cumsum(sizes)[:-1]]))
    st = sectors.idx_to_state(lay, np.arange(lay.dim))
    t, hr, sa = lay.split_state(st)
    for s in range(lay.n_sectors):
        sl = slice(int(lay.off[s]), int(lay.off[s] + sizes[s]))
        assert np.all(t[sl] == lay.t[s])
        assert np.all(popcount_np(hr[sl]) == lay.kr[s])
        assert np.all(popcount_np(sa[sl]) == lay.ka[s])


def test_torch_popcount():
    x = np.random.RandomState(0).randint(0, 1 << 62, 1000, dtype=np.int64)
    assert np.array_equal(popcount(torch.from_numpy(x)).numpy(),
                          popcount_np(x))


# -- SectorPlan ----------------------------------------------------------------

def _subs(name):
    """The same subspace in both packages."""
    def make(pkg):
        if name == 'sc10':
            return pkg.SpinConserve(10, 5)
        if name == 'sc11':
            return pkg.SpinConserve(11, 4)
        return pkg.XParity(pkg.SpinConserve(10, 5), '+')
    return make(subspaces), make(ref_subspaces)


def _plans(model, name):
    """(port _Plan, JAX _Plan, port sub, JAX sub) of one model, its MSC
    rewritten through XParity where the subspace is one."""
    sub, sub_ref = _subs(name)
    H = getattr(models, model)(sub.L)
    H_ref = getattr(ref_models, model)(sub.L)
    H.reduce_msc()
    H_ref.reduce_msc()
    msc, msc_ref = H.msc, H_ref.msc
    if not sub.product_state_basis:
        msc, msc_ref = sub.reduce_msc(msc), sub_ref.reduce_msc(msc_ref)
    assert np.array_equal(msc, msc_ref)
    return _Plan(msc, sub, sub), RefPlan(msc_ref, sub_ref, sub_ref), sub, \
        sub_ref


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('name', ['sc10', 'sc11', 'xparity10'])
@pytest.mark.parametrize('model', ['heisenberg', 'localized', 'long_range',
                                   'ising'])
def test_sector_plan_equals_reference(model, name, dtype):
    """Channel by channel: the same sectors, gathers, row scales and
    matrices, the same conservation flag, channel count and table bytes;
    the diagonal field (computed on the device in both) within rounding."""
    ref_config._initialize()  # the JAX package's x64 mode, for float64
    plan, plan_ref, sub, sub_ref = _plans(model, name)
    sp = SectorPlan(plan, sub, sub, dtype)
    ref = RefSectorPlan(plan_ref, sub_ref, sub_ref, dtype)
    assert sp.secs == ref.secs
    assert sp.conserved == ref.conserved
    # ising's X field and long_range's X + Y fields leave the sector
    assert sp.conserved is (model in ('heisenberg', 'localized'))
    # ising keeps only its diagonal ZZ terms inside the sector
    assert sp.n_channels == ref.n_channels
    assert (sp.n_channels > 0) is (model != 'ising')
    assert sp.table_bytes == ref.table_bytes
    for got, want in ((sp.col_channels, ref.col_channels),
                      (sp.row_channels, ref.row_channels)):
        assert len(got) == len(want)
        for ch, ch_ref in zip(got, want):
            assert ch[:2] == ch_ref[:2]
            for a, b in zip(ch[2:], ch_ref[2:]):
                assert _same(a, b)
    assert (sp.diag is None) == (ref.diag is None)
    if sp.diag is not None:
        for d, d_ref in zip(sp.diag, ref.diag):
            assert (d is None) == (d_ref is None)
            if d is not None:
                tol = 1e-5 if dtype == np.float32 else 1e-12
                assert _rel(d.numpy(), d_ref) <= tol


def test_sector_plan_channel_merge():
    """The XX and YY halves of every boundary hop share their row gather
    and (up to sign) their row scale, so they merge into one channel per
    (input sector, output sector)."""
    sub = subspaces.SpinConserve(10, 5)
    H = models.heisenberg(10)
    H.reduce_msc()
    sp = SectorPlan(_Plan(H.msc, sub, sub), sub, sub, np.float32)
    assert sp.conserved is True
    cross = [(c[0], c[1]) for c in sp.col_channels if c[2] is not None]
    assert len(cross) == len(set(cross))


# -- applies -------------------------------------------------------------------

def _pair(model, make):
    """The same operator on the same subspace in both packages (projection
    allowed, so non-conserving models build)."""
    sub, sub_ref = make(subspaces), make(ref_subspaces)
    H = getattr(models, model)(sub.L)
    H_ref = getattr(ref_models, model)(sub.L)
    for op, s in ((H, sub), (H_ref, sub_ref)):
        op.allow_projection = True
        op.add_subspace(s)
    return H, sub, H_ref, sub_ref


def _planes(dim, dtype=np.float64, seed=0):
    x = np.random.RandomState(seed).standard_normal((2, dim)).astype(dtype)
    return x / np.linalg.norm(x)


# L in {8, 11, 12}, k = 0 and k = L among them, each model at half filling
SC_CASES = [('heisenberg', 8, 0), ('heisenberg', 8, 3), ('localized', 8, 8),
            ('heisenberg', 11, 11), ('long_range', 11, 5),
            ('heisenberg', 12, 6), ('localized', 12, 6),
            ('long_range', 12, 6)]


def _check_apply(model, make, dtype=np.float64, tol=1e-12):
    H, sub, H_ref, sub_ref = _pair(model, make)
    kernel = H.get_mat()
    dim = sub.get_dimension()
    x = _planes(dim, dtype, seed=dim)
    want = np.asarray(jax.jit(H_ref.get_mat().traceable(sharded=False))(
        jnp.asarray(x.astype(np.float64))))
    oracle = H.to_numpy() @ (x[0] + 1j * x[1]).astype(np.complex128)
    y = kernel.apply(torch.from_numpy(x)).numpy()
    y_plain = sector_apply_reference(torch.from_numpy(x), kernel.plan).numpy()
    for got in (y, y_plain):
        assert got.dtype == dtype
        assert _rel(got, want) <= tol
        assert _rel(got[0] + 1j * got[1], oracle) <= tol
    return kernel


@pytest.mark.parametrize('model,L,k', SC_CASES)
def test_sector_apply_vs_reference(model, L, k):
    kernel = _check_apply(model, lambda pkg: pkg.SpinConserve(L, k))
    assert kernel.sector_plan is not None and kernel.tables is None


@pytest.mark.parametrize('model,sector', [('localized', '+'),
                                          ('localized', '-'),
                                          ('long_range', '+'),
                                          ('heisenberg', '-')])
def test_sector_apply_xparity_vs_reference(model, sector):
    kernel = _check_apply(model, lambda pkg: pkg.XParity(
        pkg.SpinConserve(12, 6), sector))
    assert kernel.sector_plan.xparity


def test_sector_apply_ising_projection():
    """ising leaves the sector: with projection allowed the engine keeps
    the in-sector part, as the JAX package's does."""
    kernel = _check_apply('ising', lambda pkg: pkg.SpinConserve(10, 4))
    assert kernel.conserves_hint is False


@pytest.mark.parametrize('model', ['heisenberg', 'long_range'])
def test_sector_apply_single_precision(single_precision, model):
    kernel = _check_apply(model, lambda pkg: pkg.SpinConserve(12, 6),
                          dtype=np.float32, tol=1e-5)
    assert kernel.sector_plan.real_dtype == np.float32


def test_sector_apply_casts_tables_per_dtype():
    """A float32 input on a float64 plan runs on float32 copies of the
    tables, within float32 rounding of the float64 result."""
    H, sub, _H_ref, _sub_ref = _pair('localized',
                                     lambda pkg: pkg.SpinConserve(10, 5))
    kernel = H.get_mat()
    x = _planes(sub.get_dimension())
    y64 = kernel.apply(torch.from_numpy(x)).numpy()
    y32 = kernel.apply(torch.from_numpy(x.astype(np.float32))).numpy()
    assert y32.dtype == np.float32
    assert _rel(y32, y64) <= 1e-5


def test_sector_apply_on_cpu_returns_new_tensors():
    """On CPU tensors the engine runs its channel loop and captures no CUDA
    graph: each call returns a tensor of its own (the second apply leaves
    the first's result as it was), equal to the plain version."""
    H, sub, _H_ref, _sub_ref = _pair('long_range',
                                     lambda pkg: pkg.SpinConserve(12, 6))
    kernel = H.get_mat()
    xs = [torch.from_numpy(_planes(sub.get_dimension(), seed=s))
          for s in (1, 2)]
    counts = (tracing.counter('sector.graph_captures'),
              tracing.counter('sector.graph_replays'))
    y1 = sector_apply(xs[0], kernel.sector_tables)
    kept = y1.clone()
    y2 = sector_apply(xs[1], kernel.sector_tables)
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, kept)
    for x, y in zip(xs, (y1, y2)):
        assert _rel(y.numpy(),
                    sector_apply_reference(x, kernel.plan).numpy()) <= 1e-12
    assert (tracing.counter('sector.graph_captures'),
            tracing.counter('sector.graph_replays')) == counts
    assert kernel.sector_tables.graphs == {}


def test_sector_tables_copy_has_no_graphs():
    """A shallow copy of a table set starts with no CUDA graph of its own,
    so a copy whose channels are changed never replays the original's
    graph; everything else it shares."""
    H, _sub, _H_ref, _sub_ref = _pair('heisenberg',
                                      lambda pkg: pkg.SpinConserve(12, 6))
    tables = H.get_mat().sector_tables
    rest = copy.copy(tables)
    assert rest.graphs == {}
    assert rest.graphs is not tables.graphs
    assert rest.col_channels is tables.col_channels
    assert rest.blocks is tables.blocks and rest.plan is tables.plan


# -- XParity over the XOR path -------------------------------------------------

@pytest.mark.parametrize('model,parent,sector', [
    ('mbl', 'full', '+'), ('mbl', 'full', '-'), ('mbl', 'even', '+'),
    ('mbl', 'even', '-'), ('long_range', 'full', '-'),
    ('long_range', 'even', '+'), ('heisenberg', 'full', '+')])
def test_xparity_xor_vs_reference(model, parent, sector):
    """XParity(Full(10)) and XParity(Parity('even', L=10)): the rewritten
    masks fold onto m ^ (2**L - 1), reaching nearly every bit; the plain
    version of the kernel against the JAX package's apply and the oracle."""
    def make(pkg):
        base = pkg.Full(L=10) if parent == 'full' else pkg.Parity('even',
                                                                  L=10)
        return pkg.XParity(base, sector)
    H, sub, H_ref, _sub_ref = _pair(model, make)
    kernel = H.get_mat()
    tables = kernel.tables
    assert tables is not None and tables.dim == sub.get_dimension()
    assert tables.nbits == (9 if parent == 'full' else 8)
    x = _planes(tables.dim, seed=4)
    want = np.asarray(jax.jit(H_ref.get_mat().traceable(sharded=False))(
        jnp.asarray(x)))
    got = xor_apply_reference(torch.from_numpy(x), tables).numpy()
    assert _rel(got, want) <= 1e-12
    assert _rel(got[0] + 1j * got[1],
                H.to_numpy() @ (x[0] + 1j * x[1])) <= 1e-12
