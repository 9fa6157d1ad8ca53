"""
The packed ELL tables (SELL-32, ``ops/ell.py::pack_tables``) on the CPU:
their layout against the (G, rows) tables they come from, and the engine's
build in blocks (``build_packed``) against packing the whole tables, over
every pair of ``tests/test_torch_general.py::CASES`` (the rectangular one
holds the fi table) in float64 and float32; their plain version
(``sell_apply_reference``, what ``ell_apply`` runs on a CPU tensor)
against the (G, rows) plain version (``ell_apply_reference``) on small
synthetic tables: rows not a multiple of 32, a slice whose rows are
all empty, a group whose coefficient cancels to exactly 0 inside the
subspace, one group, int64 columns, no entry at all.

Layout: every count and every stored entry exactly. Applies: 1e-12
relative in float64 and 1e-5 in float32 (the versions sum in different
orders).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from dynamite_tpu import config as ref_config
from dynamite_tpu_torch import config
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.operators import (index_sum, sigma_minus,
                                          sigma_plus, sigmax, sigmay)
from dynamite_tpu_torch.ops import ell
from dynamite_tpu_torch.ops.apply import _Plan

from tests.test_torch_general import CASES, _plans, _rel

# one torch thread per xdist worker (ROADMAP.md queue 3)
torch.set_num_threads(1)

DTYPES = [(torch.float64, 1e-12), (torch.float32, 1e-5)]


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


def _check_layout(t, cols, fr, fi):
    """The packed tables ``t`` hold exactly the nonzero entries of the
    (G, rows) tables, each row's in ascending group order, slice s in
    lanes_s * width_s places (lanes_s its rows: 32 but in the last slice),
    width_s its widest row; every other place is column 0 and coefficient
    0."""
    cols, fr = cols.numpy(), fr.numpy()
    fi = None if fi is None else fi.numpy()
    G, rows = cols.shape
    keep = fr != 0 if fi is None else (fr != 0) | (fi != 0)
    n_slices = -(-rows // ell.SLICE)
    counts = np.zeros(n_slices * ell.SLICE, dtype=np.int64)
    counts[:rows] = keep.sum(0)
    width = counts.reshape(-1, ell.SLICE).max(1)
    lanes = np.minimum(ell.SLICE, rows - ell.SLICE * np.arange(n_slices))
    ptr = t.slice_ptr.numpy()
    assert t.slice_ptr.dtype == torch.int64
    assert t.rows == rows and t.n_slices == n_slices
    assert t.nnz == int(keep.sum())
    assert ptr[0] == 0 and np.array_equal(np.diff(ptr), lanes * width)
    assert t.stored == ptr[-1] == len(t.cols) == len(t.fr)
    assert t.cols.dtype == torch.from_numpy(cols).dtype
    assert t.fr.dtype == torch.from_numpy(fr).dtype
    assert (t.fi is None) is (fi is None)
    stored = [t.cols.numpy(), t.fr.numpy()] + (
        [] if fi is None else [t.fi.numpy()])
    tables = [cols, fr] + ([] if fi is None else [fi])
    for r in range(rows):
        s, lane = divmod(r, ell.SLICE)
        places = ptr[s] + lanes[s] * np.arange(width[s]) + lane
        groups = np.nonzero(keep[:, r])[0]
        n = len(groups)
        for packed, table in zip(stored, tables):
            assert np.array_equal(packed[places[:n]], table[groups, r])
            assert not packed[places[n:]].any()


def _applies_agree(t, cols, fr, fi, seed, tol):
    """The packed plain version against the (G, rows) one; returns y."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.standard_normal((2, t.dim_right)),
                        dtype=fr.dtype)
    y = ell.sell_apply_reference(x, t)
    want = ell.ell_apply_reference(x, cols, fr, fi)
    assert y.shape == (2, t.rows) and y.dtype == x.dtype
    assert _rel(y.numpy(), want.numpy()) <= tol
    # ell_apply on a CPU tensor runs the packed plain version
    assert torch.equal(ell.ell_apply(x, t), y)
    return y


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_pack_layout(name, dtype, tol):
    plan = _plans(name)[0]
    cols, fr, fi = ell.build_tables(plan, dtype, 'cpu')
    t = ell.pack_tables(cols, fr, fi, plan.dim_right)
    _check_layout(t, cols, fr, fi)
    assert t.dim_right == plan.dim_right
    assert t.nbytes <= ell.packed_bound(plan, dtype)


def _packed_equal(t, want):
    for got, ref in zip(t, want):
        if isinstance(ref, torch.Tensor):
            assert got.dtype == ref.dtype and torch.equal(got, ref)
        else:
            assert got == ref


def _build_in_blocks(plan, dtype, monkeypatch):
    """build_packed in blocks of 32 rows against pack_tables over the
    whole (G, rows) tables, with the conservation flag."""
    *tables, conserved = ell.build_tables(plan, dtype, 'cpu',
                                          with_conserves=True)
    want = ell.pack_tables(*tables, plan.dim_right)
    monkeypatch.setattr(ell, 'BUILD_CHUNK_BITS', 5)
    t, flag, pack_s = ell.build_packed(plan, dtype, 'cpu',
                                       with_conserves=True)
    assert flag is conserved and pack_s >= 0
    _packed_equal(t, want)
    _packed_equal(ell.build_packed(plan, dtype, 'cpu')[0], want)
    assert ell.build_packed(plan, dtype, 'cpu')[1] is None
    return t


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('name', CASES)
def test_build_packed_in_blocks(name, dtype, tol, monkeypatch):
    """build_packed, which packs each block of 2**BUILD_CHUNK_BITS rows as
    it is built and joins the pieces (one piece up to 32 rows), gives
    exactly pack_tables over the whole (G, rows) tables."""
    _build_in_blocks(_plans(name)[0], dtype, monkeypatch)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_build_packed_imag_blocks(dtype, tol, monkeypatch):
    """The same on SpinConserve(10, 5) -> SpinConserve(10, 4) of
    e^{i pi/7} sigma_plus plus its adjoint: eight blocks, the last one
    ragged, with the fi table; the joined tables apply as the (G, rows)
    ones do."""
    c = np.exp(1j * np.pi / 7)
    H = index_sum(c * sigma_plus() + np.conj(c) * sigma_minus(), size=10)
    left, right = subspaces.SpinConserve(10, 5), subspaces.SpinConserve(10, 4)
    plan = _Plan(H._msc_on(left), left, right)
    t = _build_in_blocks(plan, dtype, monkeypatch)
    assert t.fi is not None and t.n_slices == 8 and t.rows == 252
    _applies_agree(t, *ell.build_tables(plan, dtype, 'cpu'), seed=11,
                   tol=tol)


def _synthetic(G, rows, dim_right, seed, empty=(), index=torch.int32,
               imag=False, dtype=torch.float64):
    """(G, rows) tables with about half the entries zero (column 0), and
    the rows in ``empty`` without any entry."""
    rng = np.random.RandomState(seed)
    keep = rng.random_sample((G, rows)) < 0.5
    keep[:, list(empty)] = False
    cols = np.where(keep, rng.randint(0, dim_right, (G, rows)), 0)
    fr = np.where(keep, rng.standard_normal((G, rows)), 0)
    fi = np.where(keep, rng.standard_normal((G, rows)), 0) if imag else None
    as_t = (lambda a: None if a is None
            else torch.as_tensor(a, dtype=dtype))
    return torch.as_tensor(cols, dtype=index), as_t(fr), as_t(fi)


@pytest.mark.parametrize('imag', [False, True])
@pytest.mark.parametrize('rows', [1, 31, 45, 100])
def test_pack_ragged_rows(rows, imag):
    """rows % 32 != 0: the last slice is narrower, and stores nothing for
    the rows it lacks."""
    tables = _synthetic(5, rows, 17, seed=rows, imag=imag)
    t = ell.pack_tables(*tables, 17)
    assert t.n_slices == -(-rows // 32)
    last = rows - 32 * (t.n_slices - 1)
    assert int(t.slice_ptr[-1] - t.slice_ptr[-2]) % last == 0
    _check_layout(t, *tables)
    _applies_agree(t, *tables, seed=1, tol=1e-12)


def test_pack_empty_slice():
    """A slice whose 32 rows have no entry has width 0 and gives y = 0."""
    empty = range(32, 64)
    tables = _synthetic(6, 100, 40, seed=2, empty=empty)
    t = ell.pack_tables(*tables, 40)
    ptr = t.slice_ptr.numpy()
    assert ptr[2] == ptr[1] and ptr[1] > 0 and ptr[3] > ptr[2]
    _check_layout(t, *tables)
    y = _applies_agree(t, *tables, seed=3, tol=1e-12)
    assert not y[:, 32:64].any()


def test_pack_no_entry():
    tables = _synthetic(3, 40, 8, seed=4, empty=range(40))
    t = ell.pack_tables(*tables, 8)
    assert t.nnz == t.stored == 0 and t.slice_ptr.tolist() == [0, 0, 0]
    y = _applies_agree(t, *tables, seed=5, tol=1e-12)
    assert not y.any()


def test_pack_single_group():
    tables = _synthetic(1, 70, 70, seed=6)
    t = ell.pack_tables(*tables, 70)
    _check_layout(t, *tables)
    assert (torch.diff(t.slice_ptr) <= 32).all()
    _applies_agree(t, *tables, seed=7, tol=1e-12)


@pytest.mark.parametrize('dtype,tol', DTYPES)
def test_pack_int64_columns(dtype, tol):
    tables = _synthetic(4, 77, 50, seed=8, index=torch.int64, imag=True,
                        dtype=dtype)
    t = ell.pack_tables(*tables, 50)
    assert t.cols.dtype == torch.int64
    _check_layout(t, *tables)
    _applies_agree(t, *tables, seed=9, tol=tol)


def test_pack_drops_cancelled_group():
    """XX + YY on Explicit([00, 01, 10, 11]): the group's coefficient
    cancels to exactly 0 on rows 00 and 11, whose partners lie inside the
    subspace; those entries are dropped and the apply is unchanged."""
    H = sigmax(0) * sigmax(1) + sigmay(0) * sigmay(1)
    sub = subspaces.Explicit([0b00, 0b01, 0b10, 0b11], L=2)
    H.add_subspace(sub)
    plan = _Plan(H._msc_on(sub), sub, sub)
    cols, fr, fi = ell.build_tables(plan, torch.float64, 'cpu')
    assert fi is None
    valid = plan.right_map.s2i(plan.row_states(
        torch.arange(4)) ^ 0b11)[1]
    assert valid.all() and (fr[0, [0, 3]] == 0).all()
    t = ell.pack_tables(cols, fr, fi, plan.dim_right)
    _check_layout(t, cols, fr, fi)
    assert t.nnz == 2 and t.stored == 4
    y = _applies_agree(t, cols, fr, fi, seed=10, tol=1e-12)
    x = np.random.RandomState(10).standard_normal((2, 4))
    want = H.to_numpy() @ (x[0] + 1j * x[1])
    assert _rel(y[0].numpy() + 1j * y[1].numpy(), want) <= 1e-12
