"""
The port on a CUDA device: the hand-written XOR kernel against its plain
PyTorch version on both routes (one device, and P virtual shards of one
vector) and on XParity spaces, the sector and XOR-dense engines against
their plain versions, the sector engine's CUDA graph bitwise against its
channel loop, Operator.dot / evolve / eigsolve through them, the
RDM's device route and the entropy on the card against the host routes,
the MINRES inner solve and eigsolve(target=) against the same calls on the
CPU, the ELL kernel (``csrc/ell_apply.cu``) over the packed tables against
their plain version and the (G, rows) tables' (operators' tables and
synthetic ones: a width-0 slice, a ragged last slice, int64 columns), and
Explicit/Auto/rectangular pairs through it, the XOR-dense engine's and the
kernel's XParity applies over virtual ranks against one device, memory
tracking, and the distributed path on NCCL (state files and
``convert_state`` too) when the machine has two GPUs or more.

Every test here needs a card (marker ``cuda``) and skips without one. The
file imports no JAX, so it runs on a machine without it, from the root of
the repository (``--noconftest`` skips tests/conftest.py, which sets up
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: kernel or engine against plain version max|dy|/max|y| <= 1e-5
(float32) and 1e-12 (float64), as in chip_smoke.py; solvers as in
test_torch_solvers.py.
"""

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.computations import eigsolve, evolve
from dynamite_tpu_torch.ops.xor_apply import (xor_apply, xor_apply_reference,
                                              xor_apply_sharded,
                                              xor_apply_sharded_reference)
from dynamite_tpu_torch.states import State


# One torch thread per xdist worker. torch on every core in several workers
# overloads the machine, and the JAX package's CPU collectives then miss
# XLA's rendezvous timeout and abort the worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 13
SPACES = ['full', 'even', 'odd']

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The CUDA device; the port's config is left at its defaults, which
    put states on it."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    config._L = None
    config._subspace = None
    if config.device.type != 'cuda':
        pytest.skip('config.device is not the CUDA device')
    return config.device


def _sub(space, L=L):
    if space == 'full':
        return subspaces.Full(L=L)
    return subspaces.Parity(space, L=L)


def _planes(dim, seed=0):
    x = np.random.RandomState(seed).standard_normal((2, dim))
    return x / np.linalg.norm(x)


def _few_diag(L):
    """XX hopping plus a mask-0 group of 2 terms: below the 4 terms that
    turn the diagonal into a stream, so mask 0 runs as an ordinary group."""
    from dynamite_tpu_torch.operators import sigmaz
    H = models.xx(L) + 0.3 * sigmaz(0) * sigmaz(1) + 0.2 * sigmaz(5)
    assert 0 < len(H.msc) and sum(H.msc['masks'] == 0) == 2
    return H


def _model(name, L=L):
    return _few_diag(L) if name == 'few_diag' else getattr(models, name)(L)


@pytest.mark.parametrize('model', ['mbl', 'few_diag', 'long_range',
                                   'heisenberg'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', SPACES)
def test_kernel_vs_plain_on_card(card, space, dtype, model):
    """mbl has a diagonal stream, few_diag keeps mask 0 in the group loop,
    long_range has 50+ diagonal terms and complex group coefficients,
    heisenberg's XX + YY groups above the tile cancel in half the tiles,
    which skip them; L=13 holds several tiles."""
    H = _model(model)
    H.allow_projection = True
    H.add_subspace(_sub(space))
    tables = H.get_mat().tables
    assert tables.use_diag == (model != 'few_diag')
    x = torch.from_numpy(_planes(tables.dim)).to(card, dtype)
    before = tracing.counter('xor.launches')
    y = xor_apply(x, tables)
    torch.cuda.synchronize()
    assert tracing.counter('xor.launches') == before + 1
    want = xor_apply_reference(x, tables)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    err = (y - want).abs().max() / want.abs().max()
    assert float(err) <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_with_large_tables(card, dtype):
    """~3000 random Pauli strings: the group/term tables exceed the 48 KB
    of shared memory a launch gets by default."""
    from dynamite_tpu_torch.operators import Operator
    from dynamite_tpu_torch.utils.bitwise import parity
    rng = np.random.RandomState(9)
    n = 3000
    masks = rng.randint(0, 1 << L, n)
    signs = rng.randint(0, 1 << L, n)
    r = rng.uniform(-1, 1, n)
    coeffs = np.where(parity(masks & signs) == 1, 1j * r, r)
    H = Operator.from_msc(np.array(list(zip(masks, signs, coeffs)),
                                   dtype=[('masks', np.int64),
                                          ('signs', np.int64),
                                          ('coeffs', np.complex128)]))
    H.add_subspace(_sub('full'))
    tables = H.get_mat().tables
    assert tables.smem_bytes(torch.empty((), dtype=dtype).element_size()) \
        > 48 * 1024
    x = torch.from_numpy(_planes(tables.dim)).to(card, dtype)
    y = xor_apply(x, tables)
    want = xor_apply_reference(x, tables)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - want).abs().max() / want.abs().max()) <= tol


def test_dot_on_card_matches_cpu(card):
    H = models.localized(L)
    sub = _sub('full')
    H.add_subspace(sub)
    psi = State(subspace=sub)
    psi.set_planes(_planes(sub.get_dimension(), seed=1))
    assert psi.data.is_cuda
    before = tracing.counter('xor.launches')
    got = H.dot(psi).to_numpy()
    assert tracing.counter('xor.launches') == before + 1
    want = H.to_numpy() @ psi.to_numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize('space', SPACES)
def test_evolve_and_eigsolve_on_card(card, space):
    H = models.localized(10)
    sub = _sub(space, L=10)
    H.add_subspace(sub)
    v = _planes(sub.get_dimension(), seed=2)
    psi = State(subspace=sub)
    psi.set_planes(v)

    before = tracing.counter('xor.launches')
    got = evolve(H, psi, t=1.0).to_numpy()
    assert tracing.counter('xor.launches') > before
    want = scipy.sparse.linalg.expm_multiply(-1j * H.to_numpy(),
                                             v[0] + 1j * v[1])
    assert np.linalg.norm(got - want) < 1e-6

    evals = eigsolve(H, nev=2)
    exact = np.linalg.eigvalsh(H.to_numpy().toarray())[:2]
    assert np.allclose(evals[:2], exact, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('P', [1, 2, 4])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', SPACES)
def test_sharded_kernel_vs_plain_on_card(card, space, dtype, P):
    """The sharded route on P virtual shards of one vector: each shard from
    its row offset and its partner blocks, against the plain version; put
    together, they equal the one-device kernel exactly where a block holds
    whole tiles of the one-device launch (both launches then merge the same
    slots in the same order), and within the tolerance where the tile
    shrinks to a smaller block (its slots merge other terms)."""
    from dynamite_tpu_torch.ops.xor_apply import tile_shape
    H = models.mbl(L)
    H.allow_projection = True
    H.add_subspace(_sub(space))
    tables = H.get_mat().tables
    x = torch.from_numpy(_planes(tables.dim)).to(card, dtype)
    st = tables.for_layout(tables.nbits - (P.bit_length() - 1))
    same_tiles = (tile_shape(st.local_bits, x.element_size())
                  == tile_shape(tables.nbits, x.element_size()))
    n = st.local_dim
    blocks = [x[:, b * n:(b + 1) * n].contiguous() for b in range(P)]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    before = tracing.counter('xor.launches')
    parts = []
    for me in range(P):
        srcs = [blocks[me ^ h] for h in st.hi_list]
        y = xor_apply_sharded(srcs, st, me * n)
        want = xor_apply_sharded_reference(srcs, st, me * n)
        assert float((y - want).abs().max() / want.abs().max()) <= tol
        parts.append(y)
    torch.cuda.synchronize()
    assert tracing.counter('xor.launches') == before + P
    whole = xor_apply(x, tables)
    got = torch.cat(parts, dim=1)
    if same_tiles:
        assert torch.equal(got, whole)
    else:
        assert float((got - whole).abs().max() / whole.abs().max()) <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_blocks_smaller_than_a_tile_on_card(card, dtype):
    """Blocks of 32 rows down to 1 row (fewer than the R rows of a thread):
    the tile shrinks to the block, so each shard is held against its plain
    version, and the shards put together against the one-device kernel,
    within the tolerance (smaller tiles merge other slots)."""
    H = models.long_range(5)
    H.add_subspace(subspaces.Full(L=5))
    tables = H.get_mat().tables
    x = torch.from_numpy(_planes(tables.dim)).to(card, dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    whole = xor_apply(x, tables)
    for P in (1, 4, 16, 32):
        st = tables.for_layout(tables.nbits - (P.bit_length() - 1))
        n = st.local_dim
        blocks = [x[:, b * n:(b + 1) * n].contiguous() for b in range(P)]
        parts = []
        for me in range(P):
            srcs = [blocks[me ^ h] for h in st.hi_list]
            y = xor_apply_sharded(srcs, st, me * n)
            want = xor_apply_sharded_reference(srcs, st, me * n)
            assert float((y - want).abs().max()) <= tol * float(
                whole.abs().max())
            parts.append(y)
        got = torch.cat(parts, dim=1)
        assert float((got - whole).abs().max() / whole.abs().max()) <= tol


def test_diagonal_builds_once_per_layout(card):
    """The diagonal stream is built once per (operator, dtype, device,
    layout) and counted in the counter ``xor.diagonal_launches``, apart
    from the matvec's
    one launch per apply; it equals its plain version."""
    from dynamite_tpu_torch.ops.xor_apply import (xor_diagonal,
                                                  xor_diagonal_reference)
    H = models.localized(L)
    H.add_subspace(_sub('full'))
    tables = H.get_mat().tables
    x = torch.from_numpy(_planes(tables.dim)).to(card, torch.float32)
    builds = tracing.counter('xor.diagonal_launches')
    launches = tracing.counter('xor.launches')
    for _ in range(3):
        xor_apply(x, tables)
    assert tracing.counter('xor.diagonal_launches') == builds + 1
    xor_apply(x.double(), tables)
    assert tracing.counter('xor.diagonal_launches') == builds + 2
    st = tables.for_layout(tables.nbits - 1)
    n = st.local_dim
    blocks = [x[:, :n].contiguous(), x[:, n:].contiguous()]
    for _ in range(2):
        for me in range(2):
            xor_apply_sharded([blocks[me ^ h] for h in st.hi_list], st,
                              me * n)
    assert tracing.counter('xor.diagonal_launches') == builds + 4
    assert tracing.counter('xor.launches') == launches + 8
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        d = xor_diagonal(st, n, dtype, card)
        want = xor_diagonal_reference(st, n, dtype, card)
        assert float((d - want).abs().max() / want.abs().max()) <= tol


def _diag_tables(model, space, L):
    """The XorTables of a diagonal case (as in test_torch_xor_tiles.py):
    localized, long_range, four_diag (the XX chain plus exactly the 4 ZZ
    terms that make a stream), random_complex_diag (localized's diagonal
    terms with random complex coefficients put into the tables: two
    planes; a Hermitian operator's are real) and folded_localized
    ((localized(L) - 0.3)^2, as eigsolve(target_method='fold') builds it),
    on Full, Parity or XParity(Full)."""
    from dynamite_tpu_torch import computations
    from dynamite_tpu_torch.operators import Operator, sigmaz
    if model == 'folded_localized':
        H = Operator.from_msc(computations._folded_msc(models.localized(L),
                                                       0.3))
    elif model == 'four_diag':
        H = (models.xx(L) + 0.5 * sigmaz(0) * sigmaz(1)
             - 0.25 * sigmaz(1) * sigmaz(2) + 0.75 * sigmaz(0) * sigmaz(9)
             + 0.125 * sigmaz(4) * sigmaz(10))
    elif model == 'long_range':
        H = models.long_range(L)
    else:
        H = models.localized(L)
    H.allow_projection = True
    if space.startswith('xparity'):
        sub = subspaces.XParity(subspaces.Full(L=L), space[-1])
    else:
        sub = _sub(space, L=L)
    H.add_subspace(sub)
    tables = H.get_mat().tables
    assert tables.use_diag
    if model == 'four_diag':
        assert len(tables.diag_s) == 4
    if model == 'random_complex_diag':
        rng = np.random.RandomState(8)
        tables.diag_c = rng.uniform(-1, 1, (len(tables.diag_s), 2)) @ [1, 1j]
        tables.has_imag_diag = True
    return tables


def _diagonal_on_shards(tables, dtype, card, worlds):
    """The diagonal kernel on P shards for each P in worlds: every block's
    stream against its plain version, and the shards put together bitwise
    equal to the one-device stream (each block takes its rows of the same
    aligned tiles, whatever its size); one launch per block."""
    from dynamite_tpu_torch.ops.xor_apply import (xor_diagonal,
                                                  xor_diagonal_reference)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    whole = xor_diagonal(tables.for_layout(tables.nbits), 0, dtype, card)
    planes = 2 if tables.has_imag_diag else 1
    assert whole.shape == (planes, tables.dim)
    for P in worlds:
        st = tables.for_layout(tables.nbits - (P.bit_length() - 1))
        n = st.local_dim
        before = tracing.counter('xor.diagonal_launches')
        parts = []
        for me in range(P):
            d = xor_diagonal(st, me * n, dtype, card)
            want = xor_diagonal_reference(st, me * n, dtype, card)
            assert d.shape == want.shape == (planes, n)
            assert float((d - want).abs().max()) <= tol * float(
                want.abs().max())
            parts.append(d)
        torch.cuda.synchronize()
        assert tracing.counter('xor.diagonal_launches') == before + P
        assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize('space', ['full', 'even', 'odd', 'xparity_+',
                                   'xparity_-'])
@pytest.mark.parametrize('model', ['localized', 'long_range', 'four_diag',
                                   'random_complex_diag', 'folded_localized'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_diagonal_kernel_vs_plain_on_card(card, dtype, model, space):
    """The diagonal kernel (a Walsh-Hadamard transform per tile of 2**12
    rows) at L=15 (L=12 folded; XParity halves the rows) against its plain
    version, on 1, 2, 4 and 8 shards: every row offset, blocks of 2**11
    rows down to 2**8 (smaller than a tile)."""
    L = 12 if model == 'folded_localized' else 15
    tables = _diag_tables(model, space, L)
    _diagonal_on_shards(tables, dtype, card, (1, 2, 4, 8))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_diagonal_blocks_smaller_than_a_vector_on_card(card, dtype):
    """long_range(5) (32 rows, one tile holds them all) on 1 to 32 shards:
    blocks of 32 rows down to 1 row, fewer than the 16 bytes of a store."""
    _diagonal_on_shards(_diag_tables('long_range', 'full', 5), dtype, card,
                        (1, 4, 16, 32))


def test_diagonal_of_the_folded_l24_on_card(card):
    """The folded localized(24) of eigsolve(target_method='fold'): 1,016
    diagonal terms on Full(24), float32, against its plain version."""
    from dynamite_tpu_torch.ops.xor_apply import (xor_diagonal,
                                                  xor_diagonal_reference)
    tables = _diag_tables('folded_localized', 'full', 24)
    assert len(tables.diag_s) == 1016
    st = tables.for_layout(tables.nbits)
    d = xor_diagonal(st, 0, torch.float32, card)
    want = xor_diagonal_reference(st, 0, torch.float32, card)
    assert float((d - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize('sector', ['+', '-'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('parent', ['full', 'even'])
def test_xparity_kernel_vs_plain_on_card(card, parent, dtype, sector):
    """XParity over Full(13) and Parity('even', L=14): the rewritten masks
    that touched spin L-1 fold onto m ^ (2**L - 1), reaching nearly every
    bit, so the far groups and the tile skip run."""
    from dynamite_tpu_torch.models import localized
    base = (subspaces.Full(L=13) if parent == 'full'
            else subspaces.Parity('even', L=14))
    H = localized(base.L)
    H.allow_projection = True
    H.add_subspace(subspaces.XParity(base, sector))
    tables = H.get_mat().tables
    assert tables.dim == 1 << 12
    x = torch.from_numpy(_planes(tables.dim, seed=3)).to(card, dtype)
    before = tracing.counter('xor.launches')
    y = xor_apply(x, tables)
    torch.cuda.synchronize()
    assert tracing.counter('xor.launches') == before + 1
    want = xor_apply_reference(x, tables)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - want).abs().max() / want.abs().max()) <= tol


def _sector_operator(model, space):
    """(H, subspace, kernel) of a sector-engine case: SpinConserve(12, 6)
    ('sc'), SpinConserve(13, 5) ('sc_odd') or XParity(SpinConserve(12, 6),
    '-') ('xparity')."""
    sub = {'sc': lambda: subspaces.SpinConserve(12, 6),
           'sc_odd': lambda: subspaces.SpinConserve(13, 5),
           'xparity': lambda: subspaces.XParity(
               subspaces.SpinConserve(12, 6), '-')}[space]()
    H = getattr(models, model)(sub.L)
    H.allow_projection = True
    H.add_subspace(sub)
    kernel = H.get_mat()
    assert kernel.sector_plan is not None
    return H, sub, kernel


def _graph_counts():
    return (tracing.counter('sector.graph_captures'),
            tracing.counter('sector.graph_replays'))


def _sector_eager(x, tables):
    from dynamite_tpu_torch.ops.sector_apply import _sector_apply_eager
    y = torch.empty_like(x)
    _sector_apply_eager(x, tables, y)
    return y


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', ['sc', 'sc_odd', 'xparity'])
@pytest.mark.parametrize('model', ['heisenberg', 'long_range'])
def test_sector_engine_vs_plain_on_card(card, model, space, dtype):
    """The sector engine on the card against its plain version (the
    on-the-fly row sweep) and the numpy oracle: SpinConserve(12, 6),
    SpinConserve(13, 5) and XParity(SpinConserve(12, 6), '-');
    long_range has complex matrices."""
    from dynamite_tpu_torch.ops.sector_apply import sector_apply_reference
    H, sub, kernel = _sector_operator(model, space)
    x = torch.from_numpy(_planes(sub.get_dimension(), seed=4)).to(card, dtype)
    before = tracing.counter('sector.applies')
    y = kernel.apply(x)
    assert tracing.counter('sector.applies') == before + 1
    want = sector_apply_reference(x, kernel.plan)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - want).abs().max() / want.abs().max()) <= tol
    v = x.double().cpu().numpy()
    oracle = H.to_numpy() @ (v[0] + 1j * v[1])
    got = y.double().cpu().numpy()
    assert np.max(np.abs(got[0] + 1j * got[1] - oracle)) <= \
        tol * np.max(np.abs(oracle))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', ['sc', 'sc_odd', 'xparity'])
@pytest.mark.parametrize('model', ['heisenberg', 'long_range'])
def test_sector_graph_vs_eager_on_card(card, model, space, dtype):
    """The sector engine's CUDA graph: captured once at a table set's first
    apply and replayed at every apply, its y bitwise the channel loop's,
    and each result a tensor of its own (the second apply leaves the
    first's result as it was)."""
    from dynamite_tpu_torch.ops.sector_apply import sector_apply
    _H, sub, kernel = _sector_operator(model, space)
    tables = kernel.sector_tables
    xs = [torch.from_numpy(_planes(sub.get_dimension(), seed=s)).to(
        card, dtype) for s in (6, 7)]
    captures, replays = _graph_counts()
    y1 = sector_apply(xs[0], tables)
    assert _graph_counts() == (captures + 1, replays + 1)
    kept = y1.clone()
    y2 = sector_apply(xs[1], tables)
    assert _graph_counts() == (captures + 1, replays + 2)
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, kept)
    assert torch.equal(y1, _sector_eager(xs[0], tables))
    assert torch.equal(y2, _sector_eager(xs[1], tables))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', ['sc', 'sc_odd', 'xparity'])
def test_sector_graphs_of_two_table_sets_on_card(card, space, dtype):
    """Two table sets on one space, heisenberg (A) and long_range (B),
    share the graphs' staging buffers and memory pool: applied A, B, A,
    each gives its own channel loop's y bitwise, with one capture a table
    set."""
    from dynamite_tpu_torch.ops.sector_apply import sector_apply
    _H, sub, kernel_a = _sector_operator('heisenberg', space)
    _H, _sub, kernel_b = _sector_operator('long_range', space)
    x = torch.from_numpy(_planes(sub.get_dimension(), seed=8)).to(card,
                                                                   dtype)
    captures, replays = _graph_counts()
    got = [sector_apply(x, k.sector_tables)
           for k in (kernel_a, kernel_b, kernel_a)]
    assert _graph_counts() == (captures + 2, replays + 3)
    want_a = _sector_eager(x, kernel_a.sector_tables)
    assert torch.equal(got[0], want_a)
    assert torch.equal(got[1], _sector_eager(x, kernel_b.sector_tables))
    assert torch.equal(got[2], want_a)


@pytest.mark.parametrize('space', ['sc', 'xparity'])
def test_sector_graph_of_a_copied_table_set_on_card(card, space):
    """A shallow copy of a table set with its column channels taken out
    (as ``chip_smoke.py --sector-forms`` makes one) captures a graph of
    its own after the original's: its y is its own channel loop's, not
    the original's replayed."""
    import copy
    from dynamite_tpu_torch.ops.sector_apply import sector_apply
    _H, sub, kernel = _sector_operator('heisenberg', space)
    tables = kernel.sector_tables
    assert tables.col_channels
    x = torch.from_numpy(_planes(sub.get_dimension(), seed=10)).to(card)
    full = sector_apply(x, tables)
    rest = copy.copy(tables)
    rest.col_channels, rest._on = [], {}
    captures, replays = _graph_counts()
    part = sector_apply(x, rest)
    assert _graph_counts() == (captures + 1, replays + 1)
    assert torch.equal(part, _sector_eager(x, rest))
    assert not torch.equal(part, full)
    assert torch.equal(sector_apply(x, tables), full)


def test_sector_apply_inside_a_capture_on_card(card):
    """Inside a CUDA graph capture of its caller the engine runs its channel
    loop, so the caller's graph holds the apply; replayed, it gives the
    loop's y bitwise."""
    from dynamite_tpu_torch.ops.sector_apply import sector_apply
    _H, sub, kernel = _sector_operator('long_range', 'sc')
    tables = kernel.sector_tables
    dim = sub.get_dimension()
    x = torch.from_numpy(_planes(dim, seed=9)).to(card)
    static_x = torch.zeros_like(x)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # the warm-up, on the capture stream
        _sector_eager(static_x, tables)
    torch.cuda.current_stream().wait_stream(stream)
    captures, replays = _graph_counts()
    applies = tracing.counter('sector.applies')
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, stream=stream):
        static_y = sector_apply(static_x, tables)
    assert tracing.counter('sector.applies') == applies + 1
    assert _graph_counts() == (captures, replays)
    static_x.copy_(x)
    outer.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_y, _sector_eager(x, tables))


@pytest.mark.parametrize('space', ['sc', 'xparity'])
def test_sector_evolve_and_eigsolve_on_card(card, space):
    base = subspaces.SpinConserve(12, 6)
    sub = base if space == 'sc' else subspaces.XParity(base, '+')
    H = models.heisenberg(12)
    H.add_subspace(sub)
    v = _planes(sub.get_dimension(), seed=5)
    psi = State(subspace=sub)
    psi.set_planes(v)
    before = tracing.counter('sector.applies')
    got = evolve(H, psi, t=1.0).to_numpy()
    assert tracing.counter('sector.applies') > before
    want = scipy.sparse.linalg.expm_multiply(-1j * H.to_numpy(),
                                             v[0] + 1j * v[1])
    assert np.linalg.norm(got - want) < 1e-6
    evals = eigsolve(H, nev=2)
    exact = np.linalg.eigvalsh(H.to_numpy().toarray())[:2]
    assert np.allclose(evals[:2], exact, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', ['full', 'even'])
def test_xor_dense_vs_plain_on_card(card, space, dtype):
    """The XOR-dense engine on the card against its plain version (the XOR
    kernel's on-the-fly sweep) and the numpy oracle: syk(12) (10,626 terms)
    on Full(12) and syk(11) (7,315 terms) on Parity(13) even, both of
    dimension 4096 and past the XOR kernel's shared-memory tables."""
    from dynamite_tpu_torch.ops.xor_apply import XorTables
    sub = subspaces.Full(L=12) if space == 'full' else \
        subspaces.Parity('even', L=13)
    H = models.syk(12 if space == 'full' else 11)
    H.add_subspace(sub)
    kernel = H.get_mat()
    assert kernel.xor_dense is not None and kernel.tables is None
    x = torch.from_numpy(_planes(sub.get_dimension(), seed=6)).to(card, dtype)
    before = tracing.counter('xor_dense.applies')
    y = kernel.apply(x)
    assert tracing.counter('xor_dense.applies') == before + 1
    want = xor_apply_reference(x, XorTables(kernel.plan, sub))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - want).abs().max() / want.abs().max()) <= tol
    v = x.double().cpu().numpy()
    oracle = H.to_numpy() @ (v[0] + 1j * v[1])
    got = y.double().cpu().numpy()
    assert np.max(np.abs(got[0] + 1j * got[1] - oracle)) <= \
        tol * np.max(np.abs(oracle))


@pytest.mark.parametrize('space', ['full', 'odd', 'sc'])
def test_rdm_and_entropy_on_card(card, space):
    """The RDM's device route against the host route, and the entropy
    taken on the card against the dm_* route, on Full(12), Parity(12) odd
    and SpinConserve(12, 6), for a half cut, an uneven one and a scattered
    one."""
    from dynamite_tpu_torch.computations import (dm_entanglement_entropy,
                                                 entanglement_entropy,
                                                 reduced_density_matrix,
                                                 renyi_entropy,
                                                 dm_renyi_entropy)
    from dynamite_tpu_torch.ops.rdm import rdm_host
    sub = {'full': lambda: subspaces.Full(L=12),
           'odd': lambda: subspaces.Parity('odd', L=12),
           'sc': lambda: subspaces.SpinConserve(12, 6)}[space]()
    v = _planes(sub.get_dimension(), seed=7)
    psi = State(subspace=sub)
    psi.set_planes(v)
    assert psi.data.device.type == 'cuda'
    for keep in (tuple(range(6)), tuple(range(4)), (0, 3, 5, 8, 11)):
        rho = reduced_density_matrix(psi, keep)
        assert np.max(np.abs(rho - rdm_host(psi, keep))) <= 1e-12
        assert abs(entanglement_entropy(psi, keep)
                   - dm_entanglement_entropy(rho)) <= 1e-10
        assert abs(renyi_entropy(psi, keep, 2)
                   - dm_renyi_entropy(rho, 2)) <= 1e-10


def _on_cpu(fn):
    """fn() with the port's states on the CPU (the kernel's plain version),
    the card's default restored after."""
    saved = config._device
    config.device = 'cpu'
    try:
        return fn()
    finally:
        config._device = saved


def test_minres_on_card_matches_cpu(card):
    """The MINRES inner solve through the XOR kernel on the card against
    the same solve on the CPU (the kernel's plain version), float64."""
    from dynamite_tpu_torch.solvers.minres import minres_solver
    H = models.localized(12)
    H.add_subspace(subspaces.Full(L=12))
    kernel = H.get_mat()
    b = _planes(1 << 12, seed=4)
    shift = -(H._infinity_norm_host() + 1.0)  # below the spectrum

    def solve(device):
        stats = {}
        x = minres_solver(kernel.apply, shift=shift, maxiter=300, rtol=1e-10,
                          stats=stats)(torch.tensor(b, device=device))
        return x.cpu().numpy(), stats

    before = tracing.counter('xor.launches')
    got, stats = solve(card)
    assert tracing.counter('xor.launches') - before == stats['iterations'] > 0
    want, _ = solve('cpu')
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


def test_target_eigsolve_on_card_matches_cpu(card):
    """eigsolve(target=) by shift-invert near the spectrum's edge, float64,
    on the card (the XOR kernel once per counted matvec) against the same
    solve on the CPU and against scipy's eigsh, to 1e-10."""
    from dynamite_tpu_torch import computations
    H = models.localized(12)
    H.add_subspace(subspaces.Full(L=12))
    exact = np.sort(scipy.sparse.linalg.eigsh(
        H.to_numpy(), k=6, which='SA', return_eigenvectors=False))
    target = float(0.7 * exact[3] + 0.3 * exact[4])
    before = tracing.counter('xor.launches')
    got = np.sort(eigsolve(H, nev=2, target=target))
    stats = computations.last_solve_stats
    assert tracing.counter('xor.launches') - before >= stats['matvecs'] > 0
    want = np.sort(_on_cpu(lambda: eigsolve(H, nev=2, target=target)))
    assert np.allclose(got, want, rtol=1e-10, atol=0)
    nearest = np.sort(exact[np.argsort(np.abs(exact - target))[:2]])
    assert np.allclose(got, nearest, rtol=1e-10, atol=0)


def _ell_kernel(case, L=11):
    """An operator's kernel object on the ELL route: 'auto' (real
    coefficients), 'rect' (SpinConserve(L, k-1) -> SpinConserve(L, k) of
    e^{i pi/7} sigma_plus plus its adjoint: the fi table), 'odd_rows'
    (Parity -> Full of ising(L): 2**L rows from 2**(L-1) columns, and an
    Explicit subset whose row count is no multiple of the block)."""
    from dynamite_tpu_torch.operators import (index_sum, sigma_minus,
                                              sigma_plus)
    if case == 'auto':
        H = models.localized(L)
        left = right = subspaces.Auto(H, 'U' * (L // 2) + 'D' * (L - L // 2))
    elif case == 'rect':
        c = np.exp(1j * np.pi / 7)
        H = index_sum(c * sigma_plus() + np.conj(c) * sigma_minus(), size=L)
        left = subspaces.SpinConserve(L, L // 2)
        right = subspaces.SpinConserve(L, L // 2 - 1)
    elif case == 'full_from_even':
        H = models.ising(L)
        left, right = subspaces.Full(L=L), subspaces.Parity('even', L=L)
    else:
        H = models.localized(L)
        sc = subspaces.SpinConserve(L, L // 2)
        states = sc.idx_to_state(np.arange(sc.get_dimension()))[:-37]
        left = right = subspaces.Explicit(states[::-1].copy(), L=L)
    H.allow_projection = True
    H.add_subspace(left, right)
    k = H.get_mat(subspaces=(left, right))
    assert k.engine == 'ell'
    return H, left, right, k


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('case', ['auto', 'rect', 'full_from_even',
                                  'odd_rows'])
def test_ell_kernel_vs_plain_on_card(card, case, dtype):
    """The kernel over the packed tables against their plain version and
    the plain version over the (G, rows) tables; the operator's apply
    counts one launch per matvec."""
    from dynamite_tpu_torch.ops import ell
    H, left, right, k = _ell_kernel(case)
    t = k.ell_tables.on(dtype, card)
    assert t.cols.is_cuda and t.cols.dtype == torch.int32
    assert (t.fi is not None) is (case == 'rect')
    x = torch.as_tensor(_planes(right.get_dimension(), seed=8), dtype=dtype,
                        device=card)
    before = tracing.counter('ell.launches')
    y = ell.ell_apply(x, t)
    torch.cuda.synchronize()
    assert tracing.counter('ell.launches') == before + 1
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert y.shape == (2, left.get_dimension()) and y.dtype == dtype
    for y_plain in (ell.sell_apply_reference(x, t),
                    ell.ell_apply_reference(
                        x, *ell.build_tables(k.plan, dtype, card))):
        assert float((y - y_plain).abs().max()) <= \
            tol * float(y_plain.abs().max())
    # the operator's apply launches the same kernel, once
    y2 = k.apply(x)
    assert tracing.counter('ell.launches') == before + 2
    assert torch.equal(y2, y)


@pytest.mark.parametrize('case', ['auto', 'rect'])
def test_ell_build_packed_on_card(card, case, monkeypatch):
    """The build that packs each block of rows as it computes it, in
    blocks of 32 rows, equals packing the whole (G, rows) tables, with the
    same conservation flag."""
    from dynamite_tpu_torch.ops import ell
    _H, _l, _r, k = _ell_kernel(case)
    *tables, conserved = ell.build_tables(k.plan, torch.float32, card,
                                          with_conserves=True)
    want = ell.pack_tables(*tables, k.plan.dim_right)
    monkeypatch.setattr(ell, 'BUILD_CHUNK_BITS', 5)
    t, flag, _pack_s = ell.build_packed(k.plan, torch.float32, card,
                                        with_conserves=True)
    assert flag is conserved and t.n_slices > 1
    for got, ref in zip(t, want):
        if isinstance(ref, torch.Tensor):
            assert got.is_cuda and torch.equal(got, ref)
        else:
            assert got == ref


def _synthetic_tables(layout, dtype, device):
    """Packed tables of (G, rows) tables drawn with numpy, about half the
    entries zero: 'empty_slice' (rows 32-63 without an entry: a width-0
    slice), 'ragged' (45 rows: a last slice of 13),
    'int64' (int64 columns and an fi table)."""
    from dynamite_tpu_torch.ops import ell
    G, rows, dim_right = {'empty_slice': (6, 100, 40), 'ragged': (5, 45, 17),
                          'int64': (4, 77, 50)}[layout]
    rng = np.random.RandomState(rows)
    keep = rng.random_sample((G, rows)) < 0.5
    if layout == 'empty_slice':
        keep[:, 32:64] = False
    cols = torch.as_tensor(np.where(keep, rng.randint(0, dim_right,
                                                      (G, rows)), 0),
                           dtype=(torch.int64 if layout == 'int64'
                                  else torch.int32), device=device)
    fr, fi = (torch.as_tensor(np.where(keep, rng.standard_normal((G, rows)),
                                       0), dtype=dtype, device=device)
              for _ in range(2))
    tables = (cols, fr, fi if layout == 'int64' else None)
    return tables, ell.pack_tables(*tables, dim_right)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('layout', ['empty_slice', 'ragged', 'int64'])
def test_ell_kernel_synthetic_on_card(card, layout, dtype):
    from dynamite_tpu_torch.ops import ell
    tables, t = _synthetic_tables(layout, dtype, card)
    if layout == 'empty_slice':
        assert t.slice_ptr[2] == t.slice_ptr[1]
    x = torch.as_tensor(_planes(t.dim_right, seed=9), dtype=dtype,
                        device=card)
    y = ell.ell_apply(x, t)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for y_plain in (ell.sell_apply_reference(x, t),
                    ell.ell_apply_reference(x, *tables)):
        assert float((y - y_plain).abs().max()) <= \
            tol * float(y_plain.abs().max())
    if layout == 'empty_slice':
        assert not y[:, 32:64].any()


def test_ell_kernel_refuses_bad_inputs(card):
    from dynamite_tpu_torch.ops.ell import ell_apply
    _H, _l, right, k = _ell_kernel('auto')
    t = k.ell_tables.on(torch.float32, card)
    x = torch.zeros((2, right.get_dimension()), device=card)
    with pytest.raises(TypeError):
        ell_apply(x.double(), t)
    with pytest.raises(TypeError):
        ell_apply(x, t._replace(fr=t.fr.double()))
    with pytest.raises(ValueError):
        ell_apply(x[:, 1:].contiguous(), t)
    with pytest.raises(ValueError):
        ell_apply(x, t._replace(cols=t.cols[:-1]))
    with pytest.raises(ValueError):
        ell_apply(x, t._replace(cols=t.cols.cpu()))


def test_ell_evolve_and_eigsolve_on_card(card):
    """Auto(localized(12)) at half filling through the ELL kernel, against
    the same calls on SpinConserve(12, 6) (the same basis order) and
    eigvalsh."""
    H = models.localized(12)
    auto = subspaces.Auto(H, 'U' * 6 + 'D' * 6)
    H.add_subspace(auto)
    H_sc = models.localized(12)
    H_sc.add_subspace(subspaces.SpinConserve(12, 6))
    v = _planes(auto.get_dimension(), seed=6)
    psi, psi_sc = State(subspace=auto), State(subspace=H_sc.subspace)
    psi.set_planes(v)
    psi_sc.set_planes(v)
    before = tracing.counter('ell.launches')
    got = evolve(H, psi, t=1.0).to_numpy()
    assert tracing.counter('ell.launches') > before
    want = evolve(H_sc, psi_sc, t=1.0).to_numpy()
    assert np.linalg.norm(got - want) < 1e-10
    evals = eigsolve(H, nev=2)
    exact = np.linalg.eigvalsh(H.to_numpy().toarray())[:2]
    assert np.allclose(evals[:2], exact, rtol=1e-10, atol=1e-12)


def test_memory_usage_grows_on_card(card):
    from dynamite_tpu_torch import tools
    assert tools.track_memory()
    before = tools.get_memory_usage(group_by='rank')
    x = torch.ones(1 << 26, dtype=torch.float32, device=card)  # 0.27 GB
    after = tools.get_memory_usage(group_by='rank')
    assert after >= before + 0.26
    assert tools.get_memory_usage(max_usage=True) >= after
    del x
    assert tools.get_memory_usage() < after


def test_distributed_dot_on_nccl(card, tmp_path):
    """H.dot, norms and states on one rank per GPU (NCCL), against the numpy
    oracle; needs two GPUs or more."""
    n_gpus = torch.cuda.device_count()
    if n_gpus < 2:
        pytest.skip('needs two GPUs or more')
    from tests.test_torch_distributed import _model, _spawn
    world = 1 << (n_gpus.bit_length() - 1)
    H, sub = _model('dynamite_tpu_torch', 'full')
    v = _planes(sub.get_dimension(), seed=1)
    np.save(tmp_path / 'v.npy', v)
    recs = _spawn('dot_full', world, tmp_path, device='cuda')
    want = H.to_numpy() @ (v[0] + 1j * v[1])
    got = np.load(tmp_path / 'hv.npy')
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    assert recs[0]['inf_norm'] == pytest.approx(H._infinity_norm_host(),
                                                rel=1e-12)


def test_two_nodes_on_nccl(card, tmp_path):
    """Two nodes emulated on two cards, one each (the launch of
    tests/test_torch_multinode.py): each rank started by
    ``multihost.initialize()`` from SLURM's variables alone, each node its
    own ``CUDA_VISIBLE_DEVICES`` card (local rank 0), ``NCCL_HOSTID``,
    working directory and ``TMPDIR``; the all-reduce, a named barrier and
    heisenberg(10)'s dot over both nodes within 1e-12 of numpy's (float64);
    NCCL's log shows a communicator of two nodes and every link over
    NET/Socket. Needs two GPUs or more."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two GPUs or more')
    from chip_smoke import nccl_links
    from tests.test_torch_multinode import check_light, spawn_nodes
    logs = tmp_path / 'nccl'
    logs.mkdir()

    def nccl(node, rank):
        return {'NCCL_IB_DISABLE': '1', 'NCCL_NET': 'Socket',
                'NCCL_SOCKET_IFNAME': 'lo', 'NCCL_DEBUG': 'INFO',
                'NCCL_DEBUG_SUBSYS': 'INIT,P2P',
                'NCCL_DEBUG_FILE': str(logs / f'rank{rank}.log')}
    recs = spawn_nodes('light', tmp_path, 'slurm', per_node=1,
                       device='cuda', extra_env=nccl)
    check_light(recs, tmp_path / 'shared', 'slurm', per_node=1)
    for r, rec in enumerate(recs):
        assert (rec['card'], rec['host_id']) == ('cuda:0', f'node{r}')
        links = nccl_links((logs / f'rank{r}.log').read_text())
        assert links['transports'] == ['NET/Socket'], links
        assert (2, 2) in links['nccl_comms_ranks_nodes'], links


def _virtual(H, sub, world, **settings):
    """The one-device kernel and a kernel over ``world`` virtual ranks of
    one operator and subspace, built under ``settings`` (config)."""
    from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
    saved = {k: getattr(config, k) for k in settings}
    try:
        for k, v in settings.items():
            setattr(config, k, v)
        msc = H._msc_on(sub)
        return (OperatorKernel(msc, sub, sub),
                OperatorKernel(msc, sub, sub,
                               transport=VirtualTransport(world)))
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def _padded_on(v, world, dtype, device):
    from dynamite_tpu_torch.parallel import mesh
    x = torch.zeros((2, mesh.storage_dim(v.shape[1], world)), dtype=dtype,
                    device=device)
    x[:, :v.shape[1]] = torch.as_tensor(v, dtype=dtype, device=device)
    return x


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('world', [2, 3, 4, 8])
def test_sharded_ell_on_card(card, world, dtype):
    """Each virtual rank's ``ell_apply`` on its own tables (Auto of
    localized(12), 924 rows: 3 and 8 ranks pad), with the gathered input,
    gives its rows bitwise what the one-device kernel gives; the pads are
    0; the ranks' nonzeros add up to the one-device count; each launch is
    counted."""
    H = models.localized(12)
    sub = subspaces.Auto(H, 'U' * 6 + 'D' * 6)
    one, over = _virtual(H, sub, world)
    assert (one.engine, over.engine) == ('ell', 'ell')
    dim = sub.get_dimension()
    v = _planes(dim, seed=world)
    x = _padded_on(v, world, dtype, card)
    y1 = one.apply(x[:, :dim].contiguous())
    before = tracing.counter('ell.launches')
    y = over.apply(x)
    assert tracing.counter('ell.launches') == before + world
    assert y.is_cuda and torch.equal(y[:, :dim], y1)
    assert not y[:, dim:].any()
    nnz = sum(over.sharded.tables[r].on(dtype, y.device).nnz
              for r in range(world))
    assert nnz == one.ell_tables.on(dtype, y.device).nnz


@pytest.mark.parametrize('world', [2, 3, 4])
def test_alpha_ring_on_card(card, world):
    """The sector engine's alpha ring over virtual ranks (localized(12) on
    SpinConserve(12, 6)) against the one-device sector engine on the card,
    within 1e-5 relative in float32, and against the same ring on the
    CPU."""
    H = models.localized(12)
    sub = subspaces.SpinConserve(12, 6)
    H.add_subspace(sub)
    one, over = _virtual(H, sub, world)
    assert (one.engine, over.engine) == ('sector', 'sector_ring')
    dim = sub.get_dimension()
    v = _planes(dim, seed=3)
    x = _padded_on(v, world, torch.float32, card)
    y1 = one.apply(x[:, :dim].contiguous())
    y = over.apply(x)
    assert not y[:, dim:].any()
    assert float((y[:, :dim] - y1).abs().max() / y1.abs().max()) <= 1e-5
    y_cpu = over.apply(x.cpu())
    assert float((y.cpu() - y_cpu).abs().max() / y_cpu.abs().max()) <= 1e-5


def test_general_routes_on_nccl(card, tmp_path):
    """The general routes over one rank per GPU on NCCL (up to 4; at 3
    Full(8) leaves the XOR route): the route on every rank, pads 0, the
    dot within 1e-12 of the numpy oracle, evolve within 1e-10 of
    expm_multiply, eigenvalues within 1e-10 of eigvalsh (float64); needs
    two GPUs or more."""
    n_gpus = torch.cuda.device_count()
    if n_gpus < 2:
        pytest.skip('needs two GPUs or more')
    from tests.test_torch_distributed import (GENERAL, _general_cases,
                                              _general_model, _spawn)
    world = min(n_gpus, 4)
    v = _planes(70, seed=5)
    np.save(tmp_path / 'v.npy', v)
    recs = _spawn('general', world, tmp_path, device='cuda')
    for case in _general_cases(world):
        space, _settings, route = GENERAL[case]
        H, sub = _general_model('dynamite_tpu_torch', space)
        ranks = [r[case] for r in recs]
        assert all(r['engine'] == route and r['pads_zero'] for r in ranks)
        M = H.to_numpy()
        x = v if space != 'full' else _planes(256, seed=6)
        x = x[0] + 1j * x[1]
        got = np.load(tmp_path / f'{case}_hv.npy')
        assert np.max(np.abs(got - M @ x)) <= 1e-12 * np.max(np.abs(M @ x))
        oracle = scipy.sparse.linalg.expm_multiply(-1j * 0.5 * M, x)
        assert np.linalg.norm(np.load(tmp_path / f'{case}_evolved.npy')
                              - oracle) < 1e-10
        exact = np.linalg.eigvalsh(M.toarray())[:2]
        assert np.allclose(ranks[0]['evals'], exact, rtol=1e-10, atol=0)


def _syk_case(space):
    """syk(12) on Full(12), syk(11) on Parity(13) even: dimension 4096, past
    the XOR kernel's shared-memory tables."""
    if space == 'full':
        return models.syk(12), subspaces.Full(L=12)
    return models.syk(11), subspaces.Parity('even', L=13)


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', ['full', 'even'])
def test_sharded_xor_dense_on_card(card, space, dtype, world):
    """The XOR-dense engine's per-rank apply over ``world`` virtual ranks
    on the card against the one-device engine on the card, within 1e-5 /
    1e-12 relative to max|y|: one call a rank, the ranks sharing one set
    of channel matrices, the split within a rank's bits."""
    H, sub = _syk_case(space)
    one, over = _virtual(H, sub, world)
    assert (one.engine, over.engine) == ('xor_dense', 'xor_dense')
    t = over.xor_dense
    assert t.La <= 12 - (world.bit_length() - 1)
    x = torch.from_numpy(_planes(4096, seed=world)).to(card, dtype)
    y1 = one.apply(x)
    before = tracing.counter('xor_dense.applies')
    y = over.apply(x)
    assert tracing.counter('xor_dense.applies') == before + world
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert y.is_cuda
    assert float((y - y1).abs().max() / y1.abs().max()) <= tol
    mats = t.mats(dtype, y.device)
    for r in range(world):
        for run, mat in zip(t.on(dtype, y.device, r, world), mats):
            assert run[1] is mat[1]


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('parent', ['full', 'even'])
def test_sharded_xparity_on_card(card, parent, dtype, world):
    """XParity over Full(12) and Parity(12) even over ``world`` virtual
    ranks through the kernel's sharded route (one launch a rank, the sign
    on the global row) against the one-device kernel, within 1e-5 / 1e-12
    relative to max|y|."""
    H = models.localized(12)
    H.allow_projection = True
    sub = subspaces.XParity(_sub(parent, L=12), '-')
    one, over = _virtual(H, sub, world)
    assert (one.engine, over.engine) == ('xor', 'xor')
    dim = sub.get_dimension()
    x = torch.from_numpy(_planes(dim, seed=world)).to(card, dtype)
    y1 = one.apply(x)
    before = tracing.counter('xor.launches')
    y = over.apply(x)
    assert tracing.counter('xor.launches') == before + world
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - y1).abs().max() / y1.abs().max()) <= tol


def test_xor_route_and_files_on_nccl(card, tmp_path):
    """XParity pairs, SYK through the XOR-dense engine, state files and
    ``XParity.convert_state`` over one rank per GPU on NCCL (the largest
    power of two of them, up to 4): every rank on the same route and
    split, the dots within 1e-12 of the numpy oracle and of the one-device
    engine, evolve within 1e-10 of expm_multiply, eigenvalues within 1e-10
    of eigvalsh (float64); the ranks' file byte for byte a one-process
    save, each rank's rows of a load and of a conversion bitwise one
    process's, pads 0; needs two GPUs or more."""
    n_gpus = torch.cuda.device_count()
    if n_gpus < 2:
        pytest.skip('needs two GPUs or more')
    from tests.test_torch_distributed import (CONVERT, FILE_SPACES, SYK,
                                              XPARITY, _files_inputs,
                                              _spawn, _syk_model,
                                              _xparity_model)
    world = min(1 << (n_gpus.bit_length() - 1), 4)

    def port_save(space, v, fname):
        from tests.test_torch_distributed import _parent_sub
        psi = State(subspace=_parent_sub(subspaces, space, 8))
        psi.set_planes(v)
        psi.save(fname)

    _files_inputs(tmp_path, port_save)
    recs = _spawn('files', world, tmp_path, device='cuda')
    for r in recs:
        assert all(r.values()), [k for k, ok in r.items() if not ok]
        assert len(r) == 3 * len(FILE_SPACES) + 8 * len(CONVERT)
    for space in FILE_SPACES:
        for ext in ('.vec', '.metadata'):
            assert (tmp_path / f'ranks_{space}{ext}').read_bytes() == \
                (tmp_path / f'one_{space}{ext}').read_bytes()

    for name in XPARITY:
        H, sub = _xparity_model('dynamite_tpu_torch', name, '+')
        np.save(tmp_path / f'{name}_v.npy', _planes(sub.get_dimension(),
                                                    seed=8))
    np.save(tmp_path / 'syk_v.npy', _planes(4096, seed=9))
    recs = _spawn('xor_route', world, tmp_path, device='cuda')
    for key in recs[0]:
        assert all(r[key] == recs[0][key] for r in recs), key
    for name in XPARITY:
        for sector in '+-':
            key = name + sector
            assert recs[0][key]['engine'] == 'xor'
            H, sub = _xparity_model('dynamite_tpu_torch', name, sector)
            v = np.load(tmp_path / f'{name}_v.npy')
            x = v[0] + 1j * v[1]
            M = H.to_numpy()
            got = np.load(tmp_path / f'{key}_hv.npy')
            assert np.max(np.abs(got - M @ x)) <= \
                1e-12 * np.max(np.abs(M @ x))
            oracle = scipy.sparse.linalg.expm_multiply(-1j * M, x)
            assert np.linalg.norm(np.load(tmp_path / f'{key}_evolved.npy')
                                  - oracle) < 1e-10
            exact = np.linalg.eigvalsh(M.toarray())[:2]
            assert np.allclose(np.sort(recs[0][key]['evals'])[:2], exact,
                               rtol=1e-10, atol=0)
    v = np.load(tmp_path / 'syk_v.npy')
    for name in SYK:
        assert recs[0][name]['engine'] == 'xor_dense'
        H, sub = _syk_model('dynamite_tpu_torch', name)
        one = H.get_mat().apply(torch.as_tensor(v, device=card)).cpu()
        one = one.numpy()
        got = np.load(tmp_path / f'{name}_hv.npy')
        want = one[0] + 1j * one[1]
        assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


SWITCH_RUNNER = """\
import contextlib, io, json, sys
from dynamite_tpu_torch import switch
from dynamite_tpu_torch import tracing
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    switch.run_script(sys.argv[2], sys.argv[3:], device=sys.argv[1] or None)
print(json.dumps({'lines': buf.getvalue().splitlines(),
                  'launches': tracing.counter('xor.launches')}))
"""


def test_floquet_example_on_card(card):
    """The JAX package's floquet example through the package switch on the
    card against the same run on the CPU (float64, 1e-10), with the XOR
    kernel launched; each run in its own process."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, 'examples', 'scripts', 'floquet',
                          'run_floquet.py')
    recs = {}
    for device in ('', 'cpu'):
        proc = subprocess.run(
            [sys.executable, '-c', SWITCH_RUNNER, device, script, '-L', '12',
             '--n-cycles', '3'],
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        recs[device] = json.loads(proc.stdout.strip().splitlines()[-1])

    def numbers(lines):
        return np.array([line.split(',') for line in lines[1:]], dtype=float)

    got, want = numbers(recs['']['lines']), numbers(recs['cpu']['lines'])
    assert got.shape == want.shape == (4, 15)
    assert np.max(np.abs(got - want)) < 1e-10
    assert recs['']['launches'] > 0 and recs['cpu']['launches'] == 0


# the counter-based random draw (ops/draw.py) on the card against the CPU:
# one (seed, row) function, each device's own log, sqrt, cos and sin
# (each within a few ulps), so float64 agrees within DRAW_F64_RTOL of the
# largest entry, and float32, the float64 values rounded once, within one
# float32 ulp of it
DRAW_F64_RTOL = 1e-14
DRAW_F32_RTOL = 2.0 ** -23


@pytest.mark.parametrize('dtype,rtol', [(torch.float64, DRAW_F64_RTOL),
                                        (torch.float32, DRAW_F32_RTOL)])
def test_random_draw_on_card_matches_cpu(card, dtype, rtol):
    from dynamite_tpu_torch.ops.draw import normal_rows
    dim = (1 << 20) + 3
    got = normal_rows(42, dim, dtype, card, 0, 1).cpu()
    want = normal_rows(42, dim, dtype, torch.device('cpu'), 0, 1)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rtol * scale
    # a state and the eigensolver's start vector on the card, each
    # normalized there, against the CPU's
    from dynamite_tpu_torch.solvers.eigs import random_start
    sub = subspaces.Full(L=14)
    psi = State(state='random', subspace=sub, seed=7).to_numpy()
    saved = config._device
    config.device = 'cpu'
    try:
        cpu = State(state='random', subspace=sub, seed=7).to_numpy()
    finally:
        config._device = saved
    assert np.max(np.abs(psi - cpu)) <= DRAW_F64_RTOL * np.max(np.abs(cpu))
    w = random_start(1 << 14, torch.float64, card, seed=3).cpu()
    v = random_start(1 << 14, torch.float64, torch.device('cpu'), seed=3)
    assert float((w - v).abs().max()) <= DRAW_F64_RTOL * float(v.abs().max())


def test_switch_cards_on_nccl(card):
    """The JAX package's floquet example through ``python -m
    dynamite_tpu_torch.switch --cards 2`` (two ranks, one card each, NCCL)
    against ``--cards 1`` at L=20, float64: every number of its table
    within 1e-10 relative (+1e-12), printed once."""
    import os
    import subprocess
    import sys
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, 'examples', 'scripts', 'floquet',
                          'run_floquet.py')
    out = {}
    for cards in (1, 2):
        proc = subprocess.run(
            [sys.executable, '-m', 'dynamite_tpu_torch.switch', '--cards',
             str(cards), script, '-L', '20', '--n-cycles', '3'],
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[cards] = proc.stdout.splitlines()

    def numbers(lines):
        return np.array([line.split(',') for line in lines[1:]], dtype=float)

    assert len(out[2]) == len(out[1]) == 5 and out[2][0] == out[1][0]
    got, want = numbers(out[2]), numbers(out[1])
    assert got.shape == want.shape == (4, 23)
    assert np.all(np.abs(got - want) <= 1e-10 * np.abs(want) + 1e-12)
