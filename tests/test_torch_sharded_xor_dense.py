"""
The XOR route over ranks for what it did not take before: the XOR-dense
engine's per-rank apply (``ops/xor_dense.py::xor_dense_apply_sharded``) for
many-mask operators past the XOR kernel's tables, and XParity pairs over
Full and Parity on the kernel's sharded route. On the CPU with P in-process
virtual ranks (``ops/apply.py::VirtualTransport``, the per-rank code a
process group runs), against the port's one-device engines, the JAX
package on one device (a one-device mesh: its 8-device virtual mesh is a
suite hazard, ROADMAP.md queue 3) and numpy/scipy:

* SYK: syk(12) on Full(12) and syk(11) on Parity('even', L=13), both of
  dimension 2**12 (the engine's MIN_DIM), at P = 2 and 4: the apply within
  1e-12 relative to max|y| of the one-device engine, the JAX package's
  apply and ``msc_to_matrix`` in float64 (1e-5 in float32), its exchanges
  and calls counted; at a forced La every rank's channel matrices bitwise
  the one-device tables' (one set shared by the ranks), and its row
  gathers and signs the one-device rows it holds; the split capped at a
  rank's bits (syk(12) at P = 4: 10 bits, where one device takes 11) and an
  over-cap ``config.xor_dense_la`` raising; ``estimate_memory`` over ranks
  equal to what the build allocates; an eigsolve over 4 ranks within 1e-10
  of eigvalsh;
* XParity: localized(8) on XParity(Full(8)) and heisenberg(10) on
  XParity(Parity('even', L=10)) (local dim 64 at P = 4), both sectors, at
  P = 2 and 4: the apply within 1e-12 of the JAX package's and the matrix,
  evolve within 1e-10 (2-norm) of the JAX package's expmv and
  ``expm_multiply``, eigenvalues within 1e-10 of eigvalsh.

The spawned process-group runs are in tests/test_torch_distributed.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse.linalg import expm_multiply
from threadpoolctl import threadpool_limits

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.parallel.mesh import make_mesh
from dynamite_tpu.solvers.expmv import expmv as ref_expmv

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.ops import apply as port_apply
from dynamite_tpu_torch.ops import xor_dense
from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
from dynamite_tpu_torch.solvers.eigs import eigsolve_trlanczos
from dynamite_tpu_torch.solvers.expmv import expmv

# one torch thread per xdist worker (ROADMAP.md queue 3)
torch.set_num_threads(1)

WORLDS = [2, 4]
# (syk n, space, L): both of dimension 2**12
SYK = {'full12': (12, 'full', 12), 'even13': (11, 'even', 13)}
# (model, L, parent space)
XPARITY = {'full8': ('localized', 8, 'full'),
           'even10': ('heisenberg', 10, 'even')}


@pytest.fixture(autouse=True)
def reset_config():
    """Fresh configs, the port on the CPU, the JAX package on a one-device
    mesh, numpy's BLAS at one thread; every global restored after."""
    saved = config._device, ref_config.mesh
    config.device = 'cpu'
    ref_config._mesh = make_mesh(mesh_shape=(1,))
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    try:
        with threadpool_limits(limits=1, user_api='blas'):
            yield
    finally:
        for cfg in (ref_config, config):
            cfg._L = None
            cfg._subspace = None
        config._device, ref_config._mesh = saved


def _sub(pkg, space, L):
    return pkg.Full(L=L) if space == 'full' else pkg.Parity(space, L=L)


_MODELS = {}


def _model(pkg, name, n):
    """A copy of ``pkg.models.<name>(n)``, built once per package."""
    key = (pkg.__name__, name, n)
    if key not in _MODELS:
        _MODELS[key] = getattr(pkg, name)(n)
    return _MODELS[key].copy()


def _syk(case, pkgs=(models, subspaces)):
    n, space, L = SYK[case]
    H = _model(pkgs[0], 'syk', n)
    sub = _sub(pkgs[1], space, L)
    H.add_subspace(sub)
    return H, sub


def _xparity(case, sector, pkgs=(models, subspaces)):
    """The XParity case in one package; localized's Z fields do not commute
    with the global flip, so it is projected (as chip_smoke.py's
    localized(24) on XParity(Full(24)))."""
    name, L, space = XPARITY[case]
    H = _model(pkgs[0], name, L)
    H.allow_projection = True
    sub = pkgs[1].XParity(_sub(pkgs[1], space, L), sector)
    H.add_subspace(sub)
    return H, sub


def _ref_kernel(H_ref, s_ref):
    return H_ref.get_mat(subspaces=(s_ref, s_ref))


def _ref_dot(H_ref, s_ref, x):
    """The JAX package's one-device apply of (2, dim) planes."""
    kernel = _ref_kernel(H_ref, s_ref)
    return np.asarray(jax.jit(kernel.traceable(sharded=False))(x))


def _planes(dim, seed):
    v = np.random.RandomState(seed).standard_normal((2, dim))
    return v / np.linalg.norm(v)


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


_SYK_REFS = {}


def _syk_refs(case, H, x):
    """The matrix's and the JAX package's products with x of a SYK case,
    computed once per case (x is the same for every world)."""
    if case not in _SYK_REFS:
        H_ref, s_ref = _syk(case, (ref_models, ref_subspaces))
        _SYK_REFS[case] = (H.to_numpy() @ (x[0] + 1j * x[1]),
                           _ref_dot(H_ref, s_ref, x))
    return _SYK_REFS[case]


def _over(H, sub, world):
    return OperatorKernel(H._msc_on(sub), sub, sub,
                          transport=VirtualTransport(world))


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', list(SYK))
def test_syk_apply_over_ranks(case, world):
    """The engine over ``world`` ranks against one device, the JAX package
    and the matrix, in float64 and float32, with one call a rank and one
    exchange per rank and nonzero high mask: every m_hi occurs on Full(12);
    syk(11) on 13 spins leaves the two top spins, the rank's bits, alone,
    so its ranks exchange nothing."""
    H, sub = _syk(case)
    k = _over(H, sub, world)
    local_bits = 12 - (world.bit_length() - 1)
    assert k.engine == 'xor_dense' and k.xor_dense.La <= local_bits
    assert port_apply.sharded_route(k.plan, sub, sub, world) == 'xor'
    his = k.xor_dense.layout(local_bits).hi_list
    assert his == (list(range(world)) if case == 'full12' else [0])
    one = H.get_mat()
    assert one.engine == 'xor_dense'
    x = _planes(4096, seed=3)
    calls, swaps = (tracing.counter('xor_dense.applies'),
                    tracing.counter('transport.exchange.pairs'))
    got = k.apply(torch.as_tensor(x)).numpy()
    assert tracing.counter('xor_dense.applies') - calls == world
    assert (tracing.counter('transport.exchange.pairs') - swaps
            == world * (len(his) - 1))
    assert _rel(got, one.apply(torch.as_tensor(x)).numpy()) <= 1e-12
    want, want_ref = _syk_refs(case, H, x)
    assert _rel(got, want_ref) <= 1e-12
    assert _rel(got[0] + 1j * got[1], want) <= 1e-12
    got32 = k.apply(torch.as_tensor(x, dtype=torch.float32)).numpy()
    assert got32.dtype == np.float32
    assert _rel(got32[0] + 1j * got32[1], want) <= 1e-5


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', list(SYK))
def test_syk_tables_bitwise_over_ranks(case, world, monkeypatch):
    """At a forced La, the ranks share the one set of channel matrices,
    equal bitwise to the one-device tables' (float64 and float32), and
    each rank's row gather, read through its sources' high masks, and its
    signs are the one-device rows it holds."""
    monkeypatch.setattr(config, 'xor_dense_la', 5, raising=False)
    H, sub = _syk(case)
    one = H.get_mat().xor_dense
    k = _over(H, sub, world)
    t = k.xor_dense
    assert t.La == one.La == 5
    nhl = t.nh // world
    his = t.layout(12 - (world.bit_length() - 1)).hi_list
    cpu = torch.device('cpu')
    for dtype in (torch.float64, torch.float32):
        one_runs = one.on(dtype, cpu)
        for r in range(world):
            runs = t.on(dtype, cpu, r, world)
            for (imag, Mt, ridx, wt, KB), (imag1, Mt1, ridx1, wt1, KB1), \
                    (imag0, Mt0, _kb) in zip(runs, one_runs,
                                             t.mats(dtype, cpu)):
                assert (imag, KB) == (imag1, KB1)
                assert Mt is Mt0 and torch.equal(Mt, Mt1)
                # (batch, h, channel) of the rank against the one-device
                # rows r * nhl + h
                nb = ridx.shape[0]
                rows = ridx.view(nb, nhl, KB)
                src, h_src = rows // nhl, rows % nhl
                block = torch.as_tensor(his)[src] ^ r
                glob = block * nhl + h_src
                want = ridx1.view(nb, t.nh, KB)[:, r * nhl:(r + 1) * nhl]
                sign = wt.view(nb, nhl, KB)
                want_sign = wt1.view(nb, t.nh, KB)[:, r * nhl:(r + 1) * nhl]
                real = want_sign != 0   # padded channels read row h, sign 0
                assert torch.equal(glob[real], want[real])
                assert torch.equal(sign, want_sign)


def test_syk_split_cap(monkeypatch):
    """syk(12) on Full(12): one device takes La = 11; over 4 ranks (blocks
    of 2**10 rows) the split stays within 10 bits, over 2 within 11, every
    rank choosing alike; a forced La over the cap raises, naming it."""
    H, sub = _syk('full12')
    plan = port_apply._Plan(H._msc_on(sub), sub, sub)
    assert xor_dense.choose_split(plan, sub, sub)[1] == 11
    assert xor_dense.choose_split(plan, sub, sub, 4)[1] <= 10
    assert xor_dense.choose_split(plan, sub, sub, 2)[1] <= 11
    assert _over(H, sub, 4).xor_dense.La <= 10
    monkeypatch.setattr(config, 'xor_dense_la', 11, raising=False)
    assert _over(H, sub, 2).xor_dense.La == 11
    with pytest.raises(ValueError, match='xor_dense_la = 11.*over the cap '
                       'of 10'):
        _over(H, sub, 4)
    with pytest.raises(ValueError, match='over the cap'):
        H.estimate_memory(mpi_size=4)


@pytest.mark.parametrize('world', WORLDS)
def test_syk_estimate_memory_over_ranks(world):
    """``estimate_memory(mpi_size=P)`` counts, before any build, what the
    P ranks' build allocates: each rank's channel matrices (on a device of
    its own), its row gathers and signs, and its receive buffers."""
    H, sub = _syk('full12')
    engine_bytes = H._engine_table_bytes(world)
    before = H.estimate_memory(mpi_size=world)
    k = _over(H, sub, world)
    k.apply(torch.as_tensor(_planes(4096, seed=1)))
    t = k.xor_dense
    held = sum(ridx.numel() * 8 + wt.numel() * wt.element_size()
               for r in range(world)
               for _i, _m, ridx, wt, _kb in t.on(torch.float64,
                                                 torch.device('cpu'), r,
                                                 world))
    mats = sum(Mt.numel() * Mt.element_size()
               for _i, Mt, _kb in t.mats(torch.float64, torch.device('cpu')))
    recv = sum(b.numel() * b.element_size() for b in k._recv_bufs.values())
    assert recv == (world - 1) * 2 * (4096 // world) * 8
    allocated = world * mats + held + world * recv
    assert engine_bytes == allocated == world * t.rank_table_bytes(world) \
        + world * recv
    assert before * 1e9 >= allocated
    assert H.estimate_memory(mpi_size=world) == before


def test_syk_eigsolve_over_ranks(monkeypatch):
    """The lowest eigenvalue of syk(11) on Parity('even', L=11) through the
    engine over 4 ranks (the engine's minimum dimension lowered to 2**6),
    within 1e-10 of eigvalsh and of one device."""
    monkeypatch.setattr(xor_dense, 'MIN_DIM', 1 << 6)
    H = _model(models, 'syk', 11)
    sub = subspaces.Parity('even', L=11)
    H.add_subspace(sub)
    k = _over(H, sub, 4)
    assert k.engine == 'xor_dense'
    v0 = _planes(1024, seed=7)
    calls = tracing.counter('xor_dense.applies')
    stats = {}
    evals, _S, _V = eigsolve_trlanczos(k.krylov_ops(20), 1024,
                                       torch.float64, torch.device('cpu'),
                                       nev=1, tol=1e-12, v0=v0, stats=stats)
    assert tracing.counter('xor_dense.applies') - calls >= 4 * stats['matvecs']
    want = np.linalg.eigvalsh(H.to_numpy().toarray())[0]
    assert abs(evals[0] - want) <= 1e-10 * abs(want)
    one = H.eigsolve(nev=1, tol=1e-12)[0]
    assert abs(evals[0] - one) <= 1e-10 * abs(want)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('sector', ['+', '-'])
@pytest.mark.parametrize('case', list(XPARITY))
def test_xparity_over_ranks(case, sector, world):
    """XParity pairs take the XOR route over ranks: the apply, evolve and
    eigsolve against the JAX package on one device and numpy/scipy."""
    H, sub = _xparity(case, sector)
    dim = sub.get_dimension()
    k = _over(H, sub, world)
    assert k.engine == 'xor' and k.tables is not None
    x = _planes(dim, seed=11)
    got = k.apply(torch.as_tensor(x)).numpy()
    M = H.to_numpy()
    xc = x[0] + 1j * x[1]
    assert _rel(got[0] + 1j * got[1], M @ xc) <= 1e-12
    H_ref, s_ref = _xparity(case, sector, (ref_models, ref_subspaces))
    assert _rel(got, _ref_dot(H_ref, s_ref, x)) <= 1e-12

    anorm = H.infinity_norm()
    ev = expmv(k.krylov_ops(30), torch.as_tensor(x), -1j, anorm, ncv=30,
               tol=1e-12).numpy()
    ev = ev[0] + 1j * ev[1]
    assert np.linalg.norm(ev - expm_multiply(-1j * M, xc)) < 1e-10
    w = np.asarray(ref_expmv(_ref_kernel(H_ref, s_ref).krylov_ops(30),
                             jnp.asarray(x), -1j, H_ref.infinity_norm(),
                             ncv=30, tol=1e-12))
    assert np.linalg.norm(ev - (w[0] + 1j * w[1])) < 1e-10

    evals, _S, _V = eigsolve_trlanczos(k.krylov_ops(20), dim, torch.float64,
                                       torch.device('cpu'), nev=2, tol=1e-12,
                                       v0=_planes(dim, seed=12))
    exact = np.linalg.eigvalsh(M.toarray())[:2]
    assert np.allclose(np.sort(evals)[:2], exact, rtol=1e-10, atol=0)
