"""
The port's distributed paths on spawned ranks (torch.distributed on gloo,
CPU tensors) against numpy/scipy oracles and the JAX package: the XOR path
on 2 and 4 ranks (XParity pairs over Full and Parity, and SYK through the
XOR-dense engine's per-rank apply, included), the general routes over
ranks (the sector engine's alpha ring, each rank's ELL tables, the ring
sweep) on 2, 3 and 4 ranks, with the padded row layout where the dimension
does not divide the world, state files and ``XParity.convert_state`` on 2,
3 and 4 ranks, and a mirror of tests/integration/test_multiprocess.py on 2.

Each case spawns its ranks once. A rank runs this file as a script (see the
bottom): it imports torch and the port but neither JAX nor
``tests/conftest.py``, runs torch at one thread, and meets the others
through a ``file://`` store under the test's ``tmp_path``, so no ports are
opened and xdist workers never clash. The parent makes the inputs from
numpy seeds, computes the JAX and numpy sides, and hands both over as
``.npy`` files; rank 0 writes what the ranks computed back the same way.

Tolerances: matvec 1e-12 relative to max|y| in float64 (the same terms,
summed per row in the same order as one process); evolve, with the solver's
tol at 1e-12, 1e-10 in the 2-norm against ``expm_multiply`` and against the
JAX package's expmv; eigenvalues 1e-10 relative against ``eigvalsh`` and the
JAX package's eigsolve (sharded on its virtual mesh, or on one device where
the case says so). State files are compared byte for byte, and each rank's
rows of a load or a conversion bitwise against one process's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 8
SPACES = {'full': ('localized', None), 'even': ('heisenberg', 'even')}


@pytest.fixture(autouse=True)
def cpu_device():
    """The port's operators built here run on the CPU, which the port uses
    only when asked (the rank processes ask for their own device)."""
    from dynamite_tpu_torch import config
    saved = config._device
    config.device = 'cpu'
    yield
    config._device = saved


def _model(pkg, space):
    """The case's operator and subspace in one package (the port or the
    JAX reference): localized(8) on Full, heisenberg(9) on Parity even —
    both of dimension 256."""
    model, sector = SPACES[space]
    import importlib
    models = importlib.import_module(pkg + '.models')
    subspaces = importlib.import_module(pkg + '.subspaces')
    if sector is None:
        H, sub = getattr(models, model)(L), subspaces.Full(L=L)
    else:
        H, sub = getattr(models, model)(L + 1), subspaces.Parity(
            sector, L=L + 1)
    H.add_subspace(sub)
    return H, sub


def _planes(dim, seed):
    v = np.random.RandomState(seed).standard_normal((2, dim))
    return v / np.linalg.norm(v)


def _spawn(case, world, tmp_path, device='cpu', timeout=180):
    """Run ``case`` on ``world`` ranks (gloo on the CPU; NCCL, one GPU per
    rank, with ``device='cuda'``); returns the per-rank JSON records (rank 0
    also leaves its arrays in tmp_path)."""
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
               OPENBLAS_NUM_THREADS='1', GLOO_SOCKET_IFNAME='lo')
    store = tmp_path / 'store'
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         str(store), str(tmp_path), device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} of {world} failed:\n{out}'
    return [json.loads((tmp_path / f'rank{r}.json').read_text())
            for r in range(world)]


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(autouse=True)
def one_blas_thread():
    """numpy's BLAS at one thread in the parent, as the ranks run torch:
    CPU-heavy tests beside the JAX package's collectives overload the
    machine (ROADMAP.md queue 3)."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(limits=1, user_api='blas'):
        yield


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('space', ['full', 'even'])
def test_dot_norms_and_states(space, world, tmp_path):
    """H.dot, infinity_norm, State.dot/norm, set_product on the owning
    rank, and gathered to_numpy (to_all True and False)."""
    H, sub = _model('dynamite_tpu_torch', space)
    dim = sub.get_dimension()
    v = _planes(dim, seed=1)
    np.save(tmp_path / 'v.npy', v)
    recs = _spawn('dot_' + space, world, tmp_path)

    x = v[0] + 1j * v[1]
    want = H.to_numpy() @ x
    assert _rel(np.load(tmp_path / 'hv.npy'), want) < 1e-12
    rec = recs[0]
    assert rec['inf_norm'] == pytest.approx(H._infinity_norm_host(),
                                            rel=1e-12)
    assert complex(*rec['vdot']) == pytest.approx(np.vdot(x, want),
                                                  rel=1e-12)
    assert rec['norm'] == pytest.approx(np.linalg.norm(x), rel=1e-12)
    assert all(r == rec for r in recs)

    # set_product: only the owning rank holds the 1
    idx = int(sub.state_to_idx(5))
    owner = idx // (dim // world)
    for r, got in enumerate(np.load(tmp_path / 'product_local.npy')):
        assert got == (1.0 if r == owner else 0.0)
    product = np.load(tmp_path / 'product.npy')
    assert np.flatnonzero(product).tolist() == [idx]
    assert product[idx] == 1


def test_rdm_gathered_to_rank0(tmp_path):
    """The RDM and entropy of a state whose rows lie on 2 ranks: rank 0
    computes them from the gathered rows, and every rank gets its result."""
    from dynamite_tpu_torch.computations import dm_entanglement_entropy
    from dynamite_tpu_torch.ops.rdm import rdm_from_full_vector
    H, sub = _model('dynamite_tpu_torch', 'even')
    v = _planes(sub.get_dimension(), seed=4)
    np.save(tmp_path / 'v.npy', v)
    recs = _spawn('rdm', 2, tmp_path)

    full = np.zeros(1 << sub.L, dtype=np.complex128)
    full[sub.idx_to_state(np.arange(sub.get_dimension()))] = v[0] + 1j * v[1]
    want = rdm_from_full_vector(full, (0, 2, 5), sub.L)
    assert np.max(np.abs(np.load(tmp_path / 'rho.npy') - want)) < 1e-12
    assert recs[0]['entropy'] == pytest.approx(
        dm_entanglement_entropy(want), abs=1e-12)
    assert all(r == recs[0] for r in recs)


@pytest.mark.parametrize('world', [2, 4])
def test_evolve(world, tmp_path):
    from scipy.sparse.linalg import expm_multiply
    import jax.numpy as jnp
    from dynamite_tpu.solvers.expmv import expmv as ref_expmv

    H, sub = _model('dynamite_tpu_torch', 'full')
    v = _planes(sub.get_dimension(), seed=2)
    np.save(tmp_path / 'v.npy', v)
    recs = _spawn('evolve', world, tmp_path)

    got = np.load(tmp_path / 'evolved.npy')
    x = v[0] + 1j * v[1]
    oracle = expm_multiply(-1j * H.to_numpy(), x)
    assert np.linalg.norm(got - oracle) < 1e-10
    H_ref, _s = _model('dynamite_tpu', 'full')
    kernel = H_ref.get_mat()
    w = np.asarray(ref_expmv(kernel.krylov_ops(30), jnp.asarray(v), -1j,
                             H_ref.infinity_norm(), ncv=30, tol=1e-12))
    assert np.linalg.norm(got - (w[0] + 1j * w[1])) < 1e-10
    # every rank took the same host decisions
    assert all(r['stats'] == recs[0]['stats'] for r in recs)
    assert recs[0]['stats']['substeps'] >= 1


@pytest.mark.parametrize('world', [2, 4])
def test_eigsolve(world, tmp_path):
    from dynamite_tpu import config as ref_config
    from dynamite_tpu.parallel.mesh import make_mesh

    H, sub = _model('dynamite_tpu_torch', 'full')
    recs = _spawn('eigsolve', world, tmp_path)
    got = np.asarray(recs[0]['evals'])
    exact = np.linalg.eigvalsh(H.to_numpy().toarray())[:2]
    assert np.allclose(got[:2], exact, rtol=1e-10, atol=0)
    assert max(recs[0]['residuals']) < 1e-8
    assert all(r['evals'] == recs[0]['evals'] and r['stats'] ==
               recs[0]['stats'] for r in recs)

    # the JAX package's sharded eigsolve on its virtual mesh of as many
    # devices (tests/integration/test_sharded.py::test_sharded_eigsolve)
    saved = ref_config.mesh
    try:
        ref_config._L = None
        ref_config._subspace = None
        ref_config._mesh = make_mesh(mesh_shape=(world,))
        H_ref, sub_ref = _model('dynamite_tpu', 'full')
        assert H_ref.get_mat(subspaces=(sub_ref, sub_ref)).sharded_default()
        want = H_ref.eigsolve(nev=2, subspace=sub_ref)
    finally:
        ref_config._mesh = saved
    assert np.allclose(got[:2], want[:2], rtol=1e-10, atol=0)


def test_target_eigsolve(tmp_path):
    """eigsolve(target=) by MINRES shift-invert on 2 ranks: the inner
    solves' reductions and the extract's Grams are summed over ranks, so
    the pair equals one process's to 1e-10, every rank takes the same
    decisions, and the eigenvectors' residuals stay below 1e-8."""
    H, sub = _model('dynamite_tpu_torch', 'full')
    exact = np.linalg.eigvalsh(H.to_numpy().toarray())
    target = float(0.7 * exact[2] + 0.3 * exact[3])
    np.save(tmp_path / 'target.npy', np.array([target]))
    recs = _spawn('target', 2, tmp_path)
    one = np.sort(H.eigsolve(nev=2, target=target))
    got = np.sort(recs[0]['evals'])
    assert np.allclose(got, one, rtol=1e-10, atol=0)
    assert np.allclose(got, np.sort(exact[np.argsort(np.abs(exact - target))
                                          [:2]]), rtol=1e-10, atol=0)
    assert max(recs[0]['residuals']) < 1e-8
    assert recs[0]['stats']['minres_iterations'] > 0
    assert all(r == recs[0] for r in recs)


@pytest.mark.parametrize('world', [2, 4])
def test_operator_differing_by_rank_raises(world, tmp_path):
    recs = _spawn('crc', world, tmp_path)
    assert all('inconsistent across ranks' in r['error'] for r in recs)


# the general routes over ranks: (model, subspace, the port's config, the
# route every rank must take). SpinConserve(8, 4) and Auto of localized(8)
# have 70 rows, so 3 and 4 ranks pad; Full(8) over 3 ranks leaves the XOR
# route.
GENERAL = {
    'sector_ring': ('sc', {}, 'sector_ring'),
    'ell': ('sc', {'use_sector': False}, 'ell'),
    'auto': ('auto', {}, 'ell'),
    'full': ('full', {}, 'ell'),
    'sweep_ring': ('sc', {'use_sector': False, 'use_ell': False,
                          'sharded_ring_general': True}, 'sweep_ring'),
}


def _general_cases(world):
    return [c for c in GENERAL if c != 'full' or world == 3]


def _general_model(pkg, space):
    import importlib
    models = importlib.import_module(pkg + '.models')
    subspaces = importlib.import_module(pkg + '.subspaces')
    H = models.localized(L)
    sub = {'sc': lambda: subspaces.SpinConserve(L, L // 2),
           'auto': lambda: subspaces.Auto(H, 'U' * (L // 2) + 'D' * (L // 2)),
           'full': lambda: subspaces.Full(L=L)}[space]()
    H.add_subspace(sub)
    return H, sub


def _jax_sharded_dot(space, world, v):
    """The JAX package's sharded apply of the same operator on its virtual
    mesh of ``world`` devices (tests/integration/test_sharded.py), through
    its sharded ELL tables: its alpha ring and sweeps compute the same
    product, but take 15-140 s to compile here."""
    import jax.numpy as jnp
    from dynamite_tpu import config as ref_config
    from dynamite_tpu.parallel.mesh import device_put_state, make_mesh
    saved = ref_config.mesh
    try:
        ref_config._L = None
        ref_config._subspace = None
        ref_config._mesh = make_mesh(mesh_shape=(world,))
        ref_config.use_sector = False
        H, sub = _general_model('dynamite_tpu', space)
        kernel = H.get_mat(subspaces=(sub, sub))
        dim = sub.get_dimension()
        x = device_put_state(jnp.asarray(v), ref_config.mesh, dim)
        y = np.asarray(kernel.traceable(sharded=True)(x))[:, :dim]
    finally:
        ref_config._mesh = saved
        ref_config.use_sector = True
    return y[0] + 1j * y[1]


@pytest.mark.parametrize('world', [2, 3, 4])
def test_general_routes(world, tmp_path):
    """H.dot, evolve and eigsolve through each general route over ranks
    (one spawn runs every case of ``_general_cases``): the route on every
    rank, the pad rows 0 after every apply and solve, the dot within 1e-12
    of msc_to_matrix and of the JAX package's sharded apply, evolve within
    1e-10 of expm_multiply, eigenvalues within 1e-10 of eigvalsh, every
    rank taking the same decisions, and the tables' bytes over the ranks,
    asked on rank 0 alone, the sum of what each rank holds."""
    from scipy.sparse.linalg import expm_multiply
    v = _planes(70, seed=5)
    np.save(tmp_path / 'v.npy', v)
    recs = _spawn('general', world, tmp_path)
    x = v[0] + 1j * v[1]
    for case in _general_cases(world):
        space, _settings, route = GENERAL[case]
        H, sub = _general_model('dynamite_tpu_torch', space)
        ranks = [r[case] for r in recs]
        assert all(r['engine'] == route for r in ranks), case
        assert all(r['pads_zero'] for r in ranks), case
        keys = ('engine', 'conserves', 'evals', 'stats')
        assert all(all(r[k] == ranks[0][k] for k in keys) for r in ranks)
        assert ranks[0]['table_bytes'] == sum(r['own_bytes']
                                              for r in ranks), case
        assert (ranks[0]['table_bytes'] > 0) == (route != 'sweep_ring')
        M = H.to_numpy()
        xc = x if space != 'full' else _planes(256, seed=6)
        if space == 'full':
            xc = xc[0] + 1j * xc[1]
        got = np.load(tmp_path / f'{case}_hv.npy')
        assert _rel(got, M @ xc) < 1e-12, case
        ref = _jax_sharded_dot(space, world, np.stack([xc.real, xc.imag]))
        assert _rel(got, ref) < 1e-12, case
        oracle = expm_multiply(-1j * 0.5 * M, xc)
        evolved = np.load(tmp_path / f'{case}_evolved.npy')
        assert np.linalg.norm(evolved - oracle) < 1e-10, case
        exact = np.linalg.eigvalsh(M.toarray())[:2]
        assert np.allclose(ranks[0]['evals'], exact, rtol=1e-10, atol=0)
        assert max(ranks[0]['residuals']) < 1e-8, case


def test_one_process_helpers_are_no_ops():
    """Without a process group: world size 1, rank 0, one block holding
    every row, and every collective returns its input."""
    import torch
    from dynamite_tpu_torch.parallel import mesh, multihost
    assert not multihost.is_initialized()
    assert (multihost.rank(), multihost.world_size()) == (0, 1)
    v = np.arange(4.0)
    assert multihost.broadcast_from_host0(v) is v
    assert multihost.allgather_host_values(v).shape == (1, 4)
    t = torch.arange(3.0)
    assert multihost.allreduce_sum_(t) is t and multihost.allreduce_max_(t) is t
    assert multihost.gather_rows(t) is t and multihost.rank_seed(7) == 7
    multihost.barrier()
    assert (mesh.local_dim(256), mesh.row0(256), mesh.device_bits(256)) == \
        (256, 0, 0)
    planes = np.zeros((2, 256))
    assert mesh.local_rows(planes, 256).shape == (2, 256)


@pytest.mark.parametrize('dim,world', [(256, 3), (256, 6), (4, 8)])
def test_layouts_the_xor_path_cannot_take(dim, world):
    from dynamite_tpu_torch.parallel import mesh
    with pytest.raises(NotImplementedError,
                       match='general all-gather sharded path'):
        mesh._check(dim, world)


# the XOR route's new pairs: (model, L, parent space) of the XParity cases,
# (syk n, space, L) of the SYK cases (both of dimension 2**12, the XOR-dense
# engine's minimum)
XPARITY = {'xfull8': ('localized', 8, 'full'),
           'xeven10': ('heisenberg', 10, 'even')}
SYK = {'syk_full12': (12, 'full', 12), 'syk_even13': (11, 'even', 13)}


def _parent_sub(subspaces, space, L):
    return {'full': lambda: subspaces.Full(L=L),
            'even': lambda: subspaces.Parity('even', L=L),
            'sc': lambda: subspaces.SpinConserve(L, L // 2)}[space]()


def _xparity_model(pkg, name, sector):
    """An XParity case in one package; localized's Z fields do not commute
    with the global flip, so it is projected."""
    import importlib
    models = importlib.import_module(pkg + '.models')
    subspaces = importlib.import_module(pkg + '.subspaces')
    model, L, space = XPARITY[name]
    H = getattr(models, model)(L)
    H.allow_projection = True
    sub = subspaces.XParity(_parent_sub(subspaces, space, L), sector)
    H.add_subspace(sub)
    return H, sub


def _syk_model(pkg, name, seed=0):
    import importlib
    models = importlib.import_module(pkg + '.models')
    subspaces = importlib.import_module(pkg + '.subspaces')
    n, space, L = SYK[name]
    H = models.syk(n, seed=seed)
    sub = _parent_sub(subspaces, space, L)
    H.add_subspace(sub)
    return H, sub


def _one_device_ref():
    """The JAX package on a mesh of one device (its 8-device virtual mesh
    is a suite hazard, ROADMAP.md queue 3): a context for its references."""
    import contextlib
    from dynamite_tpu import config as ref_config
    from dynamite_tpu.parallel.mesh import make_mesh

    @contextlib.contextmanager
    def one():
        saved = ref_config.mesh
        try:
            ref_config._L = None
            ref_config._subspace = None
            ref_config._mesh = make_mesh(mesh_shape=(1,))
            yield
        finally:
            ref_config._mesh = saved
            ref_config._L = None
            ref_config._subspace = None
    return one()


@pytest.mark.parametrize('world', [2, 4])
def test_xor_route_over_ranks(world, tmp_path):
    """XParity pairs over Full and Parity, both sectors, and SYK past the
    XOR kernel's tables, over ``world`` ranks: XParity takes the XOR route
    (its dot, evolve and eigsolve against the JAX package on one device
    and numpy/scipy), SYK the XOR-dense engine's per-rank apply (its dot
    against the port's one-device engine and the JAX package's apply), and
    every rank takes the same route, split and decisions."""
    import jax
    import jax.numpy as jnp
    import torch
    from scipy.sparse.linalg import expm_multiply
    from dynamite_tpu.solvers.expmv import expmv as ref_expmv
    for name in XPARITY:
        _H, sub = _xparity_model('dynamite_tpu_torch', name, '+')
        np.save(tmp_path / f'{name}_v.npy', _planes(sub.get_dimension(),
                                                    seed=8))
    np.save(tmp_path / 'syk_v.npy', _planes(4096, seed=9))
    recs = _spawn('xor_route', world, tmp_path)
    for key in recs[0]:
        assert all(r[key] == recs[0][key] for r in recs), key

    for name in XPARITY:
        for sector in '+-':
            key = name + sector
            rec = recs[0][key]
            assert rec['engine'] == 'xor', key
            H, sub = _xparity_model('dynamite_tpu_torch', name, sector)
            v = np.load(tmp_path / f'{name}_v.npy')
            x = v[0] + 1j * v[1]
            M = H.to_numpy()
            got = np.load(tmp_path / f'{key}_hv.npy')
            assert _rel(got, M @ x) < 1e-12, key
            evolved = np.load(tmp_path / f'{key}_evolved.npy')
            assert np.linalg.norm(evolved - expm_multiply(-1j * M, x)) \
                < 1e-10, key
            lowest = np.sort(rec['evals'])[:2]
            exact = np.linalg.eigvalsh(M.toarray())[:2]
            assert np.allclose(lowest, exact, rtol=1e-10, atol=0), key
            with _one_device_ref():
                H_ref, s_ref = _xparity_model('dynamite_tpu', name, sector)
                kernel = H_ref.get_mat(subspaces=(s_ref, s_ref))
                y = np.asarray(jax.jit(kernel.traceable(sharded=False))(v))
                assert _rel(got, y[0] + 1j * y[1]) < 1e-12, key
                w = np.asarray(ref_expmv(kernel.krylov_ops(30),
                                         jnp.asarray(v), -1j,
                                         H_ref.infinity_norm(), ncv=30,
                                         tol=1e-12))
                assert np.linalg.norm(evolved - (w[0] + 1j * w[1])) \
                    < 1e-10, key
                want = H_ref.eigsolve(nev=2, subspace=s_ref)
            assert np.allclose(lowest, np.sort(want)[:2], rtol=1e-10,
                               atol=0), key

    v = np.load(tmp_path / 'syk_v.npy')
    local_bits = 12 - (world.bit_length() - 1)
    for name in SYK:
        rec = recs[0][name]
        assert rec['engine'] == 'xor_dense' and rec['La'] <= local_bits
        H, sub = _syk_model('dynamite_tpu_torch', name)
        got = np.load(tmp_path / f'{name}_hv.npy')
        one = H.get_mat().apply(torch.as_tensor(v)).numpy()
        assert _rel(got, one[0] + 1j * one[1]) < 1e-12, name
        with _one_device_ref():
            H_ref, s_ref = _syk_model('dynamite_tpu', name)
            kernel = H_ref.get_mat(subspaces=(s_ref, s_ref))
            y = np.asarray(jax.jit(kernel.traceable(sharded=False))(v))
        assert _rel(got, y[0] + 1j * y[1]) < 1e-12, name


def test_syk_differing_by_rank_raises(tmp_path):
    """An SYK operator drawn with a seed of each rank's own raises on
    every rank before any route is chosen: the XOR-dense engine's split
    and layout come from the operator, the same on every rank."""
    recs = _spawn('crc_syk', 2, tmp_path)
    assert all('inconsistent across ranks' in r['error'] for r in recs)


# state files and conversions over ranks: the saved spaces (Full(8) pads at
# 3 ranks, SpinConserve(8, 4) at 3 and 4) and the XParity parents
FILE_SPACES = ('full', 'sc')
CONVERT = ('full', 'even', 'sc')


def _files_inputs(tmp_path, other_save):
    """The inputs of the rank case 'files', made by the port on one
    process: each saved space's vector and its one-process save, a file of
    it saved by ``other_save(space, v, fname)``, and for each XParity
    parent and sector the two input vectors and their one-process
    conversions."""
    import torch
    from dynamite_tpu_torch import subspaces
    from dynamite_tpu_torch.states import State
    for i, space in enumerate(FILE_SPACES):
        sub = _parent_sub(subspaces, space, L)
        v = _planes(sub.get_dimension(), seed=20 + i)
        np.save(tmp_path / f'{space}_v.npy', v)
        one = State(subspace=sub)
        one.set_planes(v)
        one.save(str(tmp_path / f'one_{space}'))
        other_save(space, v, str(tmp_path / f'other_{space}'))
    for i, space in enumerate(CONVERT):
        for sector in '+-':
            xp = subspaces.XParity(_parent_sub(subspaces, space, L), sector)
            pv = _planes(xp.parent.get_dimension(), seed=30 + i)
            cv = _planes(xp.get_dimension(), seed=40 + i)
            np.save(tmp_path / f'{space}{sector}_pv.npy', pv)
            np.save(tmp_path / f'{space}{sector}_cv.npy', cv)
            p_state, c_state = State(subspace=xp.parent), State(subspace=xp)
            p_state.set_planes(pv)
            c_state.set_planes(cv)
            for name, out in (('to_child', xp.convert_state(p_state)),
                              ('to_parent', xp.convert_state(c_state))):
                np.save(tmp_path / f'{space}{sector}_{name}.npy',
                        out.data.to('cpu', torch.float64).numpy())


@pytest.mark.parametrize('world', [2, 3, 4])
def test_state_files_and_convert_over_ranks(world, tmp_path):
    """``State.save`` from the ranks writes, byte for byte, the files of a
    one-process save of the gathered vector (and the JAX package's
    ``.vec``); the JAX package reads them; ``State.from_file`` gives each
    rank its rows, bitwise, pads 0, of the ranks' file and of one the JAX
    package saved; ``XParity.convert_state`` on Full(8), Parity('even',
    L=8) and SpinConserve(8, 4) parents, both sectors, both ways, gives
    each rank its rows of one process's conversion, bitwise, pads 0, and
    the gathered results agree with the JAX package's conversion."""
    from dynamite_tpu import subspaces as ref_subspaces
    from dynamite_tpu.states import State as RefState

    def jax_save(space, v, fname):
        with _one_device_ref():
            ref = RefState(subspace=_parent_sub(ref_subspaces, space, L))
            ref.set_all_numpy(v[0] + 1j * v[1])
            ref.save(fname)

    _files_inputs(tmp_path, jax_save)
    recs = _spawn('files', world, tmp_path)
    for r in recs:
        assert all(r.values()), [k for k, ok in r.items() if not ok]
        assert len(r) == 3 * len(FILE_SPACES) + 8 * len(CONVERT)

    for space in FILE_SPACES:
        for ext in ('.vec', '.metadata'):
            assert (tmp_path / f'ranks_{space}{ext}').read_bytes() == \
                (tmp_path / f'one_{space}{ext}').read_bytes(), space + ext
        assert (tmp_path / f'ranks_{space}.vec').read_bytes() == \
            (tmp_path / f'other_{space}.vec').read_bytes(), space
        v = np.load(tmp_path / f'{space}_v.npy')
        with _one_device_ref():
            loaded = RefState.from_file(str(tmp_path / f'ranks_{space}'))
            assert loaded.subspace == _parent_sub(ref_subspaces, space, L)
            assert np.array_equal(loaded.to_numpy(), v[0] + 1j * v[1])
    for space in CONVERT:
        for sector in '+-':
            key = f'{space}{sector}'
            with _one_device_ref():
                xp = ref_subspaces.XParity(
                    _parent_sub(ref_subspaces, space, L), sector)
                for src, vname, to in ((xp.parent, 'pv', 'to_child'),
                                       (xp, 'cv', 'to_parent')):
                    v = np.load(tmp_path / f'{key}_{vname}.npy')
                    psi = RefState(subspace=src)
                    psi.set_all_numpy(v[0] + 1j * v[1])
                    want = xp.convert_state(psi).to_numpy()
                    got = np.load(tmp_path / f'{key}_{to}_ranks.npy')
                    assert np.max(np.abs(got - want)) < 1e-14, (key, to)


def test_multiprocess_contracts(tmp_path):
    """The port's mirror of tests/integration/test_multiprocess.py on 2
    gloo ranks (its worker's three contracts): an unseeded random state is
    the same on every rank (rank 0's seed broadcast; a CRC of the gathered
    vector, all-gathered), evolve of heisenberg(10) from the Neel state at
    t = 0.3 matches scipy's expm_multiply within 1e-8, a save from the
    ranks is read back by ``from_file`` on every rank, and every rank
    passes ``barrier('done')``, as the worker ends."""
    recs = _spawn('mirror', 2, tmp_path)
    assert recs[0]['crc'] == recs[1]['crc']
    assert all(r['evolve_err'] < 1e-8 and r['reloaded'] for r in recs)
    assert all(r['done'] for r in recs)


# -- the rank processes ---------------------------------------------------


def _rank_main(case, rank, world, store, out_dir, device):
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.parallel import multihost
    from dynamite_tpu_torch.states import State

    config.device = device
    multihost.initialize(rank=rank, world_size=world,
                         init_method='file://' + store)
    assert 'jax' not in sys.modules and 'dynamite_tpu' not in sys.modules
    rec = {}

    def save(name, arr):
        if rank == 0:
            np.save(os.path.join(out_dir, name), arr)

    def load(name):
        return np.load(os.path.join(out_dir, name))

    def state(sub, planes):
        psi = State(subspace=sub)
        psi.set_planes(planes)
        return psi

    if case.startswith('dot_'):
        H, sub = _model('dynamite_tpu_torch', case[4:])
        psi = state(sub, load('v.npy'))
        hpsi = H.dot(psi)
        save('hv.npy', hpsi.to_numpy())
        gathered = hpsi.to_numpy(to_all=False)
        assert (gathered is None) == (rank != 0)
        rec['inf_norm'] = H.infinity_norm()
        z = psi.dot(hpsi)
        rec['vdot'] = [z.real, z.imag]
        rec['norm'] = psi.norm()
        prod = State(state=5, subspace=sub)
        local = float(prod.data.abs().sum())
        sums = multihost.allgather_host_values(np.array([local]))
        save('product_local.npy', sums[:, 0])
        save('product.npy', prod.to_numpy().real)
    elif case == 'rdm':
        from dynamite_tpu_torch import computations
        H, sub = _model('dynamite_tpu_torch', 'even')
        psi = state(sub, load('v.npy'))
        rho = computations.reduced_density_matrix(psi, (0, 2, 5))
        save('rho.npy', rho)
        rec['rho_digest'] = float(np.abs(rho).sum())
        rec['entropy'] = float(computations.entanglement_entropy(psi,
                                                                (0, 2, 5)))
    elif case == 'evolve':
        from dynamite_tpu_torch import computations
        H, sub = _model('dynamite_tpu_torch', 'full')
        out = H.evolve(state(sub, load('v.npy')), t=1.0, tol=1e-12)
        save('evolved.npy', out.to_numpy())
        rec['stats'] = {k: v for k, v in computations.last_solve_stats.items()
                        if not k.endswith('_s')}
    elif case == 'eigsolve':
        from dynamite_tpu_torch import computations
        H, sub = _model('dynamite_tpu_torch', 'full')
        evals, evecs = H.eigsolve(nev=2, getvecs=True)
        rec['evals'] = [float(e) for e in evals]
        rec['residuals'] = []
        for lam, v in zip(evals, evecs):
            r = H.dot(v)
            r.axpy(-lam, v)
            rec['residuals'].append(r.norm() / abs(lam))
        rec['stats'] = {k: v for k, v in computations.last_solve_stats.items()
                        if not k.endswith('_s')}
    elif case == 'target':
        from dynamite_tpu_torch import computations
        H, sub = _model('dynamite_tpu_torch', 'full')
        target = float(load('target.npy')[0])
        evals, evecs = H.eigsolve(nev=2, target=target, getvecs=True)
        rec['evals'] = [float(e) for e in evals]
        rec['residuals'] = []
        for lam, v in zip(evals, evecs):
            r = H.dot(v)
            r.axpy(-lam, v)
            rec['residuals'].append(r.norm())
        rec['stats'] = {k: v for k, v in computations.last_solve_stats.items()
                        if not k.endswith('_s')}
    elif case == 'crc':
        # a random field drawn with a seed of each rank's own
        from dynamite_tpu_torch.models import localized
        from dynamite_tpu_torch.subspaces import Full
        H, sub = localized(L, seed=rank), Full(L=L)
        H.add_subspace(sub)
        try:
            H.get_mat(subspaces=(sub, sub))
            rec['error'] = ''
        except RuntimeError as err:
            rec['error'] = str(err)
    elif case == 'general':
        from dynamite_tpu_torch import computations
        from dynamite_tpu_torch.parallel import mesh
        for name in _general_cases(world):
            space, settings, _route = GENERAL[name]
            saved = {k: getattr(config, k) for k in settings}
            for k, val in settings.items():
                setattr(config, k, val)
            H, sub = _general_model('dynamite_tpu_torch', space)
            dim = sub.get_dimension()
            keep = mesh.valid_rows(dim)

            def pads_zero(psi):
                return bool((psi.data[:, keep:] == 0).all())

            one = rec[name] = {}
            v = load('v.npy') if space != 'full' else _planes(256, seed=6)
            psi = state(sub, v)
            hpsi = H.dot(psi)
            kernel = H.get_mat(subspaces=(sub, sub))
            one['engine'] = kernel.engine
            one['conserves'] = kernel.conserves_hint
            dtype = config.real_dtype
            one['own_bytes'] = (
                0 if kernel.sharded is None
                else kernel.sharded.tables[rank].nbytes(dtype, config.device)
                if kernel.engine == 'ell'
                else kernel.sharded.table_bytes(rank, dtype, config.device))
            if rank == 0:
                # on one rank alone: a collective in it would hang
                one['table_bytes'] = H._engine_table_bytes(world)
            save(f'{name}_hv.npy', hpsi.to_numpy())
            out = H.evolve(psi, t=0.5, tol=1e-12)
            save(f'{name}_evolved.npy', out.to_numpy())
            evals, evecs = H.eigsolve(nev=2, getvecs=True)
            one['evals'] = [float(e) for e in evals]
            one['stats'] = {k: v for k, v in
                            computations.last_solve_stats.items()
                            if not k.endswith('_s')}
            one['residuals'] = []
            ok = pads_zero(psi) and pads_zero(hpsi) and pads_zero(out)
            for lam, vec in zip(evals, evecs):
                ok = ok and pads_zero(vec)
                r = H.dot(vec)
                r.axpy(-lam, vec)
                one['residuals'].append(r.norm() / abs(lam))
            one['pads_zero'] = ok
            for k, val in saved.items():
                setattr(config, k, val)
    elif case == 'xor_route':
        from dynamite_tpu_torch import computations
        for name in XPARITY:
            for sector in '+-':
                H, sub = _xparity_model('dynamite_tpu_torch', name, sector)
                key = name + sector
                psi = state(sub, load(f'{name}_v.npy'))
                save(f'{key}_hv.npy', H.dot(psi).to_numpy())
                out = H.evolve(psi, t=1.0, tol=1e-12)
                save(f'{key}_evolved.npy', out.to_numpy())
                evals = H.eigsolve(nev=2)
                rec[key] = {
                    'engine': H.get_mat().engine,
                    'evals': [float(e) for e in evals],
                    'stats': {k: v for k, v in
                              computations.last_solve_stats.items()
                              if not k.endswith('_s')}}
        for name in SYK:
            H, sub = _syk_model('dynamite_tpu_torch', name)
            psi = state(sub, load('syk_v.npy'))
            save(f'{name}_hv.npy', H.dot(psi).to_numpy())
            k = H.get_mat()
            lay = k.xor_dense.layout(
                (k.plan.dim_right // world).bit_length() - 1)
            rec[name] = {'engine': k.engine, 'La': k.xor_dense.La,
                         'hi_list': lay.hi_list,
                         'channels': k.xor_dense.channels}
    elif case == 'crc_syk':
        H, sub = _syk_model('dynamite_tpu_torch', 'syk_full12', seed=rank)
        try:
            H.get_mat(subspaces=(sub, sub))
            rec['error'] = ''
        except RuntimeError as err:
            rec['error'] = str(err)
    elif case == 'files':
        import torch
        from dynamite_tpu_torch import subspaces
        from dynamite_tpu_torch.parallel import mesh

        def mine(name, dim):
            """This rank's rows of a one-process (2, dim) result."""
            return mesh.local_rows(torch.as_tensor(load(name)), dim)

        for space in FILE_SPACES:
            sub = _parent_sub(subspaces, space, L)
            dim = sub.get_dimension()
            psi = state(sub, load(f'{space}_v.npy'))
            fname = os.path.join(out_dir, f'ranks_{space}')
            psi.save(fname)
            back = State.from_file(fname).data.cpu()
            want = mine(f'{space}_v.npy', dim)
            rec[f'{space}_saved_loaded'] = torch.equal(back, want)
            keep = mesh.valid_rows(dim)
            rec[f'{space}_pads_zero'] = bool((back[:, keep:] == 0).all())
            # a file another writer saved (the JAX package in the CPU test)
            other = State.from_file(os.path.join(out_dir, f'other_{space}'))
            rec[f'{space}_other_loaded'] = torch.equal(other.data.cpu(),
                                                       want)
        for space in CONVERT:
            for sector in '+-':
                key = f'{space}{sector}'
                xp = subspaces.XParity(_parent_sub(subspaces, space, L),
                                       sector)
                pdim, cdim = xp.parent.get_dimension(), xp.get_dimension()
                child = xp.convert_state(state(xp.parent,
                                               load(f'{key}_pv.npy')))
                parent = xp.convert_state(state(xp, load(f'{key}_cv.npy')))
                back = xp.convert_state(parent)
                rec[f'{key}_to_child'] = torch.equal(
                    child.data.cpu(), mine(f'{key}_to_child.npy', cdim))
                rec[f'{key}_to_parent'] = torch.equal(
                    parent.data.cpu(), mine(f'{key}_to_parent.npy', pdim))
                rec[f'{key}_pads_zero'] = bool(
                    (child.data[:, mesh.valid_rows(cdim):] == 0).all()
                    and (parent.data[:, mesh.valid_rows(pdim):] == 0).all())
                # to the parent and back is the identity
                rec[f'{key}_round_trip'] = bool(torch.allclose(
                    back.data.cpu(), mine(f'{key}_cv.npy', cdim), rtol=0,
                    atol=1e-14))
                save(f'{key}_to_child_ranks.npy', child.to_numpy())
                save(f'{key}_to_parent_ranks.npy', parent.to_numpy())
    elif case == 'mirror':
        import zlib
        from scipy.sparse.linalg import expm_multiply
        from dynamite_tpu_torch.models import heisenberg
        n = 10
        config.L = n
        v = State(state='random').to_numpy()
        rec['crc'] = zlib.crc32(v.tobytes())
        crcs = multihost.allgather_host_values(np.asarray([rec['crc']]))
        assert np.all(crcs == crcs[0]), f'divergent random states: {crcs}'
        H = heisenberg(n)
        s0 = State(state='U' * (n // 2) + 'D' * (n - n // 2))
        out = H.evolve(s0, 0.3)
        got = out.to_numpy()
        want = expm_multiply(-1j * 0.3 * H.to_numpy(), s0.to_numpy())
        rec['evolve_err'] = float(np.abs(got - want).max())
        fname = os.path.join(out_dir, 'state.dnm')
        out.save(fname)
        loaded = State.from_file(fname)
        rec['reloaded'] = bool(np.allclose(loaded.to_numpy(), got,
                                           atol=1e-12))
        # the worker's last step, a named barrier
        multihost.barrier('done')
        rec['done'] = True
    else:
        raise ValueError(case)

    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(rec, f)
    multihost.barrier()
    multihost.shutdown()


if __name__ == '__main__':
    _case, _rank, _world, _store, _out, _device = sys.argv[1:]
    _rank_main(_case, int(_rank), int(_world), _store, _out, _device)
