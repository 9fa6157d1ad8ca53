"""
Every card of one host from unchanged code, on the CPU: gloo ranks stand
in for the cards, one thread a rank.

* Random states no longer depend on the world size:
  ``State(state='random', seed=s)`` and ``solvers.eigs.random_start`` at
  world 1, 2 and 3 on Full(10) and SpinConserve(13, 4) (dimension 715,
  padded at 2 and 3), gathered by ``to_numpy()`` / ``gather_rows``: the
  draw before normalization bitwise equal to world 1's, the normalized
  vector within 1e-15 of it relative to its largest entry (the norm's sum
  over ranks rounds in another order), pad rows 0. The draw itself against
  a numpy SplitMix64 + Box-Muller oracle (1e-15 relative).
* The ranks of those runs are started with a launcher's environment only
  (torchrun's variables, no ``initialize()`` call) and must join the group
  at their first use of the port; each also checks the host values a
  script reads on every rank (eigenvalues, ``last_solve_stats``,
  ``MaxIterationsError`` on every rank, ``get_memory_usage`` by rank, node
  and all, ``MPI_COMM_WORLD``), ``config.initialize(mesh_shape=)``, and
  that ``Operator.save`` and ``State.save`` do not overwrite a file that
  another rank is still reading (rank 1 reads late).
* The switch over 2 gloo ranks against 1 (``--device cpu --cards 2``,
  every run a subprocess, all started together): floquet at L=12 (6
  cycles; and 4 cycles with a checkpoint every 2, resumed to 6), kagome
  '12', notebook 2-States (seeded random states) and ``--pytest`` over
  ``unit/test_states.py`` (its ``tmp_path`` round trip),
  ``integration/test_states.py`` and ``integration/test_evolve.py``. The
  physics numbers agree within 1e-10 relative (+1e-12), the output is
  printed once, the pytest counts are one process's.
* A run fails as one process: a test that fails on one rank only fails on
  every rank, naming the ranks; a script that raises on rank 1 while rank
  0 hangs ends non-zero within 60 s with rank 1's error shown and no rank
  left running.
* ``config.initialize(platform='cpu')`` and its refusals in one process.
* The first use that joins no group, each in a child process: ``python
  script.py`` inside an ``sbatch`` job (a SLURM batch step, with and
  without ``-n 4`` and ``MASTER_ADDR``) runs as one process and waits for
  no rank; a step that lacks ``SLURM_NTASKS`` runs as one process with a
  warning, and an explicit ``initialize()`` raises on it; and
  ``multihost.initialize()`` followed by
  ``config.initialize(precision='single')``, as the JAX package's driver
  does, sets single precision.
* The draw past ATen's parallel grain: each rank's rows on one thread
  against world 1's on four, bitwise.

A rank runs this file as a script (see the bottom) and imports neither JAX
nor ``tests/conftest.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, 'examples', 'scripts')
SEED = 1234
SPACES = ('full10', 'sc13')
RTOL, ATOL = 1e-10, 1e-12
LAUNCH_VARS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
               'GROUP_RANK', 'MASTER_ADDR', 'MASTER_PORT', 'SLURM_PROCID',
               'OMPI_MCA_orte_hnp_uri', 'NCCL_HOSTID')


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.pop('XLA_FLAGS', None)
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
               OPENBLAS_NUM_THREADS='1', GLOO_SOCKET_IFNAME='lo',
               PYTEST_DISABLE_PLUGIN_AUTOLOAD='1', **extra)
    return env


def _space(name):
    from dynamite_tpu_torch.subspaces import Full, SpinConserve
    return Full(L=10) if name == 'full10' else SpinConserve(13, 4)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


# -- the draw -------------------------------------------------------------


def _oracle(seed, dim):
    """SplitMix64 (counters 2g + 1, 2g + 2 from the mixed seed) and
    Box-Muller in numpy's uint64 and float64."""
    with np.errstate(over='ignore'):
        def mix(z):
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            return z ^ (z >> np.uint64(31))
        key = mix(np.array([seed], dtype=np.uint64))[0]
        gamma = np.uint64(0x9E3779B97F4A7C15)
        g = np.arange(dim, dtype=np.uint64)
        c1 = (np.uint64(2) * g + np.uint64(1)) * gamma + key
        u1, u2 = [((mix(c) >> np.uint64(11)).astype(np.float64) + 0.5)
                  * 2.0 ** -53 for c in (c1, c1 + gamma)]
    r = np.sqrt(-2.0 * np.log(u1))
    return np.stack([r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)])


@pytest.mark.parametrize('seed', [0, 42, 2**40 + 7])
def test_draw_against_numpy_oracle(seed):
    import torch
    from dynamite_tpu_torch.ops.draw import normal_rows
    got = normal_rows(seed, 715, torch.float64, 'cpu', 0, 1).numpy()
    want = _oracle(seed, 715)
    assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))
    f32 = normal_rows(seed, 715, torch.float32, 'cpu', 0, 1)
    assert torch.equal(f32, torch.from_numpy(got).float())


@pytest.mark.parametrize('world', [2, 3])
def test_draw_above_the_grain_on_several_threads(world):
    """Past ATen's parallel grain (32,768 elements) an elementwise op splits
    into chunks whose edges move with the thread count and a rank's first
    row: each rank's rows on one thread (as the switch gives a rank few)
    against world 1's on four, bitwise."""
    import torch
    from dynamite_tpu_torch.ops.draw import normal_rows
    from dynamite_tpu_torch.parallel import mesh
    dim = 3 * 2**16 + 12345
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(4)
        whole = normal_rows(SEED, dim, torch.float64, 'cpu', 0, 1)
        torch.set_num_threads(1)
        parts = [normal_rows(SEED, dim, torch.float64, 'cpu', r, world)
                 [:, :mesh.valid_rows(dim, r, world)] for r in range(world)]
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(torch.cat(parts, 1), whole)


def _one_process(space, seed):
    """World 1's draw, state and start vector, in this process."""
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.solvers.eigs import random_start
    from dynamite_tpu_torch.states import State
    saved = config._device, config._precision
    config.device, config._precision = 'cpu', 'double'
    try:
        sub = _space(space)
        raw = State(subspace=sub)
        raw.set_random(seed=seed, normalize=False)
        out = {'raw': raw.to_numpy(),
               'state': State(state='random', subspace=sub,
                              seed=seed).to_numpy(),
               'start': random_start(sub.get_dimension(), torch.float64,
                                     torch.device('cpu'), seed=seed)}
        out['start'] = out['start'].numpy()
    finally:
        config._device, config._precision = saved
    return out


def _spawn_ranks(world, tmp_path, timeout=240):
    """The ranks of :func:`_rank_main` under torchrun's variables alone
    (no ``initialize()`` call in them); returns rank 0's arrays and every
    rank's record. At world 3 the ranks name two hosts (NCCL_HOSTID):
    rank 0 on one, ranks 1 and 2 on the other."""
    port = _free_port()
    procs = []
    for r in range(world):
        extra = dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                     MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
        if world == 3:
            extra['NCCL_HOSTID'] = 'h0' if r == 0 else 'h1'
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp_path)],
            env=_env(**extra), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
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
        assert p.returncode == 0, f'rank {r} of {world}:\n{out[-4000:]}'
    recs = [json.loads((tmp_path / f'rank{r}.json').read_text())
            for r in range(world)]
    return np.load(tmp_path / 'rank0.npz'), recs


@pytest.mark.parametrize('world', [2, 3])
def test_random_states_do_not_depend_on_the_world(world, tmp_path):
    arrays, recs = _spawn_ranks(world, tmp_path)
    for space in SPACES:
        one = _one_process(space, SEED)
        raw = arrays[f'{space}_raw']
        assert raw.dtype == one['raw'].dtype
        assert np.array_equal(raw, one['raw']), space
        for key in ('state', 'start'):
            got, want = arrays[f'{space}_{key}'], one[key]
            if key == 'start':
                got = got[0] + 1j * got[1]
                want = want[0] + 1j * want[1]
            assert got.shape == want.shape
            err = np.max(np.abs(got - want))
            assert err <= 1e-15 * np.max(np.abs(want)), (space, key, err)
    for r, rec in enumerate(recs):
        assert rec['joined'] == [True, world, r], rec
        assert rec['pads_zero'], rec
    for rec in recs[1:]:
        for key in ('evals', 'stats', 'max_its_raised'):
            assert rec[key] == recs[0][key], key
    assert recs[0]['max_its_raised'] is True
    assert recs[0]['comm'] == [0, world]
    assert [rec['comm'][0] for rec in recs] == list(range(world))
    assert all(rec['mesh_shape'] == ['ok', 'raised'] for rec in recs)
    assert all(rec['read_before_overwrite'] == [True, True] for rec in recs)
    # get_memory_usage: each rank holds (rank + 1) GB here; at world 3
    # rank 0 is on a host of its own
    total = world * (world + 1) / 2
    for r, rec in enumerate(recs):
        node = total if world == 2 else (1 if r == 0 else 5)
        assert rec['memory'] == [r + 1, node, total], rec


# -- the switch over ranks ------------------------------------------------


def _switch(*args, cards=None, cwd=REPO):
    """Start ``python -m dynamite_tpu_torch.switch --device cpu ...``."""
    cmd = [sys.executable, '-m', 'dynamite_tpu_torch.switch', '--device',
           'cpu']
    if cards is not None:
        cmd += ['--cards', str(cards)]
    return subprocess.Popen(cmd + list(args), cwd=cwd, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _done(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


def _reference_args(*rels):
    from tests.torch_reference_suite import EXCLUDED
    args = ['--pytest'] + [os.path.join('tests', rel) for rel in rels]
    for nodeid in EXCLUDED:
        if nodeid.partition('::')[0] in rels:
            args += ['--deselect', os.path.join('tests', nodeid)]
    return args + ['-q', '-p', 'no:randomly']


REFERENCE_FILES = ('unit/test_states.py', 'integration/test_states.py',
                   'integration/test_evolve.py')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every switch run of this file's comparisons, started together; the
    resumed floquet run after its checkpointed first half. Returns
    {name: standard output}."""
    tmp = tmp_path_factory.mktemp('cards')
    ck = tmp / 'checkpoints'
    ck.mkdir()
    floquet = os.path.join(SCRIPTS, 'floquet', 'run_floquet.py')
    kagome = os.path.join(SCRIPTS, 'kagome')
    nb = os.path.join(REPO, 'examples', 'tutorial', '2-States.ipynb')
    ref = _reference_args(*REFERENCE_FILES)
    part = [floquet, '-L', '12', '--checkpoint-every', '2',
            '--checkpoint-path', str(ck)]
    procs = {
        'floquet_1': _switch(floquet, '-L', '12', '--n-cycles', '6'),
        'floquet_2': _switch(floquet, '-L', '12', '--n-cycles', '6',
                             cards=2),
        'floquet_part': _switch(*part, '--n-cycles', '4', cards=2),
        'kagome_1': _switch('run_kagome.py', '12', cwd=kagome),
        'kagome_2': _switch('run_kagome.py', '12', cards=2, cwd=kagome),
        'notebook_1': _switch('--notebook', nb),
        'notebook_2': _switch('--notebook', nb, cards=2),
        'pytest_1': _switch(*ref),
        'pytest_2': _switch(*ref, cards=2),
    }
    out = {}
    try:
        out['floquet_part'] = _done(procs.pop('floquet_part'))
        out['checkpoints_after_part'] = sorted(os.listdir(ck))
        procs['floquet_rest'] = _switch(*part, '--n-cycles', '6', cards=2)
        for name, proc in procs.items():
            out[name] = _done(proc)
        out['checkpoints_after_rest'] = sorted(os.listdir(ck))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _table(out):
    return np.array([line.split(',') for line in out.splitlines()
                     if line and not line[0].isalpha()], dtype=float)


def _close(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return got.shape == want.shape and bool(np.all(
        np.abs(got - want) <= RTOL * np.abs(want) + ATOL))


def test_floquet_over_two_ranks(runs):
    one, two = runs['floquet_1'], runs['floquet_2']
    assert one.splitlines()[0] == two.splitlines()[0]  # the header, once
    assert two.count('t,Deff_energy') == 1
    assert _table(one).shape == (7, 15) and _close(_table(two), _table(one))
    resumed = np.concatenate([_table(runs['floquet_part']),
                              _table(runs['floquet_rest'])])
    assert _close(resumed, _table(one))
    # rank 0 alone removed the older checkpoint (os.remove over ranks)
    assert runs['checkpoints_after_part'] == [
        'floquet_cycle_4.metadata', 'floquet_cycle_4.vec']
    assert runs['checkpoints_after_rest'] == [
        'floquet_cycle_6.metadata', 'floquet_cycle_6.vec']


def test_kagome_over_two_ranks(runs):
    one, two = runs['kagome_1'].splitlines(), runs['kagome_2'].splitlines()
    assert len(one) == len(two) == 6 and one[:2] == two[:2]
    for prefix in ('E0 = ', 'gap = '):
        a, = [line for line in one if line.startswith(prefix)]
        b, = [line for line in two if line.startswith(prefix)]
        nums = [[float(x) for x in line.replace('(', ' ').replace(')', ' ')
                 .split() if x[0] in '-0123456789'] for line in (a, b)]
        assert _close(nums[1], nums[0]), (a, b)


def test_notebook_over_two_ranks(runs):
    from tests.torch_tutorial_reference import cells, compare
    one, two = runs['notebook_1'], runs['notebook_2']
    assert compare(two, one, '2-States.ipynb', against_jax=False,
                   worlds_differ=True) == []
    # the seeded random state's entropy line is compared too: it is the
    # same state on both
    assert cells(two)[5] and _close(
        [float(x) for x in cells(two)[5]], [float(x) for x in cells(one)[5]])
    assert len(two.splitlines()) == len(one.splitlines())


def test_pytest_over_two_ranks(runs):
    def recs(out):
        return {r['reference_file']: {k: v for k, v in r.items()
                                      if k != 'seconds'}
                for r in map(json.loads, (line for line in out.splitlines()
                                          if line.startswith('{"reference')))}
    one, two = recs(runs['pytest_1']), recs(runs['pytest_2'])
    assert len(one) == len(REFERENCE_FILES) and two == one
    assert all(r['failed'] == 0 and r['passed'] > 0 for r in two.values())
    lines = [line for line in runs['pytest_2'].splitlines()
             if line.startswith('{"reference')]
    assert len(lines) == len(REFERENCE_FILES)  # printed once


PROBE = '''
from dynamite_tpu.parallel import multihost


def test_same_on_every_rank(tmp_path):
    from dynamite_tpu.states import State
    psi = State(L=6, state='random', seed=5)
    psi.save(str(tmp_path / 'psi'))
    back = State.from_file(str(tmp_path / 'psi'))
    assert (back.to_numpy() == psi.to_numpy()).all()


def test_fails_on_rank_1_only():
    assert multihost.rank() != 1
'''

HANG = '''
import os, sys, time
from dynamite_tpu.parallel import multihost
from dynamite_tpu.states import State
State(L=6, state='random', seed=1).to_numpy()
with open(os.path.join(sys.argv[1], f'pid{multihost.rank()}'), 'w') as f:
    f.write(str(os.getpid()))
multihost.barrier('pids written')
if multihost.rank() == 1:
    raise RuntimeError('rank 1 gives up')
time.sleep(600)  # rank 0 never ends by itself
'''


def test_a_failed_rank_fails_the_run(tmp_path):
    probe, hang = tmp_path / 'test_probe.py', tmp_path / 'hang.py'
    probe.write_text(PROBE)
    hang.write_text(HANG)
    t0 = time.monotonic()
    hung = _switch(str(hang), str(tmp_path), cards=2)
    tests = _switch('--pytest', str(probe), '-q', '-p', 'no:randomly',
                    cards=2)
    out, err = hung.communicate(timeout=120)
    seconds = time.monotonic() - t0
    assert hung.returncode != 0 and seconds < 60, (seconds, err[-3000:])
    assert 'rank 1 gives up' in err and 'rank 1 of 2' in err
    for r in range(2):
        pid = int((tmp_path / f'pid{r}').read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    out, err = tests.communicate(timeout=120)
    assert tests.returncode == 1, err[-3000:]
    assert 'the ranks disagree on this test: rank 0 passed, rank 1 failed' \
        in out
    rec, = [json.loads(line) for line in out.splitlines()
            if line.startswith('{"reference')]
    assert (rec['collected'], rec['passed'], rec['failed']) == (2, 1, 1)


# -- config.initialize ----------------------------------------------------


def test_config_initialize_platform():
    import torch
    from dynamite_tpu_torch import _Config
    c = _Config()
    c.initialize(platform='cpu', mesh_shape=(1,))
    assert c.device == torch.device('cpu') and c.initialized
    with pytest.raises(RuntimeError, match='only be called once'):
        c.initialize(platform='cpu')
    with pytest.raises(ValueError, match="dynamite_tpu_torch runs on CUDA"):
        _Config().initialize(platform='tpu')
    with pytest.raises(ValueError, match='disagree'):
        _Config().initialize(platform='gpu', device='cpu')
    with pytest.raises(RuntimeError, match='--cards 4'):
        _Config().initialize(platform='cpu', mesh_shape=(2, 2))
    c = _Config()
    c.initialize('single', 'cpu', device='cpu')
    assert c.precision == 'single' and c.device.type == 'cpu'


# -- the first use under a launcher's environment that names no group ----


FIRST_USE = '''
import json, sys, warnings
from dynamite_tpu_torch import config
from dynamite_tpu_torch.parallel import multihost
from dynamite_tpu_torch.states import State
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    if sys.argv[1] == 'initialize':
        multihost.initialize()
        config.initialize(precision='single', platform='cpu')
    else:
        config.device = 'cpu'
    State(L=4, state='random', seed=1).to_numpy()
    out = [multihost.world_size(), multihost.is_initialized(),
           config.precision, [str(w.message) for w in caught]]
if sys.argv[2] == 'explicit':
    try:
        multihost.initialize()
        out.append('initialize: one process')
    except ValueError as e:
        out.append(f'initialize: {e}')
print(json.dumps(out))
'''

BATCH = dict(SLURM_JOB_ID='4242', SLURM_PROCID='0', SLURM_LOCALID='0',
             SLURM_NODEID='0', SLURM_JOB_NODELIST='node7')


@pytest.mark.parametrize('case, env, warned, explicit', [
    # python script.py inside an sbatch job: a batch step, one process
    ('batch', BATCH, None, 'without SLURM_NTASKS'),
    # sbatch -n 4 with MASTER_ADDR set: still the batch step, which must
    # not wait for three ranks that no one starts (an explicit
    # initialize() would: it was asked for)
    ('batch_n4', dict(BATCH, SLURM_NTASKS='4', MASTER_ADDR='127.0.0.1'),
     None, None),
    # a step that lacks a value: one process with a warning; an explicit
    # initialize() raises on it
    ('partial', dict(BATCH, SLURM_STEP_ID='0'), 'without SLURM_NTASKS',
     'without SLURM_NTASKS'),
    # no launcher: initialize() leaves the precision open
    ('initialize', {}, None, 'one process'),
])
def test_first_use_without_a_group(case, env, warned, explicit):
    proc = subprocess.run(
        [sys.executable, '-c', FIRST_USE,
         'initialize' if case == 'initialize' else 'first_use',
         'none' if explicit is None else 'explicit'],
        env=_env(**env), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    world, joined, precision, warnings, *said = json.loads(
        proc.stdout.splitlines()[-1])
    assert (world, joined) == (1, False)
    assert precision == ('single' if case == 'initialize' else 'double')
    if warned is None:
        assert warnings == []
    else:
        assert len(warnings) == 1 and warned in warnings[0]
    assert said == [] if explicit is None else explicit in said[0]


# -- the rank processes ---------------------------------------------------


def _rank_main(out_dir):
    """One rank under torchrun's variables: no ``initialize()`` call; the
    group must come up at the first use of the port."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from dynamite_tpu_torch import _Config, computations, config, tools
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.parallel import mesh, multihost
    from dynamite_tpu_torch.solvers.eigs import random_start
    from dynamite_tpu_torch.solvers.expmv import MaxIterationsError
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import Full

    config.device = 'cpu'
    assert 'jax' not in sys.modules and 'dynamite_tpu' not in sys.modules
    rank = int(os.environ['RANK'])
    rec, arrays = {}, {}
    pads_zero = True
    for space in SPACES:
        sub = _space(space)
        raw = State(subspace=sub)
        raw.set_random(seed=SEED, normalize=False)
        dim = sub.get_dimension()
        keep = mesh.valid_rows(dim)
        pads_zero &= bool(torch.all(raw.data[:, keep:] == 0))
        arrays[f'{space}_raw'] = raw.to_numpy()
        arrays[f'{space}_state'] = State(state='random', subspace=sub,
                                         seed=SEED).to_numpy()
        start = random_start(dim, torch.float64, torch.device('cpu'),
                             seed=SEED)
        pads_zero &= bool(torch.all(start[:, keep:] == 0))
        arrays[f'{space}_start'] = multihost.gather_rows(
            start, dim=dim).numpy()
    rec['joined'] = [multihost.is_initialized(), multihost.world_size(),
                     multihost.rank()]
    rec['pads_zero'] = pads_zero

    H = localized(10)
    H.add_subspace(Full(L=10))
    rec['evals'] = [float(x) for x in H.eigsolve(nev=2)]
    rec['stats'] = computations.last_solve_stats
    try:
        H.eigsolve(nev=4, tol=1e-15, max_its=1)
        rec['max_its_raised'] = False
    except MaxIterationsError:
        rec['max_its_raised'] = True
    comm = tools.MPI_COMM_WORLD()
    rec['comm'] = [comm.rank, comm.size]
    world = multihost.world_size()
    shapes = []
    for shape in ((world,), (world + 1,)):
        try:
            _Config()._check_cards(shape)
            shapes.append('ok')
        except RuntimeError:
            shapes.append('raised')
    rec['mesh_shape'] = shapes
    # a save over a file that another rank is still reading (an earlier
    # save's): rank 1 reads late, and must read what the earlier save wrote
    from dynamite_tpu_torch.operators import Operator, sigmax, sigmaz
    op_file = os.path.join(out_dir, 'op.dnm')
    sigmax(0).save(op_file)
    if rank == 1:
        time.sleep(0.5)
    got = Operator.load(op_file)
    sigmaz(1).save(op_file)
    state_file = os.path.join(out_dir, 'psi')
    first = State(L=4, state='UUUU')
    first.save(state_file)
    if rank == 1:
        time.sleep(0.5)
    back = State.from_file(state_file)
    State(L=4, state='DDDD').save(state_file)
    rec['read_before_overwrite'] = [got == sigmax(0), bool(
        torch.equal(back.data, first.data))]
    # the memory counters as a card's would read (rank + 1 GB held here)
    tools._cuda_device = lambda: 'cuda'
    torch.cuda.memory_stats = lambda device: {
        'allocated_bytes.all.current': (rank + 1) * 10**9}
    rec['memory'] = [tools.get_memory_usage(group_by=g)
                     for g in ('rank', 'node', 'all')]
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(rec, f, default=float)
    if rank == 0:
        np.savez(os.path.join(out_dir, 'rank0.npz'), **arrays)
    multihost.barrier('written')


if __name__ == '__main__':
    _rank_main(sys.argv[1])
