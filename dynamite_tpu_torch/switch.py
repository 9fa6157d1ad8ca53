"""
Run code written for :mod:`dynamite_tpu` on this port, unchanged.

    python -m dynamite_tpu_torch.switch [--device cpu] [--cards N] SCRIPT [ARGS...]
    python -m dynamite_tpu_torch.switch [--device cpu] [--cards N] --pytest PATH... [OPTIONS]
    python -m dynamite_tpu_torch.switch [--device cpu] [--cards N] --notebook NB.ipynb
    python -m dynamite_tpu_torch.switch [--device cpu] [--cards N] --console

In a notebook or any other process, :func:`install` does the same for the
rest of the process (``from dynamite_tpu_torch.switch import install;
install()`` in place of a tutorial notebook's setup cell), on one card.
``--console`` is a REPL, and ``dynamite_tpu_torch.interactive`` a Jupyter
kernel, whose cells run on every card (one engine process per card; see
that module).

The code's ``import dynamite_tpu`` and every ``dynamite_tpu.x.y`` reach
the very module objects of ``dynamite_tpu_torch`` and
``dynamite_tpu_torch.x.y`` (so ``from dynamite_tpu import config`` sets the
port's configuration, and ``dynamite_tpu.computations.last_solve_stats``
reads the port's), through a ``sys.meta_path`` finder placed first. No file
of the JAX package is loaded:

* a name with no counterpart in the port (``dynamite_tpu.utils.hoist``,
  ``dynamite_tpu.ops.pallas_apply``, the TPU workarounds that are not
  ported) raises ``ImportError`` naming it;
* ``import jax`` raises ``ImportError`` as well, naming the script's own
  port (``NAME_torch.py`` beside ``NAME.py``) where it has one: a script
  that drives JAX itself (``examples/scripts/sharded_spinconserve/
  run_sharded.py``) cannot run on the port unchanged.

The switch refuses to start in a process that already holds ``jax`` or the
JAX package's ``dynamite_tpu``. ``--device cpu`` sets ``config.device =
'cpu'`` first; without it the port runs on the CUDA device, and raises
where there is none. The code sets the port's global configuration, so run
each script, test run or notebook in a fresh process.

Every card of the host, one process each. The JAX package spans every chip
of its host in one process (its default mesh). Here each card is a
process of its own: ``--cards N`` (default: every visible card; 1 with
``--device cpu``, the JAX package's one CPU device) starts N ranks as
``torchrun --standalone`` does (:func:`launch`: ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` on a free port of this
host), each of which runs the same code through the switch and joins the
process group at its first use of the port (NCCL on the cards, gloo on the
CPU; ``--device cpu --cards N`` runs N gloo ranks). Each rank gets cores /
N CPU threads (``OMP_NUM_THREADS``, unless it is set). The run is one
process to its user: rank 0's standard output and error are the run's, the
other ranks' go to files, shown when a rank fails; when every rank exits 0
the switch exits 0; when one fails, the switch ends the others within
:data:`GRACE_S` + :data:`KILL_S` seconds, prints its error output and
exits non-zero. A process that a launcher started already (``torchrun``,
``srun``, ``mpirun``; or the switch's own ranks) runs the code itself.

* A script runs as ``python SCRIPT ARGS`` runs it: its directory first on
  ``sys.path``, ``sys.argv`` set, as ``__main__``.
* ``--pytest`` runs ``pytest.main`` over the given paths and options with
  ``--noconftest`` (the JAX package's ``tests/conftest.py`` imports JAX)
  and the plugin :class:`ReferencePlugin`, which puts the repository root
  on ``sys.path`` (the part of that conftest that is not JAX's), installs
  the finder, and prints one JSON line per test file (collected, passed,
  skipped, failed, excluded by ``--deselect``, seconds). The exit code is
  pytest's. Over ranks every rank runs the same session, and
  :func:`rank_plugin` holds them to one run: the same tests collected,
  each test's outcome the same on every rank (a test whose outcome differs
  fails on every rank, naming the ranks), ``tmp_path`` rank 0's directory
  on every rank, and the JSON lines printed once.
* ``--notebook`` runs a tutorial notebook's code cells in order in one
  namespace, in the notebook's directory, printing each cell's output under
  a ``# cell N`` line and, as Jupyter does, the repr of a cell's last
  expression. Cell 0, the JAX setup cell, is not run: its lines that are
  not JAX's (``import os, sys``, ``import numpy as np``) are, then
  :func:`install`. A cell listed in :data:`SUBSTITUTES` runs its port
  instead, and the output says so.

Over ranks a script or notebook sees the host as one process would: every
rank computes the same host values (eigenvalues, ``to_numpy()``,
expectation values, entropies, ``last_solve_stats``), and the files it
makes and removes are those of one process (:func:`host_files`).
"""

import argparse
import ast
import contextlib
import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import json
import os
import runpy
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REFERENCE = 'dynamite_tpu'
PORT = 'dynamite_tpu_torch'
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REFUSED = ('jax', 'jaxlib')
#: seconds the other ranks get to end by themselves once one has failed,
#: and from SIGTERM to SIGKILL
GRACE_S = 15
KILL_S = 5
#: seconds a rank of ``--pytest`` waits for the others to agree on a test's
#: outcome before it gives the run up (a rank stuck in a collective of a
#: test that failed elsewhere)
AGREE_TIMEOUT_S = 120

#: The port of each notebook cell that drives JAX itself, by (notebook
#: file name, code cell index with the setup cell as 0). Each defines what
#: the cell defines, and prints the port's counterpart of what it prints.
SUBSTITUTES = {
    ('6-MatrixFree.ipynb', 3): '''\
from dynamite_tpu import config
from dynamite_tpu.parallel import mesh, multihost
from dynamite_tpu.states import State
print('devices:', multihost.world_size(), 'x', config.device)
psi = State(state='random', subspace=sub, seed=0)
print('storage shape:', tuple(psi.data.shape),
      ' rows: rank', multihost.rank(), 'holds',
      mesh.valid_rows(sub.get_dimension()), 'of', sub.get_dimension())
''',
}


def _is_reference(name):
    return name == REFERENCE or name.startswith(REFERENCE + '.')


def _top(name):
    return name.partition('.')[0]


def _script_port(path):
    """The port of a script that imports JAX itself: ``NAME_torch.py``
    beside ``NAME.py``, or None."""
    stem, ext = os.path.splitext(path)
    port = f'{stem}_torch{ext}'
    return port if os.path.exists(port) else None


class _Alias(importlib.abc.Loader):
    """Loads ``dynamite_tpu.x`` as the module object of
    ``dynamite_tpu_torch.x``."""

    def __init__(self, module):
        self.module = module

    def create_module(self, spec):
        self.spec = self.module.__spec__
        return self.module

    def exec_module(self, module):
        # the import system set the alias's spec on the module: give it
        # back its own, so its relative imports resolve in the port
        module.__spec__ = self.spec


class PortFinder(importlib.abc.MetaPathFinder):
    """Serves the JAX package's module names from the port and refuses
    JAX (see the module docstring). ``script`` names the code that runs,
    for the refusal's message."""

    def __init__(self, script=None):
        self.script = script

    def find_spec(self, fullname, path=None, target=None):
        if _top(fullname) in _REFUSED:
            port = self.script and _script_port(self.script)
            hint = (f'; run its port {port} instead' if port else
                    '; it cannot run on the port unchanged')
            raise ImportError(f'{self.script or "this process"} imports '
                              f'{fullname}{hint}', name=fullname)
        if not _is_reference(fullname):
            return None
        name = PORT + fullname[len(REFERENCE):]
        if importlib.util.find_spec(name) is None:
            raise ImportError(f'{fullname} has no counterpart in {PORT} '
                              f'(no module {name})', name=fullname)
        module = importlib.import_module(name)
        return importlib.machinery.ModuleSpec(
            fullname, _Alias(module),
            is_package=hasattr(module, '__path__'))


def _check_clean():
    held = sorted(name for name, mod in sys.modules.items()
                  if _top(name) in _REFUSED or (
                      _is_reference(name)
                      and not getattr(mod, '__name__', '').startswith(PORT)))
    if held:
        raise RuntimeError('the switch needs a process without JAX or the '
                           f'JAX package; already imported: {held[:5]}')


def install(device=None, script=None):
    """Serve ``dynamite_tpu`` from the port in this process from now on
    (see the module docstring) and return the finder; ``device`` sets
    ``config.device`` first. Refuses a process that holds JAX or the JAX
    package already."""
    _check_clean()
    if device is not None:
        from dynamite_tpu_torch import config
        config.device = device
    finder = PortFinder(script)
    sys.meta_path.insert(0, finder)
    return finder


def _launched():
    """The launcher's view of this process (``multihost.detect_launch``),
    or None."""
    from dynamite_tpu_torch.parallel import multihost
    return multihost.detect_launch()


@contextlib.contextmanager
def host_files():
    """Over ranks, the host's files as one process sees them, for the code
    that runs inside: a script written for one process makes one temporary
    directory and removes each file once, and here every rank runs it. So
    ``tempfile.mkdtemp`` (and ``tempfile.TemporaryDirectory``) give every
    rank rank 0's new directory, which rank 0 removes once every rank has
    left it, and ``os.remove`` is rank 0's alone. Each is a collective
    where a directory is made or left: every rank calls it, as every rank
    runs the same code. One process: nothing changes."""
    launch = _launched()
    if launch is None or launch.world_size == 1 or \
            getattr(tempfile.mkdtemp, 'host_files', False):
        yield  # one process, or inside host_files already
        return
    from dynamite_tpu_torch.parallel import multihost
    first = launch.rank == 0
    real = os.remove, tempfile.mkdtemp, tempfile.TemporaryDirectory

    def remove(path, *, dir_fd=None):
        if first:
            real[0](path, dir_fd=dir_fd)

    def mkdtemp(suffix=None, prefix=None, dir=None):
        return multihost.broadcast_object(
            real[1](suffix, prefix, dir) if first else None)

    mkdtemp.host_files = True

    class TemporaryDirectory(real[2]):
        def cleanup(self):
            multihost.barrier('TemporaryDirectory')
            if first:
                super().cleanup()
            else:
                self._finalizer.detach()

    os.remove, tempfile.mkdtemp, tempfile.TemporaryDirectory = \
        remove, mkdtemp, TemporaryDirectory
    try:
        yield
    finally:
        os.remove, tempfile.mkdtemp, tempfile.TemporaryDirectory = real


def run_script(path, argv=(), device=None):
    """Run the script at ``path`` with arguments ``argv`` as ``__main__``
    on the port (see the module docstring); ``device`` sets
    ``config.device`` first. The finder, ``sys.argv`` and ``sys.path`` are
    restored afterwards; the aliases the script imported stay in
    ``sys.modules``."""
    path = os.path.abspath(path)
    finder = install(device, path)
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv = [path] + list(argv)
    sys.path.insert(0, os.path.dirname(path))
    try:
        with host_files():
            runpy.run_path(path, run_name='__main__')
    finally:
        sys.meta_path.remove(finder)
        sys.argv, sys.path[:] = saved_argv, saved_path


class ReferencePlugin:
    """The ``--pytest`` mode's pytest plugin: the repository root on
    ``sys.path``, :func:`install` before collection, and one JSON line per
    test file at the end of the run."""

    def __init__(self, device=None):
        self.device = device
        self.files = {}
        self.outcomes = {}

    def _file(self, nodeid):
        path = nodeid.partition('::')[0]
        return self.files.setdefault(path, {
            'reference_file': path, 'collected': 0, 'passed': 0,
            'skipped': 0, 'failed': 0, 'excluded': 0, 'seconds': 0.0})

    def pytest_configure(self, config):
        if REPO not in sys.path:
            sys.path.insert(0, REPO)
        install(self.device)

    def pytest_itemcollected(self, item):
        self._file(item.nodeid)['collected'] += 1

    def pytest_collectreport(self, report):
        if report.failed:  # a file that does not import counts as failed
            self._file(report.nodeid)['failed'] += 1

    def pytest_deselected(self, items):
        for item in items:
            self._file(item.nodeid)['excluded'] += 1

    def pytest_runtest_logreport(self, report):
        self._file(report.nodeid)['seconds'] += report.duration
        if report.failed:
            outcome = 'failed'
        elif report.skipped:
            outcome = 'skipped'
        elif report.when == 'call':
            outcome = 'passed'
        else:
            return
        if self.outcomes.get(report.nodeid) != 'failed':
            self.outcomes[report.nodeid] = outcome

    def pytest_terminal_summary(self, terminalreporter):
        for nodeid, outcome in self.outcomes.items():
            self._file(nodeid)[outcome] += 1
        counts = {path: {k: v for k, v in rec.items() if k != 'seconds'}
                  for path, rec in self.files.items()}
        agreed = _side_gather(counts)
        if agreed is not None and any(c != counts for c in agreed):
            terminalreporter.write_line(
                'switch: the ranks counted different outcomes: '
                + json.dumps(agreed))
            terminalreporter.config._ranks_disagree = True
        if agreed is not None and _side_rank() != 0:
            return  # rank 0 prints the run's lines
        for rec in self.files.values():
            rec['seconds'] = round(rec['seconds'], 3)
            terminalreporter.write_line(json.dumps(rec))


#: the ``--pytest`` mode's gloo group over the ranks, when there are several
_SIDE = {}


def _side_rank():
    import torch.distributed as dist
    return dist.get_rank(_SIDE['group'])


def _side_gather(obj):
    """Every rank's ``obj``, in rank order, over the gloo side group; None
    with one rank. A rank that waits longer than AGREE_TIMEOUT_S for the
    others (one of them stuck in a collective of a test that failed
    elsewhere) gives the run up: it says so and exits, and the launcher
    ends the others."""
    if 'group' not in _SIDE:
        return None
    import torch.distributed as dist
    group = _SIDE['group']
    out = [None] * dist.get_world_size(group)
    try:
        dist.all_gather_object(out, obj, group=group)
    except Exception as e:  # noqa: BLE001 - any failure ends this rank
        sys.stderr.write(f'switch: rank {_side_rank()} could not agree with '
                         f'the other ranks within {AGREE_TIMEOUT_S} s on '
                         f'{str(obj)[:300]}: {e}\n')
        sys.stderr.flush()
        os._exit(3)
    return out


def rank_plugin():
    """The ``--pytest`` mode's plugin over ranks (a class, registered as
    pytest registers its own fixture classes): starts the process group and
    a gloo side group at configure time, checks that every rank collected
    the same tests, makes each test's outcome every rank's (a test that
    passed on one rank and failed or skipped on another fails on every
    rank, at teardown, naming each rank's outcome), and gives every rank
    rank 0's ``tmp_path``: rank 0 makes the directory and sends its path
    (every rank's own ``--basetemp`` would make each rank's pytest delete
    the directory the others use)."""
    from datetime import timedelta
    from pathlib import Path
    import re
    import pytest
    import torch.distributed as dist
    order = {'passed': 0, 'skipped': 1, 'failed': 2}

    class RankAgreement:
        outcomes = {}

        @staticmethod
        @pytest.hookimpl(trylast=True)  # after ReferencePlugin's install
        def pytest_configure(config):
            from dynamite_tpu_torch.parallel import multihost
            multihost.initialize()
            _SIDE['group'] = dist.new_group(
                backend='gloo', timeout=timedelta(seconds=AGREE_TIMEOUT_S))

        @staticmethod
        def pytest_collection_finish(session):
            ids = [item.nodeid for item in session.items]
            every = _side_gather(ids)
            odd = [r for r, other in enumerate(every) if other != ids]
            if odd:
                raise pytest.UsageError(
                    f'the ranks collected different tests (ranks {odd} '
                    f'differ from rank {_side_rank()})')

        @staticmethod
        @pytest.hookimpl(hookwrapper=True)
        def pytest_runtest_makereport(item, call):
            report = (yield).get_result()
            outcome = report.outcome
            if report.failed:
                # now: a rank that gives up later never prints its summary
                sys.stderr.write(f'switch: rank {_side_rank()} failed '
                                 f'{item.nodeid} ({report.when}):\n'
                                 f'{report.longreprtext}\n')
            seen = RankAgreement.outcomes.get(item.nodeid, 'passed')
            if order[outcome] > order[seen]:
                seen = RankAgreement.outcomes[item.nodeid] = outcome
            if report.when != 'teardown':
                return
            every = _side_gather(seen)
            if len(set(every)) > 1:
                report.outcome = 'failed'
                report.longrepr = (
                    'switch: the ranks disagree on this test: ' + ', '.join(
                        f'rank {r} {o}' for r, o in enumerate(every)))

        @staticmethod
        @pytest.fixture
        def tmp_path(request, tmp_path_factory):
            path = None
            if _side_rank() == 0:
                name = re.sub(r'[\W]', '_', request.node.name)[:30]
                path = str(tmp_path_factory.mktemp(name, numbered=True))
            box = [path]
            dist.broadcast_object_list(box, src=0, group=_SIDE['group'])
            return Path(box[0])

        @staticmethod
        def pytest_sessionfinish(session, exitstatus):
            if getattr(session.config, '_ranks_disagree', False):
                session.exitstatus = pytest.ExitCode.TESTS_FAILED

    return RankAgreement


def run_pytest(args, device=None):
    """``pytest.main`` over ``args`` (test paths and pytest options) on the
    port, with :class:`ReferencePlugin` (and, over ranks, :func:`
    rank_plugin`); returns pytest's exit code."""
    import pytest
    plugins = [ReferencePlugin(device)]
    launch = _launched()
    if launch is not None and launch.world_size > 1:
        plugins.append(rank_plugin())
    return int(pytest.main(['--noconftest', '-p', 'no:cacheprovider',
                            *args], plugins=plugins))


def notebook_cells(path):
    """The sources of a notebook's code cells, read with the standard
    library (no nbformat)."""
    with open(path) as f:
        nb = json.load(f)
    return [''.join(c['source']) for c in nb['cells']
            if c['cell_type'] == 'code']


def run_cell(source, namespace, name='<cell>'):
    """Execute one cell in ``namespace``; print the repr of its last
    statement when that is an expression whose value is not None."""
    tree = ast.parse(source, name)
    last = None
    if tree.body and isinstance(tree.body[-1], ast.Expr):
        last = ast.Expression(tree.body.pop().value)
    exec(compile(tree, name, 'exec'), namespace)
    if last is not None:
        value = eval(compile(last, name, 'eval'), namespace)
        if value is not None:
            print(repr(value))


SETUP_LINES = ('import os', 'import sys', 'import numpy as np')


def run_notebook(path, device=None):
    """Run a tutorial notebook on the port (see the module docstring)."""
    path = os.path.abspath(path)
    cells = notebook_cells(path)
    os.chdir(os.path.dirname(path))
    namespace = {'__name__': '__main__'}
    setup = [line for line in cells[0].splitlines()
             if line.strip() in SETUP_LINES]
    print('# cell 0: the JAX setup cell, not run; run instead:')
    for line in setup + [f'install(device={device!r})']:
        print(f'#   {line}')
    exec('\n'.join(setup), namespace)
    install(device, path)
    with host_files():
        _run_cells(path, cells, namespace)


def _run_cells(path, cells, namespace):
    for i, source in enumerate(cells[1:], 1):
        sub = SUBSTITUTES.get((os.path.basename(path), i))
        if sub is not None:
            print(f'# cell {i}: substituted by the port\'s counterpart '
                  '(switch.SUBSTITUTES)')
            source = sub
        else:
            print(f'# cell {i}')
        sys.stdout.flush()
        run_cell(source, namespace, f'<cell {i}>')


def default_cards(device):
    """The ranks of a run without ``--cards``: every visible card (the JAX
    package's default mesh), 1 on the CPU (its one CPU device) or where no
    card is visible (that rank then raises at its first use of the
    device)."""
    import torch
    return 1 if _on_cpu(device) else max(1, torch.cuda.device_count())


def _on_cpu(device):
    return device is not None and str(device).partition(':')[0] == 'cpu'


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _die_with_parent():
    """In a rank, before it runs: SIGKILL when the switch dies (Linux's
    PR_SET_PDEATHSIG), so that no rank outlives it."""
    try:
        import ctypes
        ctypes.CDLL('libc.so.6', use_errno=True).prctl(1, signal.SIGKILL)
    except OSError:
        pass


def _tail(path, n=8000):
    try:
        with open(path, errors='replace') as f:
            return f.read()[-n:]
    except OSError:
        return ''


def rank_env(cards):
    """The environment every rank of a group of ``cards`` processes on this
    host shares, as ``torchrun --standalone`` gives it (see the module
    docstring): ``MASTER_ADDR``/``MASTER_PORT`` on a free port,
    ``WORLD_SIZE``, cores / ``cards`` CPU threads (``OMP_NUM_THREADS``,
    unless it is set), the repository on ``PYTHONPATH`` and the ranks'
    sockets on the loopback. :func:`start_rank` adds the rank's own."""
    env = dict(os.environ)
    path = env.get('PYTHONPATH')
    env.update(
        MASTER_ADDR='127.0.0.1', MASTER_PORT=str(_free_port()),
        WORLD_SIZE=str(cards), LOCAL_WORLD_SIZE=str(cards), GROUP_RANK='0',
        OMP_NUM_THREADS=env.get('OMP_NUM_THREADS') or str(
            max(1, len(os.sched_getaffinity(0)) // cards)),
        PYTHONPATH=REPO + (os.pathsep + path if path else ''))
    # one host: the ranks' sockets on the loopback
    env.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    return env


def start_rank(module_argv, env, rank, stdout=None, stderr=None,
               stdin=None):
    """Start ``python -m MODULE_ARGV`` as rank ``rank`` of the group whose
    environment is ``env`` (:func:`rank_env`): ``RANK`` and ``LOCAL_RANK``
    set, in a session of its own (so that :func:`_end` reaches what it
    starts), killed when this process dies (PR_SET_PDEATHSIG)."""
    return subprocess.Popen(
        [sys.executable, '-m', *module_argv],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), stdin=stdin,
        stdout=stdout, stderr=stderr, start_new_session=True,
        preexec_fn=_die_with_parent)


def launch(cards, argv, device=None):
    """Run ``python -m dynamite_tpu_torch.switch ARGV`` as ``cards`` ranks of
    one host (see the module docstring); returns the run's exit code."""
    logs = tempfile.mkdtemp(prefix='dynamite_switch_')
    env = rank_env(cards)
    backend = 'gloo' if _on_cpu(device) else 'nccl'
    sys.stderr.write(f'switch: {cards} ranks ({backend}), '
                     f'{env["OMP_NUM_THREADS"]} CPU thread(s) each; the '
                     f'output is rank 0\'s, the other ranks\' goes to '
                     f'{logs}\n')
    sys.stderr.flush()
    procs, files = [], []
    try:
        for r in range(cards):
            out = err = None
            if r > 0:
                out = open(os.path.join(logs, f'rank{r}.out'), 'w')
                err = open(os.path.join(logs, f'rank{r}.err'), 'w')
                files += [out, err]
            procs.append(start_rank([f'{PORT}.switch', *argv], env, r,
                                    out, err))
        failed, deadline = None, None
        while any(p.poll() is None for p in procs):
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is not None:
                    deadline = time.monotonic() + GRACE_S
            elif time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        _end(procs)
        for f in files:
            f.close()
    codes = [p.returncode for p in procs]
    if failed is None:
        failed = next((r for r, c in enumerate(codes) if c != 0), None)
    if failed is None:
        shutil.rmtree(logs)
        return 0
    for r, code in enumerate(codes):
        if r > 0 and code != 0:
            for stream in ('out', 'err'):
                log = os.path.join(logs, f'rank{r}.{stream}')
                sys.stderr.write(f'switch: rank {r} of {cards} exit code '
                                 f'{code}; the end of its std{stream} '
                                 f'({log}):\n{_tail(log)}\n')
    sys.stderr.write(f'switch: rank {failed} of {cards} failed first (exit '
                     f'codes {codes})\n')
    code = codes[failed]
    return code if code > 0 else 1


def _end(procs):
    """SIGTERM to every rank (and what it started) still running, SIGKILL
    after KILL_S seconds."""
    alive = [p for p in procs if p.poll() is None]
    for sig, wait in ((signal.SIGTERM, KILL_S), (signal.SIGKILL, None)):
        for p in alive:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:
                pass
        end = time.monotonic() + (wait or 30)
        for p in alive:
            try:
                p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        alive = [p for p in alive if p.poll() is None]
        if not alive:
            return


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(
        prog='python -m dynamite_tpu_torch.switch',
        description='Run a dynamite_tpu script, test files or a tutorial '
                    'notebook on dynamite_tpu_torch.')
    p.add_argument('--device', default=None,
                   help="config.device for the run (e.g. 'cpu'); default "
                        'the CUDA device')
    p.add_argument('--cards', type=int, default=None,
                   help='processes to run, one per card (gloo ranks with '
                        '--device cpu); default every visible card, 1 with '
                        '--device cpu')
    mode = p.add_mutually_exclusive_group()
    mode.add_argument('--pytest', action='store_true',
                      help='run pytest over the arguments that follow')
    mode.add_argument('--notebook', action='store_true',
                      help='run the notebook given as the argument')
    mode.add_argument('--console', action='store_true',
                      help='a REPL whose statements run on every card '
                           '(dynamite_tpu_torch/interactive.py)')
    p.add_argument('script', nargs='?')
    p.add_argument('args', nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.notebook and args.args:
        p.error('--notebook takes one notebook and no arguments')
    if args.cards is not None and args.cards < 1:
        p.error('--cards takes a positive number')
    if args.console:
        if args.script is not None:
            p.error('--console takes no script')
        # the console's front end imports no torch: ranks of its own
        from . import interactive
        return interactive.console(args.cards, args.device)
    if args.script is None:
        p.error('a script, --pytest paths or a --notebook is needed')
    launched = _launched()
    if launched is None:
        cards = args.cards or default_cards(args.device)
        if cards > 1:
            if not _on_cpu(args.device):
                import torch
                seen = torch.cuda.device_count()
                if cards > seen:
                    raise RuntimeError(
                        f'--cards {cards}: this host shows {seen} CUDA '
                        'device(s), and each rank needs one of its own')
            return launch(cards, argv, args.device)
    elif args.cards is not None and args.cards != launched.world_size:
        p.error(f'--cards {args.cards} in a run its launcher started with '
                f'{launched.world_size} process(es)')
    if args.pytest:
        code = run_pytest([args.script] + args.args, device=args.device)
    elif args.notebook:
        run_notebook(args.script, device=args.device)
        code = 0
    else:
        run_script(args.script, args.args, device=args.device)
        code = 0
    _leave_group()
    return code


def _leave_group():
    """The end of a rank's run: wait for every rank, then tear the group
    down, so that no rank exits while another still uses it."""
    from dynamite_tpu_torch.parallel import multihost
    if multihost.is_initialized():
        multihost.barrier('the end of the run')
        multihost.shutdown()


if __name__ == '__main__':
    sys.exit(main())
