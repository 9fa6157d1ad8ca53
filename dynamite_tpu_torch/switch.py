"""
Run code written for :mod:`dynamite_tpu` on this port, unchanged.

    python -m dynamite_tpu_torch.switch [--device cpu] SCRIPT [ARGS...]
    python -m dynamite_tpu_torch.switch [--device cpu] --pytest PATH... [OPTIONS]
    python -m dynamite_tpu_torch.switch [--device cpu] --notebook NB.ipynb

In a notebook or any other process, :func:`install` does the same for the
rest of the process (``from dynamite_tpu_torch.switch import install;
install()`` in place of a tutorial notebook's setup cell).

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

* A script runs as ``python SCRIPT ARGS`` runs it: its directory first on
  ``sys.path``, ``sys.argv`` set, as ``__main__``.
* ``--pytest`` runs ``pytest.main`` over the given paths and options with
  ``--noconftest`` (the JAX package's ``tests/conftest.py`` imports JAX)
  and the plugin :class:`ReferencePlugin`, which puts the repository root
  on ``sys.path`` (the part of that conftest that is not JAX's), installs
  the finder, and prints one JSON line per test file (collected, passed,
  skipped, failed, excluded by ``--deselect``, seconds). The exit code is
  pytest's.
* ``--notebook`` runs a tutorial notebook's code cells in order in one
  namespace, in the notebook's directory, printing each cell's output under
  a ``# cell N`` line and, as Jupyter does, the repr of a cell's last
  expression. Cell 0, the JAX setup cell, is not run: its lines that are
  not JAX's (``import os, sys``, ``import numpy as np``) are, then
  :func:`install`. A cell listed in :data:`SUBSTITUTES` runs its port
  instead, and the output says so.
"""

import argparse
import ast
import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import json
import os
import runpy
import sys

REFERENCE = 'dynamite_tpu'
PORT = 'dynamite_tpu_torch'
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REFUSED = ('jax', 'jaxlib')

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
        for rec in self.files.values():
            rec['seconds'] = round(rec['seconds'], 3)
            terminalreporter.write_line(json.dumps(rec))


def run_pytest(args, device=None):
    """``pytest.main`` over ``args`` (test paths and pytest options) on the
    port, with :class:`ReferencePlugin`; returns pytest's exit code."""
    import pytest
    return int(pytest.main(['--noconftest', '-p', 'no:cacheprovider',
                            *args], plugins=[ReferencePlugin(device)]))


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


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m dynamite_tpu_torch.switch',
        description='Run a dynamite_tpu script, test files or a tutorial '
                    'notebook on dynamite_tpu_torch.')
    p.add_argument('--device', default=None,
                   help="config.device for the run (e.g. 'cpu'); default "
                        'the CUDA device')
    mode = p.add_mutually_exclusive_group()
    mode.add_argument('--pytest', action='store_true',
                      help='run pytest over the arguments that follow')
    mode.add_argument('--notebook', action='store_true',
                      help='run the notebook given as the argument')
    p.add_argument('script')
    p.add_argument('args', nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.pytest:
        return run_pytest([args.script] + args.args, device=args.device)
    if args.notebook:
        if args.args:
            p.error('--notebook takes one notebook and no arguments')
        run_notebook(args.script, device=args.device)
        return 0
    run_script(args.script, args.args, device=args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
