"""
Run a script written for :mod:`dynamite_tpu` on this port, unchanged.

    python -m dynamite_tpu_torch.switch [--device cpu] SCRIPT [ARGS...]

The script's ``import dynamite_tpu`` and every ``dynamite_tpu.x.y`` reach
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
JAX package's ``dynamite_tpu``. The script runs as ``python SCRIPT ARGS``
runs it: its directory first on ``sys.path``, ``sys.argv`` set, as
``__main__``. ``--device cpu`` sets ``config.device = 'cpu'`` first;
without it the port runs on the CUDA device, and raises where there is
none. Scripts set the port's global configuration, so run each in a fresh
process.
"""

import argparse
import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import os
import runpy
import sys

REFERENCE = 'dynamite_tpu'
PORT = 'dynamite_tpu_torch'
_REFUSED = ('jax', 'jaxlib')


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
        return self.module

    def exec_module(self, module):
        pass


class PortFinder(importlib.abc.MetaPathFinder):
    """Serves the JAX package's module names from the port and refuses
    JAX (see the module docstring)."""

    def __init__(self, script):
        self.script = script

    def find_spec(self, fullname, path=None, target=None):
        if _top(fullname) in _REFUSED:
            port = _script_port(self.script)
            hint = (f'; run its port {port} instead' if port else
                    '; it cannot run on the port unchanged')
            raise ImportError(f'{self.script} imports {fullname}{hint}',
                              name=fullname)
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


def run_script(path, argv=(), device=None):
    """Run the script at ``path`` with arguments ``argv`` as ``__main__``
    on the port (see the module docstring); ``device`` sets
    ``config.device`` first. The finder, ``sys.argv`` and ``sys.path`` are
    restored afterwards; the aliases the script imported stay in
    ``sys.modules``."""
    _check_clean()
    path = os.path.abspath(path)
    if device is not None:
        from dynamite_tpu_torch import config
        config.device = device
    finder = PortFinder(path)
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.meta_path.insert(0, finder)
    sys.argv = [path] + list(argv)
    sys.path.insert(0, os.path.dirname(path))
    try:
        runpy.run_path(path, run_name='__main__')
    finally:
        sys.meta_path.remove(finder)
        sys.argv, sys.path[:] = saved_argv, saved_path


def main(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m dynamite_tpu_torch.switch',
        description='Run a dynamite_tpu script on dynamite_tpu_torch.')
    p.add_argument('--device', default=None,
                   help="config.device for the run (e.g. 'cpu'); default "
                        'the CUDA device')
    p.add_argument('script')
    p.add_argument('args', nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    run_script(args.script, args.args, device=args.device)


if __name__ == '__main__':
    main()
