"""
The JAX package's own test suite on the port.

* The manifest (``tests/torch_reference_suite.py``) is checked against the
  tree: its lists (a) and (b) hold every reference test file once, every
  case of a (b) file has a mirror in the port's tests that exists, or a
  mark; every (c) exclusion names a test of an (a) file and gives a
  reason; every name the reference's tests, examples and tutorial import
  from the JAX package resolves on the port or is listed with why.
* Each (a) file runs unchanged on the port, on the CPU, through
  ``python -m dynamite_tpu_torch.switch --device cpu --pytest FILE`` in a
  subprocess at one thread, with pytest's own plugins only: exit 0, and
  passed = collected - skipped - excluded by (c), read from the switch's
  JSON line for the file.
"""

import ast
import importlib
import json
import os
import subprocess
import sys

import pytest

from tests.torch_reference_suite import (BENCHMARK_PR, EXCLUDED, MIRRORED,
                                         TPU_WORKAROUND, UNCHANGED,
                                         UNRESOLVED_NAMES)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
MARKS = (TPU_WORKAROUND, BENCHMARK_PR)


def _cases(path):
    """``name`` of each module-level ``def test_*`` and ``Class::name`` of
    each ``test_*`` method of a ``Test*`` class in a test file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith('test'):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith('Test'):
            out.update(f'{node.name}::{m.name}' for m in node.body
                       if isinstance(m, ast.FunctionDef)
                       and m.name.startswith('test'))
    return out


def _reference_files():
    return sorted(f'{d}/{name}' for d in ('unit', 'integration')
                  for name in os.listdir(os.path.join(TESTS, d))
                  if name.startswith('test_') and name.endswith('.py'))


def _imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ''] if isinstance(node, ast.ImportFrom)
                 else [])
        if any(n.split('.')[0] in ('jax', 'jaxlib') for n in names):
            return True
    return False


def test_manifest_lists_every_reference_file_once():
    files = _reference_files()
    listed = UNCHANGED + list(MIRRORED)
    assert sorted(listed) == files and len(set(listed)) == len(listed)
    for rel in UNCHANGED:
        assert not _imports_jax(os.path.join(TESTS, rel)), rel
    for rel, entry in MIRRORED.items():
        assert entry['why'], rel


@pytest.mark.parametrize('rel', sorted(MIRRORED))
def test_every_case_of_a_mirrored_file_has_a_mirror(rel):
    """The (b) file's cases are exactly the manifest's, and each names a
    port test that exists, or a mark."""
    cases = MIRRORED[rel]['cases']
    assert set(cases) == _cases(os.path.join(TESTS, rel))
    for case, mirror in cases.items():
        if mirror in MARKS:
            continue
        path, _, name = mirror.partition('::')
        assert path.startswith('test_torch_') and name, (case, mirror)
        assert name in _cases(os.path.join(TESTS, path)), (case, mirror)


def test_exclusions_name_tests_of_unchanged_files():
    for nodeid, reason in EXCLUDED.items():
        rel, _, case = nodeid.partition('::')
        assert rel in UNCHANGED and reason.strip(), nodeid
        assert case.split('[')[0] in _cases(os.path.join(TESTS, rel)), nodeid


def _reference_imports():
    """{(module, name)} of every ``from dynamite_tpu.X import name`` in the
    reference's tests, examples and tutorial (the port's own files and
    helpers left out)."""
    sources = []
    for root in (TESTS, os.path.join(REPO, 'examples')):
        for d, _dirs, names in os.walk(root):
            sources += [os.path.join(d, n) for n in names
                        if n.endswith('.py') and 'torch' not in n]
    out = {}
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.split('.')[0] == 'dynamite_tpu':
                for alias in node.names:
                    out.setdefault((node.module, alias.name), path)
    tutorial = os.path.join(REPO, 'examples', 'tutorial')
    for name in sorted(os.listdir(tutorial)):
        if name.endswith('.ipynb'):
            with open(os.path.join(tutorial, name)) as f:
                nb = json.load(f)
            for cell in nb['cells']:
                if cell['cell_type'] != 'code':
                    continue
                for node in ast.walk(ast.parse(''.join(cell['source']))):
                    if isinstance(node, ast.ImportFrom) and node.module \
                            and node.module.split('.')[0] == 'dynamite_tpu':
                        for alias in node.names:
                            out.setdefault((node.module, alias.name), name)
    return out


def _resolves(module, name):
    port = 'dynamite_tpu_torch' + module[len('dynamite_tpu'):]
    try:
        mod = importlib.import_module(port)
    except ImportError:
        return False
    if hasattr(mod, name):
        return True
    try:
        importlib.import_module(f'{port}.{name}')
    except ImportError:
        return False
    return True


def test_reference_names_resolve_on_the_port():
    imports = _reference_imports()
    assert ('dynamite_tpu.computations', 'MaxIterationsError') in imports
    missing = {key: where for key, where in imports.items()
               if not _resolves(*key)}
    assert set(missing) == set(UNRESOLVED_NAMES), missing
    assert all(reason.strip() for reason in UNRESOLVED_NAMES.values())


def run_on_port(rel, *extra, device='cpu', timeout=600):
    """One reference test file through the switch's ``--pytest`` mode in a
    subprocess at one thread; returns (exit code, its JSON record, the
    output)."""
    args = [sys.executable, '-m', 'dynamite_tpu_torch.switch']
    if device is not None:
        args += ['--device', device]
    args += ['--pytest', os.path.join('tests', rel), '-q', '-p',
             'no:randomly', *extra]
    for nodeid in EXCLUDED:
        if nodeid.startswith(rel + '::'):
            args += ['--deselect', os.path.join('tests', nodeid)]
    # pytest's own plugins only: the reference's files use no other, and
    # loading the installed ones (hypothesis, ...) costs ~2.5 s a process
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               MKL_NUM_THREADS='1', OPENBLAS_NUM_THREADS='1',
               PYTEST_DISABLE_PLUGIN_AUTOLOAD='1')
    proc = subprocess.run(args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"reference_file"')]
    rec = next((r for r in recs if r['reference_file'].endswith(rel)), None)
    return proc.returncode, rec, proc.stdout + proc.stderr


@pytest.mark.parametrize('rel', UNCHANGED)
def test_reference_file_on_port(rel):
    rc, rec, out = run_on_port(rel)
    assert rc == 0, out[-4000:]
    excluded = any(n.startswith(rel + '::') for n in EXCLUDED)
    assert rec is not None and rec['collected'] > 0, out[-4000:]
    assert (rec['excluded'] > 0) is excluded and rec['failed'] == 0
    assert rec['passed'] == (rec['collected'] - rec['skipped']
                             - rec['excluded'])
