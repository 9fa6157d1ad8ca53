"""Helpers of the benchmark's tests: a copy of the benchmark at small L,
and runs of a cell in a child process."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the sizes the CPU tests run each configuration at
TINY_L = {'floquet_L26': 10, 'floquet_L28x4': 10, 'mbl_L24': 10}


def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ under ``tmp_path`` whose
    configurations are cut to ``TINY_L`` (limits unchanged)."""
    root = os.path.join(str(tmp_path), 'checkout')
    shutil.copytree(os.path.join(ROOT, 'portbench'),
                    os.path.join(root, 'portbench'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), root)
    for name, L in TINY_L.items():
        path = os.path.join(root, 'portbench', 'configs', f'{name}.json')
        with open(path) as f:
            cfg = json.load(f)
        cfg['L'] = L
        if 'k' in cfg['space']:
            cfg['space']['k'] = L // 2
        with open(path, 'w') as f:
            json.dump(cfg, f)
    return root


def run_cell(root, cell, seed=7, seconds=1.0, trace=0, fault=None,
             precision=None, timeout=600):
    """A run of ``cell`` on the CPU in a child process (through
    ``portbench.tests.fault_rank``, which plants ``fault`` first). Returns
    (exit code, the result line's dict or None, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PORTBENCH_FAULT', None)
    if fault:
        env['PORTBENCH_FAULT'] = fault
    args = [sys.executable, '-m', 'portbench.tests.fault_rank',
            '--workload', cell, '--seed', str(seed), '--seconds',
            str(seconds), '--trace', str(trace), '--device', 'cpu',
            '--root', root]
    if precision:
        args += ['--precision', precision]
    out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else None
    return out.returncode, result, out.stderr


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp('tiny'))
