"""On a card: the one-card cells at a size a test run holds, through the
benchmark's own command (the look for a card included), sound and with
the control. Skipped where there is no CUDA card.

    python -m pytest -p no:cacheprovider -m cuda \
        portbench/tests/test_portbench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT, tiny_root

CARD_L = {'floquet_L26': 20, 'mbl_L24': 16}


@pytest.fixture
def card_root(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    root = tiny_root(tmp_path)
    for name, L in CARD_L.items():
        path = os.path.join(root, 'portbench', 'configs', f'{name}.json')
        with open(path) as f:
            cfg = json.load(f)
        cfg['L'] = L
        if 'k' in cfg['space']:
            cfg['space']['k'] = L // 2
        with open(path, 'w') as f:
            json.dump(cfg, f)
    return root


def _run(root, cell, *extra):
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', cell, '--seed',
         '2147483999', '--seconds', '2', '--trace', '0', '--root', root,
         *extra], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['floquet_L26.cycles', 'mbl_L24.extremal'])
def test_card_run_and_control(card_root, cell):
    result = _run(card_root, cell)
    assert result['correct'] is True, result['checks']
    assert result['device']['platform'] == 'gpu'
    control = _run(card_root, cell, '--precision', 'single')
    assert control['correct'] is False, control['checks']
