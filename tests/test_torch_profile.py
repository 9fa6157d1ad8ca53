"""
``config.profile_dir`` on the port: ``evolve`` and ``eigsolve`` wrapped in a
torch.profiler trace, one Chrome/TensorBoard trace file per call (the JAX
package's ``_maybe_profile``, through torch.profiler), on the CPU, with
the port's spans in it. The card's part of the trace (the kernel's name in
it) is checked by ``chip_smoke.py``'s phase ``examples``.
"""

import json
import os

import numpy as np
import pytest
import torch

from dynamite_tpu_torch import config, models
from dynamite_tpu_torch.states import State
from dynamite_tpu_torch.subspaces import Full

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 8


@pytest.fixture(autouse=True)
def cpu(monkeypatch, tmp_path):
    """The port on the CPU in float64, run from an empty directory;
    ``profile_dir`` and the other globals restored after the test."""
    for name in ('profile_dir', '_L', '_subspace'):
        monkeypatch.setattr(config, name, getattr(config, name))
    monkeypatch.setattr(config, '_device', torch.device('cpu'))
    monkeypatch.setattr(config, '_precision', 'double')
    config.profile_dir = None
    run_dir = tmp_path / 'run'
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)


def _solves():
    """One evolve and one eigsolve of localized(8) on Full(8): (the evolved
    planes, the eigenvalues)."""
    H = models.localized(L)
    H.add_subspace(Full(L=L))
    s = State(L=L, state='U' * (L // 2) + 'D' * (L // 2))
    evolved = H.evolve(s, 0.5).data.clone()
    return evolved, H.eigsolve(nev=2)


def test_one_trace_per_call(tmp_path):
    config.profile_dir = str(tmp_path / 'traces')
    _solves()
    files = sorted(os.listdir(tmp_path / 'traces'))
    assert len(files) == 2
    assert files[0].startswith('eigsolve_rank0.')
    assert files[1].startswith('evolve_rank0.')
    for name in files:
        assert name.endswith('.pt.trace.json')
        with open(tmp_path / 'traces' / name) as f:
            assert json.load(f)['traceEvents']


def test_unset_writes_nothing(tmp_path):
    _solves()
    assert os.listdir(tmp_path) == ['run']
    assert os.listdir(tmp_path / 'run') == []


def test_results_bitwise_equal(tmp_path):
    plain = _solves()
    config.profile_dir = str(tmp_path / 'traces')
    traced = _solves()
    assert torch.equal(plain[0], traced[0])
    assert np.array_equal(plain[1], traced[1])


def test_trace_names_the_ports_spans(tmp_path):
    """The evolve's trace holds the port's spans (``dynamite.solve.evolve``
    around the solve, ``dynamite.apply`` a matvec), recorded with spans on
    only while the profiler ran."""
    from dynamite_tpu_torch import tracing
    assert not tracing.enabled()
    config.profile_dir = str(tmp_path / 'traces')
    _solves()
    assert not tracing.enabled()
    name, = [n for n in os.listdir(tmp_path / 'traces')
             if n.startswith('evolve_rank0.')]
    with open(tmp_path / 'traces' / name) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'dynamite.solve.evolve', 'dynamite.apply'} <= names
