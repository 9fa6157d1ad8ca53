"""A configuration, a traffic mix and a per-layer metric are each added as
new files and manifest entries alone: no file already there is edited."""

import hashlib
import json
import os

from .conftest import run_cell, tiny_root


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, 'rb') as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(root, rel, text):
    path = os.path.join(root, rel)
    assert not os.path.exists(path), rel
    with open(path, 'w') as f:
        f.write(text)


def test_add_a_config_a_traffic_mix_and_a_metric(tmp_path):
    root = tiny_root(tmp_path)
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        manifest = json.load(f)
    before = _digests(os.path.join(root, 'portbench'))

    # a configuration with a term-list module of its own: the transverse
    # field Ising chain
    _write(root, 'portbench/hamiltonians/dummy_ising.py', '''
def terms(params, L, fields=None):
    out = [(params['J'], ((i, 'Z'), (i + 1, 'Z'))) for i in range(L - 1)]
    return out + [(params['g'], ((i, 'X'),)) for i in range(L)]


def pulse(params, L):
    return [(1.0, tuple((i, 'X') for i in range(L)))]
''')
    cfg = {'name': 'dummy_ising', 'source': 'https://example.org/ising',
           'reduced': [], 'assumed': {}, 'L': 9, 'space': {'kind': 'full'},
           'precision': 'double', 'chips': 1, 'hamiltonian': 'dummy_ising',
           'params': {'J': 1.0, 'g': 0.7, 'period': 0.3},
           'limits': {'state_gap': 1e-8, 'norm_gap': 1e-10}}
    _write(root, 'portbench/configs/dummy_ising.json', json.dumps(cfg))
    # a traffic mix that reuses the cycle loop with parameters of its own
    _write(root, 'portbench/traffic/dummy_short.json',
           json.dumps({'loop': 'cycles', 'about': 'a dummy mix',
                       'trace_steps': 2}))
    # a per-layer metric with a reader of its own, and one of a family
    # that has its reader (solver.matvecs_per_step.py): an entry alone
    _write(root, 'portbench/metrics/dummy.window_steps.py',
           'def read(run):\n    return float(len(run.steps))\n')
    manifest['configs'].append({
        'name': 'dummy_ising', 'source': cfg['source'],
        'file': 'portbench/configs/dummy_ising.json', 'reduced': [],
        'why': 'a dummy'})
    manifest['workloads'].append({
        'name': 'dummy_ising.short', 'config': 'dummy_ising',
        'traffic': 'dummy_short', 'chips': 1, 'why': 'a dummy'})
    manifest['end_to_end'][0]['workloads'].append('dummy_ising.short')
    manifest['per_layer'].append({
        'name': 'dummy.window_steps', 'unit': 'count', 'better': 'lower',
        'source': 'program_counter', 'layer': 'Solver loop (host)',
        'moves': manifest['end_to_end'][0]['name'],
        'workloads': ['dummy_ising.short']})
    manifest['per_layer'].append({
        'name': 'solver.matvecs_per_step.dummy', 'unit': 'count',
        'better': 'lower', 'source': 'program_counter',
        'layer': 'Solver loop (host)',
        'moves': manifest['end_to_end'][0]['name'],
        'workloads': ['dummy_ising.short']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(manifest, f)

    rc, result, err = run_cell(root, 'dummy_ising.short', trace=1)
    assert rc == 0, err[-3000:]
    assert result['correct'] is True
    assert result['metrics']['dummy.window_steps']['value'] == 2.0
    assert result['metrics']['solver.matvecs_per_step.dummy']['value'] > 0
    rc, result, err = run_cell(root, 'dummy_ising.short', trace=0,
                               seconds=0.5)
    assert rc == 0, err[-3000:]
    assert set(result['metrics']) == {manifest['end_to_end'][0]['name'],
                                      'setup_s'}
    after = _digests(os.path.join(root, 'portbench'))
    assert {k: v for k, v in after.items() if k in before} == before
