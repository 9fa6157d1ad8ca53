"""The manifest against the benchmark's contract, and every name in it
against the file that serves it."""

import json
import os

import pytest

from portbench.core.manifest import NAME, UNIT, Manifest

MAN = Manifest()
DATA = MAN.data
CELLS = {w['name']: w for w in DATA['workloads']}
METRICS = DATA['end_to_end'] + DATA['per_layer']
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def test_top_level_keys():
    assert set(DATA) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert DATA['command'] == ['python3', 'portbench/run.py']
    assert DATA['paths'] == ['portbench']
    assert 1 <= DATA['run_seconds'] <= 51
    assert len(json.dumps(DATA)) < 64 * 1024


def test_names_and_units():
    names = ([c['name'] for c in DATA['configs']] + list(CELLS)
             + [m['name'] for m in METRICS])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in DATA['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
    for m in METRICS:
        assert UNIT.match(m['unit']), m
        assert m['better'] in ('lower', 'higher')
        assert m['source'] in SOURCES


def test_entry_keys():
    for c in DATA['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert 1 <= len(c['why']) <= 200 and 1 <= len(c['source']) <= 200
    for w in DATA['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and 1 <= len(w['why']) <= 200
    for m in DATA['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25
    for m in DATA['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'source', 'layer', 'moves'}


def test_setup_s_everywhere():
    e2e = {m['name']: m for m in DATA['end_to_end']}
    assert e2e['setup_s']['bound'] == 0.25
    for cell in CELLS:
        reported = [m['name'] for m in MAN.metrics('end_to_end', cell)]
        assert 'setup_s' in reported and len(reported) >= 2
        assert MAN.metrics('per_layer', cell)


def test_moves_reported_in_the_same_cells():
    e2e = {m['name']: m for m in DATA['end_to_end']}
    for m in DATA['per_layer']:
        moved = e2e[m['moves']]
        for cell in m['workloads']:
            assert cell in moved.get('workloads', CELLS), (m['name'], cell)


def test_one_layer_name_a_layer():
    by_prefix = {}
    for m in DATA['per_layer']:
        by_prefix.setdefault(m['name'].split('.')[0].split('_')[0],
                             set()).add(m['layer'])
    for layers in by_prefix.values():
        assert len(layers) == 1


def test_at_most_one_four_chip_cell():
    four = [w['name'] for w in DATA['workloads'] if w['chips'] == 4]
    assert four == ['floquet_L28x4.cycles']


def test_configs_files_and_sources():
    used = {w['config'] for w in DATA['workloads']}
    assert used == {c['name'] for c in DATA['configs']}
    files = [c['file'] for c in DATA['configs']]
    assert len(files) == len(set(files))
    sources = [c['source'] for c in DATA['configs']]
    assert len(sources) == len(set(sources))
    for c in DATA['configs']:
        assert c['file'].startswith('portbench/configs/')
        cfg = MAN.config(c['name'])
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced'] and len(cfg['reduced']) <= 16
        for key in cfg['reduced']:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(('_dim', '_rank'))
        assert 'assumed' in cfg and cfg['precision'] in ('single', 'double')
        for w in DATA['workloads']:
            if w['config'] == c['name']:
                assert w['chips'] == cfg['chips']


@pytest.mark.parametrize('name', [m['name'] for m in METRICS])
def test_every_metric_has_a_reader(name):
    assert callable(MAN.module('metrics', name).read)


@pytest.mark.parametrize('cell', list(CELLS))
def test_every_cell_finds_its_parts(cell):
    w = CELLS[cell]
    traffic = MAN.traffic(w['traffic'])
    assert MAN.module('loops', traffic['loop']).Study
    cfg = MAN.config(w['config'])
    assert MAN.module('hamiltonians', cfg['hamiltonian']).terms
    assert cfg['limits']


def test_paths_hold_only_the_benchmark():
    root = MAN.root
    for dirpath, _, files in os.walk(os.path.join(root, 'portbench')):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            if '__pycache__' in rel:
                continue
            assert all(ch.isalnum() or ch in '_.-/' for ch in rel), rel
