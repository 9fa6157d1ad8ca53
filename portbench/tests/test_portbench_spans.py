"""The per-layer metrics that read the program's own spans and counters
(``portbench/core/spans.py``): every one read in a traced run of its cell
at a size a test run holds, the idle split adding up to the idle share it
splits, the reduction on a made-up timeline, and nothing read from a port
without them."""

import math
import sys
import types

import pytest

from portbench.core import spans
from portbench.core.manifest import Manifest

from .conftest import run_cell

MBL = 'mbl_L24.extremal'
FLOQUET = 'floquet_L26.cycles'
X4 = 'floquet_L28x4.cycles'
IDLE = ('build', 'apply', 'krylov', 'solver', 'none')


def _new_metrics(cell):
    """The per-layer metrics of ``cell`` read by ``core/spans.py``."""
    readers = {}
    for m in Manifest().metrics('per_layer', cell):
        mod = Manifest().module('metrics', m['name'])
        if 'spans' in vars(mod):
            readers[m['name']] = m
    return readers


@pytest.mark.parametrize('cell', [MBL, FLOQUET, X4])
def test_a_traced_run_reads_every_new_metric(tiny, cell):
    rc, result, err = run_cell(tiny, cell, seed=2 ** 31 + 91, trace=1)
    assert rc == 0, err[-3000:]
    assert result['correct'] is True, result['checks']
    metrics = {k: v['value'] for k, v in result['metrics'].items()}
    wanted = _new_metrics(cell)
    assert wanted
    for name in wanted:
        assert name in metrics, (name, err[-3000:])
        assert math.isfinite(metrics[name]), name
    if cell == MBL:
        split = sum(metrics[f'idle.{layer}.eigsolve'] for layer in IDLE)
        assert abs(split - metrics['idle.step.eigsolve']) <= 0.5
        # nothing runs on a device here: every window is idle throughout
        assert abs(split - metrics['device.idle.eigsolve']) <= 0.5
        assert metrics['matvec.host_ms_per_apply.eigsolve'] > 0
        assert metrics['build.plan_s_per_step.eigsolve'] > 0
    if cell == FLOQUET:
        assert metrics['build.kernels_per_step.evolve'] == 0
        assert metrics['solver.host_syncs_per_step.evolve'] == 1.0
    if cell == X4:
        assert metrics['exchange.bytes_per_apply.x4'] > 0


class _Event:
    def __init__(self, name, start, end, cpu=True, annotation=True):
        self._name, self._start, self._dur = name, start, end - start
        self._cpu, self._annotation = cpu, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return 'DeviceType.CPU' if self._cpu else 'DeviceType.CUDA'

    def is_user_annotation(self):
        return self._annotation


def test_idle_charged_to_the_innermost_program_range():
    """A window of 100 ns: build [10, 30), a solve [40, 90) holding an
    apply [50, 60) and a sync [70, 80); kernels run [0, 20), [50, 55) and
    [70, 80). Idle: [20, 30) in the build, [40, 50) and [60, 70) and
    [80, 90) in the solver, [55, 60) in the apply, [30, 40) and [90, 100)
    in none."""
    events = [_Event(spans.WINDOW, 0, 100),
              _Event('dynamite.build.kernel', 10, 30),
              _Event('dynamite.solve.eigsolve', 40, 90),
              _Event('dynamite.apply', 50, 60),
              _Event('dynamite.solver.sync', 70, 80),
              _Event('aten::mm', 52, 54, annotation=False)]
    events += [_Event(f'k{i}', s, e, cpu=False, annotation=False)
               for i, (s, e) in enumerate([(0, 20), (50, 55), (70, 80)])]
    out = spans.reduce(events)
    assert out['window_s'] == pytest.approx(100e-9)
    assert out['busy_s'] == pytest.approx(35e-9)
    want = {'build': 10, 'apply': 5, 'krylov': 0, 'solver': 30,
            'transport': 0, 'none': 20}
    assert out['idle_s'] == pytest.approx({k: v * 1e-9
                                           for k, v in want.items()})


def test_a_port_without_tracing_reads_nothing(monkeypatch):
    import dynamite_tpu_torch
    monkeypatch.delattr(dynamite_tpu_torch, 'tracing', raising=False)
    monkeypatch.setitem(sys.modules, 'dynamite_tpu_torch.tracing', None)
    run = types.SimpleNamespace(world=1)
    assert spans.program_tracing() is None
    assert spans.counters() is None
    assert spans.host(run) is None and spans.idle(run) is None
    for cell in (MBL, FLOQUET, X4):
        for name in _new_metrics(cell):
            assert Manifest().module('metrics', name).read(run) is None
