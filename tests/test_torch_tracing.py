"""
The port's spans and counters (``dynamite_tpu_torch.tracing``) on the CPU:
off by default (no span recorded, no ``record_function`` opened, counters
still counting), on (the names at each layer, their nesting, self time as
the span's time less its children's), under ``torch.profiler`` (a
``dynamite.apply`` range around the torch ops of its apply, on the clock
the trace keeps), and ``last_solve_stats['host_syncs']`` as the count of
the solvers' device-to-host reads.
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamite_tpu_torch import computations, config, models, tracing
from dynamite_tpu_torch.parallel import multihost
from dynamite_tpu_torch.solvers import krylov
from dynamite_tpu_torch.states import State
from dynamite_tpu_torch.subspaces import Full, SpinConserve

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu():
    """The port on the CPU; spans off and the tables empty before and after
    each test."""
    saved_device, saved_L = config._device, config._L
    config.device = 'cpu'
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()
    config._device, config._L = saved_device, saved_L


def _sc(L=10):
    sub = SpinConserve(L, L // 2)
    H = models.heisenberg(L)
    H.add_subspace(sub)
    return H, sub


def _profiled(fn):
    """fn() under torch.profiler (CPU): its result and the profiler's
    events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def _ranges(events, prefix='dynamite.'):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in events if e.name().startswith(prefix)]


def test_off_records_no_span_but_counts():
    H, sub = _sc(8)
    kernel = H.get_mat()
    x = torch.ones((2, sub.get_dimension()), dtype=torch.float64)
    calls = tracing.counter('apply.calls')
    assert tracing.span('apply') is tracing.span('solve.evolve')
    _, events = _profiled(lambda: kernel.apply(x))
    assert _ranges(events) == []
    snap = tracing.snapshot()
    assert snap['spans'] == {}
    assert tracing.counter('apply.calls') == calls + 1
    assert snap['counters']['sector.applies'] >= 1


def test_self_time_is_time_less_children():
    tracing.enable()
    with tracing.span('outer'):
        time.sleep(0.002)
        for _ in range(2):
            with tracing.span('inner'):
                time.sleep(0.001)
                with tracing.span('leaf'):
                    time.sleep(0.001)
    spans = tracing.snapshot()['spans']
    assert spans['outer']['n'] == 1 and spans['inner']['n'] == 2
    assert spans['leaf']['n'] == 2
    for name, child in (('outer', 'inner'), ('inner', 'leaf')):
        rec = spans[name]
        assert rec['self_s'] == pytest.approx(
            rec['host_s'] - spans[child]['host_s'], abs=1e-9)
    assert spans['leaf']['self_s'] == spans['leaf']['host_s']
    assert spans['outer']['self_s'] >= 0.002
    tracing.reset()
    assert tracing.snapshot() == {'spans': {}, 'counters': {}}


def test_eigsolve_spans_at_every_layer():
    """An SC(10, 5) build and eigsolve with spans on: the names of each
    layer, and each span inside its parent in the profiler's record."""
    tracing.enable()
    H, _sub = _sc()

    def solve():
        H.build_mat()
        return H.eigsolve(nev=2)

    _, events = _profiled(solve)
    spans = tracing.snapshot()['spans']
    for name in ('build.msc', 'build.kernel', 'build.sector_plan',
                 'build.sector_plan.states', 'build.sector_plan.channels',
                 'build.sector_plan.merge', 'build.sector_plan.diagonal',
                 'build.sector_plan.dedup', 'build.conserves',
                 'build.upload', 'solve.eigsolve', 'solver.solve',
                 'solver.lanczos', 'solver.sync', 'solver.ritz',
                 'solver.stats', 'apply', 'krylov.gram', 'krylov.combine',
                 'krylov.norm', 'krylov.recombine'):
        assert spans[name]['n'] >= 1, name
        assert 0 <= spans[name]['self_s'] <= spans[name]['host_s']
    stats = computations.last_solve_stats
    assert spans['apply']['n'] == stats['matvecs']
    assert spans['solver.sync']['n'] == stats['host_syncs']
    counters = tracing.counters()
    assert counters['build.kernels'] == counters['build.uploads'] == 1

    ranges = _ranges(events)

    def inside(child, parent):
        outer = [(s, e) for n, s, e in ranges if n == 'dynamite.' + parent]
        kids = [(s, e) for n, s, e in ranges if n == 'dynamite.' + child]
        assert kids and outer
        return all(any(a <= s and e <= b for a, b in outer)
                   for s, e in kids)

    assert inside('build.sector_plan', 'build.kernel')
    assert inside('build.sector_plan.channels', 'build.sector_plan')
    assert inside('solver.solve', 'solve.eigsolve')
    assert inside('solver.lanczos', 'solver.solve')
    assert inside('apply', 'solver.lanczos')
    assert inside('krylov.gram', 'solver.solve')
    assert inside('solver.sync', 'solver.solve')
    assert inside('build.upload', 'apply')


def test_apply_range_brackets_its_torch_ops():
    """The dynamite.apply range of the profiler's record holds the torch
    ops the sector engine runs for it, on the trace's own clock."""
    H, sub = _sc(8)
    kernel = H.get_mat()
    x = torch.ones((2, sub.get_dimension()), dtype=torch.float64)
    kernel.apply(x)  # the tables' upload
    tracing.enable()
    _, events = _profiled(lambda: kernel.apply(x))
    (name, lo, hi), = _ranges(events)
    assert name == 'dynamite.apply'
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.name() in ('aten::baddbmm_', 'aten::mul', 'aten::addmm_')]
    assert ops
    assert all(lo <= s and e <= hi for s, e in ops)


def test_collective_span_and_counter():
    tracing.enable()

    def _probe(v):
        return v + 1

    assert multihost.collective(_probe, 4) == 5
    assert multihost.collective(_probe, 1, name='exchange') == 2
    counters, spans = tracing.counters(), tracing.snapshot()['spans']
    assert counters['transport.probe.calls'] == 1
    assert counters['transport.exchange.calls'] == 1
    assert spans['transport.probe']['n'] == spans['transport.exchange']['n']


def _counting_host(monkeypatch):
    calls = []
    plain = krylov.host

    def host(t):
        calls.append(1)
        return plain(t)

    monkeypatch.setattr(krylov, 'host', host)
    return calls


def test_eigsolve_host_syncs_are_the_host_reads(monkeypatch):
    """SC(10, 5), the lowest two: host_syncs counts every device-to-host
    read of the solve, those of the first factorization among them."""
    H, _sub = _sc()
    H.build_mat()
    calls = _counting_host(monkeypatch)
    H.eigsolve(nev=2)
    stats = computations.last_solve_stats
    assert stats['host_syncs'] == len(calls) > 0
    assert stats['host_syncs'] == 2 + 2 * (stats['restarts']
                                           + stats['verify_cycles'])


def test_evolve_host_syncs_one_a_substep(monkeypatch):
    H = models.localized(10)
    H.add_subspace(Full(L=10))
    psi = State(L=10, state='U' * 5 + 'D' * 5)
    calls = _counting_host(monkeypatch)
    H.evolve(psi, t=2.0)
    stats = computations.last_solve_stats
    assert stats['substeps'] >= 2
    assert stats['host_syncs'] == stats['substeps'] == len(calls)
