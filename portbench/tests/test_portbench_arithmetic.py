"""The byte and operation arithmetic of ``matvec_roofline``, the window
arithmetic of the step metrics, and the trace reduction on synthetic
events."""

import types

import numpy as np
import pytest

from portbench.core import readers, roofline, trace
from portbench.core.manifest import Manifest
from portbench.hamiltonians import floquet, mbl
from portbench.reference import full, pauli, sector

MAN = Manifest()


def test_least_time_by_bytes():
    # Full(26), f64: x read once and y written once, both planes
    rows = 1 << 26
    s, by = roofline.least_seconds(rows, 8, 0, 'float64')
    assert by == 'bytes'
    assert s == pytest.approx(2 * 2 * 8 * rows / 3.35e12, rel=1e-15)
    assert s * 1e3 == pytest.approx(0.6410, abs=1e-4)
    s, by = roofline.least_seconds(1, 4, 1e9, 'float32')
    assert by == 'operations' and s == pytest.approx(1e9 / 67e12)


def _dense_flops(D):
    return 4 * int(np.count_nonzero(D.real) + np.count_nonzero(D.imag))


def test_full_flops_count_the_nonzeros():
    L = 8
    for terms in (floquet.terms(MAN.config('floquet_L26')['params'], L),
                  floquet.pulse({}, L)):
        op = full.FullOperator(terms, L, 'cpu')
        assert roofline.full_flops(op) == _dense_flops(pauli.dense(terms, L))


def test_sector_flops_count_the_nonzeros():
    L = 10
    params = MAN.config('mbl_L24')['params']
    terms = mbl.terms(params, L, mbl.draw_fields(
        params, L, np.random.default_rng(0)))
    op = sector.SectorOperator(terms, L, L // 2, 'cpu')
    states = sector.sector_states(L, L // 2, 'cpu').numpy()
    D = pauli.dense(terms, L)[np.ix_(states, states)]
    assert roofline.sector_flops(op) == _dense_flops(D)


def _run(**kw):
    run = types.SimpleNamespace(steps=[], window_s=None, summary=None,
                                study=None, peak_bytes=None, setup_s=None)
    run.__dict__.update(kw)
    return run


def test_window_arithmetic():
    run = _run(steps=[{'matvecs': 31, 'host_syncs': 1}] * 4
               + [{'matvecs': 62, 'host_syncs': 2}], window_s=10.0)
    assert readers.step_seconds(run) == 2.0
    assert readers.per_step(run, 'matvecs') == pytest.approx(37.2)
    assert readers.per_step(run, 'build_s') is None
    assert readers.step_seconds(_run()) is None
    for name in ('evolve_step_s', 'eigsolve_step_s', 'evolve_step_x4_s'):
        assert MAN.module('metrics', name).read(run) == 2.0


def _events(window, steps, solves, matvecs, dev, agree=()):
    """A summary from synthetic ranges and (start, duration, anchor, name)
    device events."""
    spans = {n: [] for n in trace.RANGES}
    spans[trace.WINDOW] = [window]
    spans[trace.STEP] = steps
    spans[trace.SOLVE] = solves
    spans[trace.MATVEC] = matvecs
    spans[trace.AGREE] = list(agree)
    return trace._summary(spans, dev, [(0, 1000, 'aten::mm')])


def test_trace_reduction():
    s = _events((0, 1000), [(0, 850)], [(100, 600)],
                [(150, 200), (300, 350), (700, 750)],
                [(160, 100, 160, 'xor_apply_kernel'),      # matvec in a solve
                 (310, 100, 310, 'xor_apply_kernel'),      # matvec in a solve
                 (420, 50, 410, 'gemv'),                   # krylov
                 (720, 20, 710, 'xor_apply_kernel'),       # the pulse
                 (800, 40, 800, 'ncclDevKernel_SendRecv'),  # step, outside
                 (900, 10, 880, 'ncclDevKernel_Broadcast'),  # the agreement
                 (1500, 10, 990, 'late')],                 # after the window
                agree=[(860, 950)])
    assert s['matvecs'] == 2 and s['matvec_ops'] == 2
    assert s['device_s']['matvec'] == pytest.approx(200e-9)
    assert s['device_s']['krylov'] == pytest.approx(50e-9)
    assert s['device_s']['matvec_other'] == pytest.approx(20e-9)
    assert s['device_s']['step_other'] == pytest.approx(40e-9)
    assert s['device_s']['agree'] == pytest.approx(10e-9)
    assert s['nccl_s'] == pytest.approx(40e-9)
    # the union: [160, 260) [310, 410) [420, 470) [720, 740) [800, 840)
    # [900, 910)
    assert s['busy_s'] == pytest.approx(320e-9)
    assert s['window_s'] == pytest.approx(1000e-9)
    assert s['idle_gaps'][0][1] == pytest.approx(250e-9)   # [470, 720)
    assert s['device_ops'][0][0] == 'xor_apply_kernel'
    run = _run(summary=s, study=types.SimpleNamespace(
        work=(1 << 10, 8, 0, 'float64')))
    assert readers.idle_percent(run) == pytest.approx(68.0)
    assert readers.launches_per_apply(run) == 1.0
    least, _ = roofline.least_seconds(1 << 10, 8, 0, 'float64')
    assert readers.matvec_roofline(run) == pytest.approx(
        least / 100e-9 * 100)
    assert readers.device_ms_per_step(run, 'krylov') == pytest.approx(5e-5)


def test_readers_find_nothing():
    empty = _events((0, 10), [], [], [], [])
    run = _run(summary=empty, study=types.SimpleNamespace(work=None))
    assert readers.matvec_roofline(run) is None
    assert readers.launches_per_apply(run) is None
    assert readers.nccl_ms_per_step(run) is None
    assert readers.device_ms_per_step(run, 'krylov') is None
    assert readers.idle_percent(run) == 100.0


def test_peak_memory_reader():
    for name in ('peak_mem_gb', 'peak_mem_gb.eigsolve'):
        assert MAN.module('metrics', name).read(
            _run(peak_bytes=38_500_000_000)) == 38.5
        assert MAN.module('metrics', name).read(_run()) is None


def test_a_launch_the_profiler_did_not_record():
    """Placed by the recorded runtime calls around it (correlation ids in
    call order): inside the one matvec range between them, else after the
    call before."""
    ids = np.array([10, 20, 30])
    starts = np.array([100, 200, 300])
    matvecs = trace._Intervals([(120, 180), (210, 220), (230, 240)])
    assert trace._between(ids, starts, matvecs, 15) == 150
    assert trace._between(ids, starts, matvecs, 25) == 200
    assert trace._between(ids, starts, matvecs, 35) == 300
    assert trace._between(ids, starts, matvecs, 5) == -1
