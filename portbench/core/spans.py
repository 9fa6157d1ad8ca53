"""The program's own spans and counters (``dynamite_tpu_torch.tracing``)
for the per-layer metrics that read them, in a traced run.

The harness leaves the program's spans off in its window (they cost a
flag read each there). These readers take the program's numbers in phases
of their own, after the window and its check, on rank 0 of a one-card
cell, with a fresh ``Study`` of the cell's loop (the harness's is
released by then) and one warm-up step:

1. spans alone (:func:`host`): one step (step 0) with spans on and no
   profiler: the program's host time by span, at close to the untraced
   pace, and its counters over the step;
2. spans under torch.profiler (:func:`idle`): step 0 again, profiled with
   spans on. Each idle interval of the device in that step's window is
   charged to the layer of the innermost ``dynamite.*`` range the host
   was in at that moment (``LAYERS``; ``none`` outside every program
   range: the harness's code, or program code with no span).

Counters over the whole run (:func:`counters`) need no phase: they are
always on, and every rank's own. On a port without ``tracing`` (the
parent of the change that brought it) every reader reads None, as over
several cards those that need a phase do.
"""

import sys
import traceback

import numpy as np

from . import port, trace

WINDOW = 'portbench.spans.window'
# the layer of each span by its first word (PERF.md's layers)
LAYERS = {'build': 'build', 'apply': 'apply', 'krylov': 'krylov',
          'solve': 'solver', 'solver': 'solver', 'minres': 'solver',
          'transport': 'transport'}
PREFIX = 'dynamite.'


def program_tracing():
    """The program's tracing module, or None."""
    try:
        from dynamite_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def counters():
    """This rank's program counters over the run so far, or None."""
    tracing = program_tracing()
    return None if tracing is None else tracing.counters()


def host(run):
    """Phase 1: ``tracing.snapshot()`` of one step with spans alone."""
    return _phase(run, 'host', _host)


def idle(run):
    """Phase 2: {'window_s', 'busy_s', 'idle_s': {layer: seconds}} of one
    profiled step with spans on."""
    return _phase(run, 'idle', _idle)


def _phase(run, key, fn):
    cache = run.__dict__.setdefault('program_phases', {})
    if key not in cache:
        cache[key] = None
        tracing = program_tracing()
        if tracing is not None and run.world == 1:
            try:
                cache[key] = fn(run, tracing)
            except Exception:
                sys.stderr.write(f'the program\'s {key} phase failed:\n'
                                 + traceback.format_exc())
            finally:
                tracing.disable()
    return cache[key]


def _study(run):
    cache = run.__dict__.setdefault('program_phases', {})
    if 'study' not in cache:
        # the program's configuration is the run's already: it is started
        # once a process
        start, port.start = port.start, lambda *args, **kwargs: None
        try:
            study = run.loop.Study(run)
        finally:
            port.start = start
        study.step(0, {})
        run.sync()
        cache['study'] = study
    return cache['study']


def _host(run, tracing):
    study = _study(run)
    tracing.reset()
    tracing.enable()
    study.step(0, {})
    tracing.disable()
    run.sync()
    return tracing.snapshot()


def _idle(run, tracing):
    from torch.profiler import ProfilerActivity, profile, record_function
    study = _study(run)
    acts = [ProfilerActivity.CPU]
    if run.on_card():
        acts.append(ProfilerActivity.CUDA)
    tracing.enable()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            study.step(0, {})
            run.sync()
    tracing.disable()
    out = reduce(prof.profiler.kineto_results.events())
    del prof
    sys.stderr.write(f'the program\'s profiled step: window '
                     f'{out["window_s"]:.4f} s, device idle '
                     f'{100 * (1 - out["busy_s"] / out["window_s"]):.4f}%, '
                     f'by layer (s): {out["idle_s"]}\n')
    return out


def reduce(events):
    """The device's idle seconds in the ``WINDOW`` range, by the layer of
    the innermost program range the host was in (see the module
    docstring), from torch.profiler's raw events."""
    window, ranges, starts, ends = None, [], [], []
    for e in events:
        name = e.name()
        cpu = str(e.device_type()).endswith('CPU')
        if cpu and e.is_user_annotation():
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if name == WINDOW:
                window = span
            elif name.startswith(PREFIX):
                word = name[len(PREFIX):].partition('.')[0]
                ranges.append((*span, LAYERS.get(word, 'other')))
        elif not cpu and not e.is_user_annotation():
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
    if window is None:
        raise RuntimeError('the profiled step recorded no window')
    lo, hi = window
    busy_s, gaps = trace._union_seconds(np.array(starts, dtype=np.int64),
                                        np.array(ends, dtype=np.int64),
                                        lo, hi)
    pieces = _innermost(ranges, lo, hi)
    idle_ns = {layer: 0 for layer in (*sorted(set(LAYERS.values())),
                                      'none')}
    i = j = 0
    while i < len(gaps) and j < len(pieces):
        a = max(gaps[i][0], pieces[j][0])
        b = min(gaps[i][1], pieces[j][1])
        if b > a:
            layer = pieces[j][2]
            idle_ns[layer] = idle_ns.get(layer, 0) + b - a
        if gaps[i][1] < pieces[j][1]:
            i += 1
        else:
            j += 1
    return {'window_s': (hi - lo) * 1e-9, 'busy_s': busy_s,
            'idle_s': {k: v * 1e-9 for k, v in idle_ns.items()}}


def _innermost(ranges, lo, hi):
    """[lo, hi) cut into (start, end, layer) pieces, each under one
    innermost range of ``ranges`` (properly nested (start, end, layer)
    triples; 'none' outside all of them)."""
    pieces, stack = [], []
    now = lo

    def close(upto):
        nonlocal now
        upto = min(upto, hi)
        if upto > now:
            pieces.append((now, upto, stack[-1][1] if stack else 'none'))
            now = upto

    for start, end, layer in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= start:
            close(stack[-1][0])
            stack.pop()
        close(start)
        stack.append((end, layer))
    while stack:
        close(stack[-1][0])
        stack.pop()
    close(hi)
    return pieces


def idle_percent(run, layer):
    """The share of phase 2's window in which the device idled while the
    host was in ``layer``, in %."""
    out = idle(run)
    if not out or not out['window_s']:
        return None
    return out['idle_s'].get(layer, 0.0) / out['window_s'] * 100


def span_seconds(run, name):
    """Phase 1's host seconds in the span ``name`` (0 if it never ran)."""
    out = host(run)
    if out is None:
        return None
    return out['spans'].get(name, {}).get('host_s', 0.0)
