"""The traced run's reduction: from torch.profiler's raw events to device
seconds by layer, the device's busy share, and the breakdown.

The harness opens ``record_function`` ranges from its own files (``RANGES``:
the traced window, each step, each solve, each operator build, every
matvec, ``OperatorKernel.apply``, and its own agreement of the ranks on
the window's end after each step). A device operation (kernel, memcpy,
memset) is charged to the innermost range that held the host when it was
launched: the profiler gives the CUDA runtime call that launched it (the
same correlation id), whose start is looked up in the ranges; where that
call is missing, the start of the torch op or range the operation is
linked to stands in, and where that is missing too (a kernel launched by
a library with its own CUDA runtime), the recorded calls around it place
it (``_between``). Events stay in memory; only this summary leaves the
run.
"""

import numpy as np

WINDOW = 'portbench.window'
STEP = 'portbench.step'
SOLVE = 'portbench.solve'
BUILD = 'portbench.build'
MATVEC = 'portbench.matvec'
AGREE = 'portbench.agree'
RANGES = (WINDOW, STEP, SOLVE, BUILD, MATVEC, AGREE)
TOP = 10
NAME_MAX = 160


class _Intervals:
    """Non-overlapping [start, end) ranges of one kind, for lookups."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.start = np.array([s for s, _ in spans], dtype=np.int64)
        self.end = np.array([e for _, e in spans], dtype=np.int64)

    def __len__(self):
        return len(self.start)

    def holds(self, t):
        """Boolean array: each time of ``t`` inside one of the ranges."""
        t = np.asarray(t, dtype=np.int64)
        if not len(self.start):
            return np.zeros(t.shape, dtype=bool)
        i = np.searchsorted(self.start, t, side='right') - 1
        ok = i >= 0
        ok[ok] = t[ok] < self.end[i[ok]]
        return ok


def _union_seconds(starts, ends, lo, hi):
    """Seconds covered by the union of [starts, ends) clipped to [lo, hi),
    and the gaps [(start, end), ...] between covered parts."""
    order = np.argsort(starts, kind='stable')
    busy, gaps, cur = 0, [], lo
    for s, e in zip(starts[order], ends[order]):
        s, e = max(int(s), lo), min(int(e), hi)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy * 1e-9, gaps


def reduce(prof):
    """The summary of one rank's traced window (see the module docstring).

    Keys: window_s, busy_s, device_s by category ('matvec' inside a solve,
    'matvec_other', 'krylov' inside a solve outside its matvecs, 'build',
    'step_other', 'agree', 'outside'), matvecs (matvec ranges inside
    solves), matvec_ops (device operations charged to them), steps, nccl_s
    (NCCL kernels of the program: the harness's agreement left out), linked
    (the share of device operations given a host time), placed (those
    placed between recorded calls), device_ops and idle_gaps (the
    breakdown)."""
    events = prof.profiler.kineto_results.events()
    spans = {name: [] for name in RANGES}
    op_start = {}       # torch ops and ranges, by their own id
    launch_start = {}   # CUDA runtime calls, by CUPTI correlation id
    cpu_ops = []
    dev = []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith('CPU'):
            if e.linked_correlation_id() > 0:
                launch_start[e.correlation_id()] = e.start_ns()
                continue
            op_start[e.correlation_id()] = e.start_ns()
            if name in spans and e.is_user_annotation():
                spans[name].append((e.start_ns(), e.start_ns()
                                    + e.duration_ns()))
                continue
            cpu_ops.append((e.start_ns(), e.duration_ns(), name))
        elif name not in spans and not e.is_user_annotation():
            dev.append((e.start_ns(), e.duration_ns(), e.correlation_id(),
                        e.linked_correlation_id(), name))
    ids = np.array(sorted(launch_start), dtype=np.int64)
    starts = np.array([launch_start[i] for i in ids], dtype=np.int64)
    matvecs = _Intervals(spans[MATVEC])
    anchored, placed = [], 0
    for s, d, c, link, n in dev:
        a = launch_start.get(c, op_start.get(link, -1) if link else -1)
        if a < 0 and c > 0 and len(ids):
            a = _between(ids, starts, matvecs, c)
            placed += 1
        anchored.append((s, d, a, n))
    summary = _summary(spans, anchored, cpu_ops)
    summary['placed'] = placed
    return summary


def _between(ids, starts, matvecs, c):
    """The host time of a launch the profiler did not record (a kernel of a
    library linked to its own CUDA runtime, as the port's are), from the
    recorded runtime calls just before and after it (correlation ids are
    given in call order): the middle of the one matvec range that opened
    and closed between the two, if there is one, else the call before."""
    i = int(np.searchsorted(ids, c))
    lo = int(starts[i - 1]) if i > 0 else -1
    hi = int(starts[i]) if i < len(ids) else np.iinfo(np.int64).max
    inside = np.flatnonzero((matvecs.start > lo) & (matvecs.end < hi))
    if len(inside) == 1:
        j = inside[0]
        return int(matvecs.start[j] + matvecs.end[j]) // 2
    return lo


def _summary(spans, dev, cpu_ops):
    if not spans[WINDOW]:
        raise RuntimeError('the traced window recorded no range')
    lo, hi = spans[WINDOW][0]
    matvec = _Intervals(spans[MATVEC])
    solve = _Intervals(spans[SOLVE])
    build = _Intervals(spans[BUILD])
    step = _Intervals(spans[STEP])
    agree = _Intervals(spans[AGREE])
    start = np.array([d[0] for d in dev], dtype=np.int64)
    dur = np.array([d[1] for d in dev], dtype=np.int64)
    anchor = np.array([d[2] for d in dev], dtype=np.int64)
    names = [d[3] for d in dev]
    inside = (start + dur > lo) & (start < hi)
    in_mv = matvec.holds(anchor)
    in_solve = solve.holds(anchor)
    in_build = build.holds(anchor)
    in_step = step.holds(anchor)
    in_agree = agree.holds(anchor)
    cat = np.full(len(dev), 'outside', dtype=object)
    cat[in_step] = 'step_other'
    cat[in_build] = 'build'
    cat[in_solve] = 'krylov'
    cat[in_mv] = 'matvec_other'
    cat[in_mv & in_solve] = 'matvec'
    cat[in_agree] = 'agree'
    device_s = {}
    for c in ('matvec', 'matvec_other', 'krylov', 'build', 'step_other',
              'agree', 'outside'):
        sel = inside & (cat == c)
        device_s[c] = float(dur[sel].sum()) * 1e-9
    mv_starts = np.array([s for s, _ in spans[MATVEC]], dtype=np.int64)
    n_matvec = int(solve.holds(mv_starts).sum()) if len(mv_starts) else 0
    is_nccl = np.array(['nccl' in n.lower() for n in names], dtype=bool)
    busy_s, gaps = _union_seconds(start[inside], (start + dur)[inside],
                                  int(lo), int(hi))
    totals = {}
    for n, d, ok in zip(names, dur, inside):
        if ok:
            totals[n] = totals.get(n, 0) + int(d)
    device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    label = _HostLabel(spans, cpu_ops)
    return {
        'window_s': (hi - lo) * 1e-9,
        'busy_s': busy_s,
        'device_s': device_s,
        'matvecs': n_matvec,
        'matvec_ops': int((inside & (cat == 'matvec')).sum()),
        'steps': len(step),
        'nccl_s': float(dur[inside & is_nccl & ~in_agree].sum()) * 1e-9,
        'linked': float(np.mean(anchor >= 0)) if len(anchor) else 1.0,
        'device_ops': [[n[:NAME_MAX], d * 1e-9] for n, d in device_ops],
        'idle_gaps': [[label((a + b) // 2), (b - a) * 1e-9]
                      for a, b in gaps],
    }


class _HostLabel:
    """What the host was doing at a time: the innermost harness range and
    the outermost CPU operation running then."""

    def __init__(self, spans, cpu_ops):
        self.ranges = [(name.partition('.')[2], _Intervals(spans[name]))
                       for name in (WINDOW, STEP, AGREE, BUILD, SOLVE,
                                    MATVEC)]
        self.start = np.array([c[0] for c in cpu_ops], dtype=np.int64)
        self.end = self.start + np.array([c[1] for c in cpu_ops],
                                         dtype=np.int64)
        self.names = [c[2] for c in cpu_ops]

    def __call__(self, t):
        where = 'outside'
        for name, iv in self.ranges:
            if iv.holds([t])[0]:
                where = name
        op = 'host code'
        running = np.flatnonzero((self.start <= t) & (t < self.end))
        if len(running):
            op = self.names[running[np.argmin(self.start[running])]]
        return f'{where}: {op[:NAME_MAX]}'
