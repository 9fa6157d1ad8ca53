"""
The port's own spans and counters: where a solve spends its host time,
layer by layer, and how often each piece of work ran.

    from dynamite_tpu_torch import tracing
    tracing.enable()
    H.eigsolve(nev=8)
    tracing.snapshot()
    # {'spans': {'apply': {'n': 618, 'host_s': ..., 'self_s': ...}, ...},
    #  'counters': {'apply.calls': 618, 'solver.syncs': 42, ...}}

A span (:func:`span`) times one stage of the program on the host clock
(``time.perf_counter_ns``). Spans nest: each name keeps its count, its
host seconds and its self seconds (its time less that of the spans opened
inside it), summed over every time it ran since :func:`reset`. Spans are
off by default: then :func:`span` reads one flag and returns a shared
context that does nothing. While a ``torch.profiler`` records, an enabled
span also opens ``record_function('dynamite.' + name)``, so the span sits
in the profiler's timeline, on the clock of its device trace; with
``config.profile_dir`` set, each solve's trace is taken with spans on.

Counters (:func:`count`) are always on: an integer add under a dotted
name, read with :func:`counters` or :func:`counter`.

The spans, at the boundaries of the port's layers:

* solver loop: ``solve.evolve``, ``solve.eigsolve``, ``solve.target``
  (``computations``), their phases ``solver.build``, ``solver.norm``,
  ``solver.solve``, ``solver.candidates``, ``solver.extract``;
  ``solver.lanczos`` (a whole Lanczos factorization), ``solver.sync`` (the
  host blocked on the device in ``solvers.krylov.host``), ``solver.ritz``
  (a restart's host numpy work), ``solver.workspace_check``,
  ``solver.stats`` (rank 0's stats sent to every rank), ``minres.solve``;
* operator build: ``build.msc`` (the operator's terms made ready),
  ``build.kernel`` (``OperatorKernel``), inside it ``build.sector_plan``
  with its stages ``build.sector_plan.states``, ``.channels``,
  ``.merge``, ``.diagonal``, ``.dedup``, and ``build.xor``, ``build.ell``,
  ``build.xor_dense``; ``build.upload`` (an engine's tables copied to a
  dtype and device, the first time);
* operator apply: ``apply`` (one a matvec, ``OperatorKernel.apply``, or
  ``apply_ranks`` called directly);
* Krylov basis: ``krylov.gram``, ``krylov.combine``, ``krylov.recombine``,
  ``krylov.norm``;
* transport: ``transport.<collective>`` (``parallel.multihost.collective``;
  the pairwise exchange of a matvec is ``transport.exchange``).

The counters: ``apply.calls``, ``build.kernels``, ``build.uploads``,
``solver.syncs`` (device-to-host reads of the solvers), ``minres.iterations``;
the engines' ``xor.launches``, ``xor.diagonal_launches``, ``ell.launches``,
``sector.applies``, ``sector.graph_captures`` and ``sector.graph_replays``
(the sector engine's CUDA graphs: ``graph_replays / applies`` is the share
of its applies that replayed one), ``sector.ring_applies``,
``xor_dense.applies``, ``sweep.applies``, ``rdm.spinconserve_index_builds``;
and
``transport.<collective>.calls`` with, where data moves,
``transport.<collective>.bytes`` (the bytes this rank sends; an all-gather
counts those it receives), ``transport.exchange.pairs``.

The tables are this process's (one rank's); spans are kept for one thread
at a time.
"""

import time
from collections import defaultdict

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_on = False
_spans = {}                 # name -> [n, host_ns, self_ns]
_counts = defaultdict(int)
_open = []                  # the spans open now, innermost last


class _Off:
    """The shared context of a span while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('name', 't0', 'inner', 'ranged')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.ranged = None
        if getattr(_profiler, '_is_profiler_enabled', True):
            self.ranged = record_function('dynamite.' + self.name)
            self.ranged.__enter__()
        self.inner = 0
        _open.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _open.pop()
        if _open:
            _open[-1].inner += dt
        rec = _spans.get(self.name)
        if rec is None:
            rec = _spans[self.name] = [0, 0, 0]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self.inner
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        return False


def span(name):
    """A context manager timing the stage ``name`` (see the module
    docstring); a shared no-op while spans are off."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counter(name):
    """The counter ``name`` (0 if it never counted)."""
    return _counts.get(name, 0)


def counters():
    """Every counter, as a new dict."""
    return dict(_counts)


def enable():
    """Turn spans on (counters always count)."""
    global _on
    _on = True


def disable():
    """Turn spans off."""
    global _on
    _on = False


def enabled():
    return _on


def reset():
    """Clear the span table and every counter."""
    _spans.clear()
    _counts.clear()


def snapshot():
    """``{'spans': {name: {'n', 'host_s', 'self_s'}}, 'counters': {...}}``
    since the last :func:`reset`."""
    return {'spans': {name: {'n': n, 'host_s': host * 1e-9,
                             'self_s': own * 1e-9}
                      for name, (n, host, own) in _spans.items()},
            'counters': counters()}
