"""``python -m portbench.tests.fault_rank ARGS``: ``portbench/run.py ARGS``
with one fault planted in the port first, named by the environment's
``PORTBENCH_FAULT`` (unset: no fault). Over several ranks the ranks run
this module too, so each has the fault. For the benchmark's own tests."""

import os
import sys

import numpy as np


def _evolve_unchanged():
    from dynamite_tpu_torch import computations

    def evolve(H, state, t, result=None, **kwargs):
        return state.copy(result)

    computations.evolve = evolve


def _evolve_altered():
    from dynamite_tpu_torch import computations
    plain = computations.expmv

    def expmv(*args, **kwargs):
        w = plain(*args, **kwargs)
        w[0, 0] += 1e-6
        return w

    computations.expmv = expmv


def _no_exchange():
    from dynamite_tpu_torch.ops import apply

    def exchange(x_local, tables, bufs):
        return [x_local for _ in tables.hi_list]

    apply.exchange = exchange


def _eigsolve(change):
    from dynamite_tpu_torch import computations
    plain = computations.eigsolve

    def eigsolve(H, *args, **kwargs):
        evals, evecs = plain(H, *args, **kwargs)
        return change(kwargs, np.array(evals), list(evecs))

    computations.eigsolve = eigsolve


def _eigsolve_stale():
    first = {}

    def change(kwargs, evals, evecs):
        return first.setdefault(kwargs.get('which'), (evals, evecs))

    _eigsolve(change)


def _eigsolve_altered():
    def change(kwargs, evals, evecs):
        evals[0] += 1e-6 * max(1.0, abs(evals[0]))
        return evals, evecs

    _eigsolve(change)


def _eigsolve_half():
    def change(kwargs, evals, evecs):
        n = kwargs['nev'] // 2
        return evals[:n], evecs[:n]

    _eigsolve(change)


FAULTS = {
    'evolve_unchanged': _evolve_unchanged,
    'evolve_altered': _evolve_altered,
    'no_exchange': _no_exchange,
    'eigsolve_stale': _eigsolve_stale,
    'eigsolve_altered': _eigsolve_altered,
    'eigsolve_half': _eigsolve_half,
}


def main():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from portbench import run
    from portbench.core import harness
    harness.RANK_MODULE = __name__ if __name__ != '__main__' else \
        'portbench.tests.fault_rank'
    fault = os.environ.get('PORTBENCH_FAULT')
    if fault:
        FAULTS[fault]()
    return run.main(sys.argv[1:])


if __name__ == '__main__':
    sys.exit(main())
