"""
The tutorial notebooks (``examples/tutorial``, notebooks 1-6) on both
packages, and the comparison of two runs' outputs cell by cell:
``tests/test_torch_tutorial.py`` holds the port's run on the CPU against
the JAX package's, and ``chip_smoke.py``'s phase ``tutorial`` the port's
run on the card against its run on the CPU. Not a test (pytest does not
collect it); importing it imports neither JAX nor the JAX package.

    JAX_PLATFORMS=cpu python tests/torch_tutorial_reference.py NB.ipynb

runs a notebook on the JAX package: every code cell as written, the setup
cell included, in the notebook's directory, with the cell executor of the
port's ``--notebook`` mode (``dynamite_tpu_torch/switch.py``, loaded from
its file so that the port is not imported), each cell's output under a
``# cell N`` line.

A run's output compares with another's when, cell by cell, every line's
text is the same and each of its numbers agrees to
``|a - b| <= RTOL * max(|a|, |b|) + ATOL``. The notebooks run in float64,
the default precision of both packages; ATOL is the eigensolver's default
tolerance at these spectra's scale (|E| ~ 10): residual norms and
deviations from scipy's oracle are round-off of ~1e-10 to 1e-15 that
need not agree digit by digit. Left out, each with its reason:
``CELLS_NOT_COMPARED`` (whole cells), against the JAX package only
``NUMBERS_NOT_COMPARED`` (lines whose numbers depend on each package's
random stream; the text is still compared) and ``JAX_DIFFERS``, and
between runs on different numbers of cards ``WORLD_DIFFERS``.
"""

import importlib.util
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTORIAL = os.path.join(REPO, 'examples', 'tutorial')
NOTEBOOKS = ['1-Operators.ipynb', '2-States.ipynb', '3-Eigensolving.ipynb',
             '4-TimeEvolution.ipynb', '5-Subspaces.ipynb',
             '6-MatrixFree.ipynb']
RTOL = 1e-10
ATOL = 1e-9

STATS = ('prints computations.last_solve_stats, whose wall times differ '
         'from run to run')
CELLS_NOT_COMPARED = {
    ('3-Eigensolving.ipynb', 6): STATS + "; the port's holds the target "
                                         "solve's counters, the JAX "
                                         "package's the solve before it",
    ('4-TimeEvolution.ipynb', 5): STATS,
    ('6-MatrixFree.ipynb', 3): "substituted by the port's counterpart "
                               '(dynamite_tpu_torch/switch.py SUBSTITUTES): '
                               "the notebook's cell prints JAX's device "
                               'count and sharding',
}
NUMBERS_NOT_COMPARED = {
    ('2-States.ipynb', 5, ''): "the entropy of State(state='random', "
                               'seed=42): the JAX package draws from the '
                               'JAX PRNG, the port from its own counter-'
                               'based stream (dynamite_tpu_torch/ops/'
                               'draw.py; ROADMAP.md queue 3); two runs of '
                               'the port draw the same state',
}
#: Lines that depend on the number of ranks a run spans, left out where two
#: runs of the port on different numbers of cards are compared (text and
#: numbers): the JAX package's values depend on its mesh the same way.
WORLD_DIFFERS = {
    ('6-MatrixFree.ipynb', 1, 'operator memory estimate'):
        "estimate_memory sums the route's tables over the ranks, as the JAX "
        'package sums them over its mesh: each rank holds its own',
    ('6-MatrixFree.ipynb', 1, 'with ncv=30'):
        'the same estimate plus the Krylov workspace of the padded layout',
    ('6-MatrixFree.ipynb', 2, 'OperatorKernel - sharded by default'):
        'sharded_default() is whether the run spans several ranks (the JAX '
        'package: several devices)',
}
#: Lines where the JAX package's numbers are not the port's, by design or
#: by a fault of the reference; the port's line is held against the line
#: named in ``ORACLE_LINES`` of the same run instead, where there is one.
JAX_DIFFERS = {
    ('6-MatrixFree.ipynb', 1, 'operator memory estimate'):
        "estimate_memory counts each package's engine: syk(8) on Full(8) "
        'is a use_scan plan, counted as ELL tables by the JAX package and '
        "run by the port's XOR kernel, whose tables live in shared memory",
    ('6-MatrixFree.ipynb', 1, 'with ncv=30'):
        'the same estimate plus the Krylov workspace, equal in both',
    ('3-Eigensolving.ipynb', 5, 'computed:'):
        "a fault of the reference (ROADMAP.md queue 3): the JAX package's "
        'inner cap min(2 dim, 2000) stops its MINRES solves short, and '
        'its levels land ~5e-8 from the oracle line below',
}
ORACLE_LINES = {('3-Eigensolving.ipynb', 5, 'computed:'): 'oracle:'}

_NUMBER = re.compile(r'[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?')


def cells(output):
    """{cell index: its output lines} of a run's standard output."""
    out, current = {}, None
    for line in output.splitlines():
        m = re.match(r'# cell (\d+)', line)
        if m:
            current = int(m.group(1))
            out[current] = []
        elif line.startswith('#   '):
            continue  # the port's account of the setup cell
        elif current is not None:
            out[current].append(line)
    return out


def _numbers(line):
    return [float(x) for x in _NUMBER.findall(line)]


def _close(a, b):
    return abs(a - b) <= RTOL * max(abs(a), abs(b)) + ATOL


def _find(table, notebook, cell, line):
    for (nb, c, prefix), reason in table.items():
        if (nb, c) == (notebook, cell) and line.startswith(prefix):
            return prefix, reason
    return None, None


def compare(got, want, notebook, against_jax, worlds_differ=False):
    """Mismatches (strings) between two runs' outputs of one notebook: the
    port's ``got`` and ``want``, the JAX package's run when
    ``against_jax``, else another run of the port (``worlds_differ``: on
    another number of ranks, WORLD_DIFFERS left out)."""
    got, want = cells(got), cells(want)
    bad = []
    if sorted(got) != sorted(want):
        return [f'cells {sorted(got)} against {sorted(want)}']
    for i in sorted(got):
        if i == 0 or (notebook, i) in CELLS_NOT_COMPARED:
            continue
        if len(got[i]) != len(want[i]):
            bad.append(f'cell {i}: {got[i]} against {want[i]}')
            continue
        for g, w in zip(got[i], want[i]):
            if worlds_differ and \
                    _find(WORLD_DIFFERS, notebook, i, w)[0] is not None:
                continue
            if _NUMBER.sub('#', g) != _NUMBER.sub('#', w):
                bad.append(f'cell {i}: {g!r} against {w!r}')
                continue
            if against_jax and \
                    _find(NUMBERS_NOT_COMPARED, notebook, i, g)[0] is not None:
                continue
            prefix = None
            if against_jax:
                prefix, _ = _find(JAX_DIFFERS, notebook, i, g)
            if prefix is not None:
                oracle = ORACLE_LINES.get((notebook, i, prefix))
                if oracle is None:
                    continue
                w = next(line for line in got[i] if line.startswith(oracle))
            gn, wn = _numbers(g), _numbers(w)
            if len(gn) != len(wn) or not all(map(_close, gn, wn)):
                bad.append(f'cell {i}: {g!r} against {w!r}')
    return bad


def _switch():
    spec = importlib.util.spec_from_file_location(
        'port_switch', os.path.join(REPO, 'dynamite_tpu_torch', 'switch.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_on_jax(path):
    """Every code cell of the notebook as written, in its directory."""
    switch = _switch()
    path = os.path.abspath(path)
    os.chdir(os.path.dirname(path))
    namespace = {'__name__': '__main__'}
    for i, source in enumerate(switch.notebook_cells(path)):
        print(f'# cell {i}', flush=True)
        switch.run_cell(source, namespace, f'<cell {i}>')


if __name__ == '__main__':
    run_on_jax(sys.argv[1])
