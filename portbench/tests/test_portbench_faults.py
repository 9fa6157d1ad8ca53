"""The check's control and its faults, at a size a test run holds: a run
of each cell with the timed path broken underneath (or computed in the
precision below the configuration's) comes out ``correct: false``, and a
sound run ``correct: true``. The harness's look for a card is skipped
(``--device cpu``); the rest is the run as on the card."""

import pytest

from .conftest import run_cell

FLOQUET = 'floquet_L26.cycles'
MBL = 'mbl_L24.extremal'
X4 = 'floquet_L28x4.cycles'


@pytest.mark.parametrize('cell', [FLOQUET, MBL, X4])
def test_a_sound_run_is_correct(tiny, cell):
    rc, result, err = run_cell(tiny, cell, seed=2 ** 31 + 77)
    assert rc == 0, err[-3000:]
    assert result['correct'] is True, result['checks']
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert err.strip().splitlines()[-1].startswith('check ')
    assert list(result)[-1] == 'checks'


@pytest.mark.parametrize('cell', [FLOQUET, MBL])
def test_the_control_fails(tiny, cell):
    """The reference's precision below the configuration's: the port's own
    single-precision path."""
    rc, result, err = run_cell(tiny, cell, precision='single')
    assert rc == 0, err[-3000:]
    assert result['correct'] is False, result['checks']


@pytest.mark.parametrize('cell, fault', [
    (FLOQUET, 'evolve_unchanged'),   # a step that returns its state
    (FLOQUET, 'evolve_altered'),     # an answer altered where produced
    (X4, 'no_exchange'),             # the exchange between cards left out
    (MBL, 'eigsolve_stale'),         # a step that returns its old answer
    (MBL, 'eigsolve_altered'),       # an answer altered where produced
    (MBL, 'eigsolve_half'),          # half of the pairs left out
])
def test_a_fault_fails(tiny, cell, fault):
    rc, result, err = run_cell(tiny, cell, fault=fault, seconds=1.5)
    assert rc == 0, err[-3000:]
    assert result['correct'] is False, (fault, result['checks'])
