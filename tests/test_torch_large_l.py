"""
The port at L > 31 (the mirror of ``tests/integration/test_precision.py::
TestLargeL``): states need more than 32 bits, so the index maps, the ELL
tables and the host BFS run on int64 states, in float64 on the CPU. Each
subspace holds a handful of states, so these run in process and are not
slow.

Tolerances as in the JAX package's tests: the matvec 1e-12 against
``to_numpy``, ``evolve`` 1e-8 against ``scipy.linalg.expm``, the eigenvalue
1e-10 against ``eigvalsh``.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from dynamite_tpu_torch import config
from dynamite_tpu_torch.operators import (Operator, op_product, op_sum,
                                          sigmax, sigmay, sigmaz)
from dynamite_tpu_torch.states import State
from dynamite_tpu_torch.subspaces import Auto, Explicit

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_double(monkeypatch):
    """The port on the CPU in float64; its globals restored after."""
    monkeypatch.setattr(config, '_device', torch.device('cpu'))
    monkeypatch.setattr(config, '_precision', 'double')
    monkeypatch.setattr(config, '_L', None)
    monkeypatch.setattr(config, '_subspace', None)


def _dense(H, sub):
    return np.asarray(H.to_numpy(subspaces=(sub, sub)).todense())


def test_L34_explicit_subspace():
    """Spin flips between the two ends of an L=34 chain on the 4-state
    orbit of |0...0>: the dot and evolve against dense oracles."""
    L = 34
    config.L = L
    H = (sigmax(0) * sigmax(L - 1) + 0.5 * sigmaz(0)
         + 0.25 * sigmaz(L - 1))
    top = 1 << (L - 1)
    sub = Explicit([0, 1, top, top | 1], L=L)
    H.add_subspace(sub)
    assert int(sub.idx_to_state(np.array([2]))[0]) == top

    s = State(state='random', subspace=sub, seed=3)
    H_np = _dense(H, sub)
    assert np.max(np.abs(H.dot(s).to_numpy() - H_np @ s.to_numpy())) < 1e-12
    evolved = H.evolve(s, 0.5).to_numpy()
    want = scipy.linalg.expm(-0.5j * H_np) @ s.to_numpy()
    assert np.max(np.abs(evolved - want)) < 1e-8


def test_L33_auto_subspace():
    """XX + YY hopping on the top three sites of an L=33 chain, in the Auto
    subspace around the state with only the top spin up (33-bit states,
    dimension 3): the dot against to_numpy, the eigsolve against
    eigvalsh."""
    L = 33
    config.L = L
    top = [L - 3, L - 2, L - 1]
    terms = []
    for a, b in [(top[0], top[1]), (top[1], top[2])]:
        terms.append(op_product([sigmax(a), sigmax(b)]))
        terms.append(op_product([sigmay(a), sigmay(b)]))
    H = op_sum(terms)
    H.L = L
    sub = Auto(H, 1 << (L - 1))
    assert sub.get_dimension() == 3
    H.add_subspace(sub)

    s = State(state='random', subspace=sub, seed=11)
    H_np = _dense(H, sub)
    assert np.max(np.abs(H.dot(s).to_numpy() - H_np @ s.to_numpy())) < 1e-12
    evals = np.sort(H.eigsolve(nev=1))
    assert abs(evals[0] - np.linalg.eigvalsh(H_np)[0]) < 1e-10


def test_serialization_L40():
    op = sigmax(39) * sigmax(0) + 2 * sigmaz(39)
    loaded = Operator.from_bytes(op.serialize())
    assert loaded == op
    assert loaded.max_spin_idx == 39
