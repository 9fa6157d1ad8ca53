"""
The Hamiltonian model zoo used by the reference's tests and benchmarks
(reference: tests/integration/hamiltonians.py and
benchmarking/benchmark.py:129-178).
"""

from itertools import combinations

import numpy as np

from .. import config
from ..operators import (sigmax, sigmay, sigmaz, op_sum, op_product,
                         index_sum)
from ..extras import majorana


def ising(L=None):
    """Transverse-field Ising chain: sum ZZ + 0.5 sum X."""
    H = index_sum(sigmaz(0) * sigmaz(1), size=L)
    H += 0.5 * index_sum(sigmax(), size=H.get_length())
    return H


def long_range(L=None):
    """Nearest-neighbor XX plus polynomially decaying ZZ, with uniform
    fields."""
    alpha = 1.13
    H = index_sum(sigmax(0) * sigmax(1), size=L)
    L_eff = H.get_length()
    H += op_sum(index_sum((1 / i ** alpha) * sigmaz(0) * sigmaz(i),
                          size=L_eff)
                for i in range(1, L_eff))
    H += index_sum(0.5 * sigmax(), L_eff)
    H += index_sum(0.3 * sigmay(), L_eff)
    H += index_sum(0.1 * sigmaz(), L_eff)
    return H


def localized(L=None, seed=0):
    """Random-field (MBL) Heisenberg chain."""
    rng = np.random.RandomState(seed)
    H = index_sum(op_sum(s(0) * s(1) for s in (sigmax, sigmay, sigmaz)),
                  size=L)
    H += op_sum(rng.uniform(-1, 1) * sigmaz(i)
                for i in range(H.get_length()))
    return H


def syk(L=None, seed=0):
    """Sachdev-Ye-Kitaev: all-to-all random 4-Majorana interactions on 2L
    Majorana modes."""
    rng = np.random.RandomState(seed)
    if L is None:
        L = config.L

    majoranas = [majorana(i) for i in range(L * 2)]

    def products():
        for idxs in combinations(range(L * 2), 4):
            p = op_product(majoranas[i] for i in idxs)
            p.scale(rng.uniform(-1, 1))
            yield p

    return op_sum(products())


def mbl(L=None, seed=0, disorder=3.0):
    """The benchmark harness's MBL model: 0.25 * Heisenberg + random z
    fields in [-disorder, disorder] * 0.5."""
    import random
    rnd = random.Random(seed)
    H = index_sum(op_sum(0.25 * s(0) * s(1)
                         for s in (sigmax, sigmay, sigmaz)), size=L)
    for i in range(H.get_length()):
        H += rnd.uniform(-disorder, disorder) * 0.5 * sigmaz(i)
    return H


def xx(L=None):
    """XX chain."""
    return index_sum(0.25 * sigmax(0) * sigmax(1), size=L)


def heisenberg(L=None):
    """Isotropic Heisenberg chain (0.25 * sum of XX+YY+ZZ)."""
    return index_sum(op_sum(0.25 * s(0) * s(1)
                            for s in (sigmax, sigmay, sigmaz)), size=L)


def xxz(L=None, delta=1.0):
    """XXZ chain with anisotropy delta."""
    H = index_sum(op_sum(0.25 * s(0) * s(1) for s in (sigmax, sigmay)),
                  size=L)
    H += delta * index_sum(0.25 * sigmaz(0) * sigmaz(1),
                           size=H.get_length())
    return H
