"""
The reference value ``chip_smoke.py`` holds the port's half-chain entropy
against (``ENTROPY_SC24``): the half-chain entanglement entropy of the
ground state of localized(24) on SpinConserve(24, 12), as the JAX package
computes it, in float64 on JAX-CPU (``eigsolve(nev=1, tol=1e-12)``, then
``entanglement_entropy`` over spins 0..11). Not a test (pytest does not
collect it); it prints the eigenvalue, its relative residual, the entropy
and the wall seconds.

    JAX_PLATFORMS=cpu python tests/entropy_L24_reference.py
"""

import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynamite_tpu import config, models  # noqa: E402
from dynamite_tpu.computations import (eigsolve,  # noqa: E402
                                       entanglement_entropy)
from dynamite_tpu.subspaces import SpinConserve  # noqa: E402

L = 24
config.precision = 'double'
t0 = time.perf_counter()
H = models.localized(L)
sub = SpinConserve(L, L // 2)
H.add_subspace(sub)
evals, evecs = eigsolve(H, nev=1, tol=1e-12, getvecs=True)
lam = float(evals[0])
v = evecs[0]
residual = H.dot(v)
residual.axpy(-lam, v)
S = float(entanglement_entropy(v, keep=range(L // 2)))
print(repr(lam), repr(residual.norm() / abs(lam)), repr(S), config.precision,
      time.perf_counter() - t0)
