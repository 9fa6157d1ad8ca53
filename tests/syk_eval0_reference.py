"""
The reference value ``chip_smoke.py`` holds the port's SYK eigensolve
against (``EVAL0_SYK16``): the lowest eigenvalue of syk(16) on Parity(16,
'even') as the JAX package computes it, in float64 on JAX-CPU through its
XOR-dense engine. The split is fixed at La = 5, whose tables take 0.19 GB
(the eigenvalue does not depend on the split). Not a test (pytest does not
collect it): ~10 minutes on two cores.

    JAX_PLATFORMS=cpu python tests/syk_eval0_reference.py
"""

import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynamite_tpu import config, models  # noqa: E402
from dynamite_tpu.computations import eigsolve  # noqa: E402
from dynamite_tpu.subspaces import Parity  # noqa: E402

config.xor_dense_la = 5
H = models.syk(16)
sub = Parity('even', L=16)
H.add_subspace(sub)
print(repr(float(eigsolve(H, nev=1, tol=1e-10)[0])), config.precision,
      H.get_mat(subspaces=(sub, sub)).xor_dense_info)
