"""The Hamiltonian model zoo (ising, XX, XXZ, heisenberg, MBL, long_range,
SYK) — the same models the reference's tests and benchmarks use."""

from .spin_chains import (ising, long_range, localized, syk, mbl, xx,
                          heisenberg, xxz)
