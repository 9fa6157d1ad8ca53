"""
The matrix-free Pauli-string matvec engine, XOR path.

An operator's MSC terms, grouped by mask m, define

    y[row] += f_m(bra) * x[col(bra)],   bra = i2s_left(row) ^ m
    f_m(bra) = sum_{terms t with mask m} coeff_t * (-1)**parity(bra & sign_t)

When both subspaces are Full (or both Parity), col(bra) == row ^ m' for a
reduced mask m', a pure XOR permutation: the case this slice of the port
carries. It runs in the hand-written CUDA kernel on CUDA tensors and in its
plain PyTorch version on CPU tensors (see :mod:`.xor_apply`). Other subspace
pairs raise NotImplementedError (ROADMAP.md queue 1).
"""

import numpy as np

from ..utils.bitwise import parity as parity_np
from . import msc as msc_mod
from .xor_apply import XorTables, xor_apply


def _is_xor_pair(left, right):
    """Whether col(bra) reduces to a pure XOR permutation of row indices."""
    from .. import subspaces as sp
    if isinstance(left, sp.Full) and isinstance(right, sp.Full):
        return True
    if isinstance(left, sp.Parity) and isinstance(right, sp.Parity):
        return True
    return False


class _Plan:
    """Host-side compilation plan for one (msc, left, right) triple."""

    def __init__(self, msc, left, right):
        from .. import subspaces as sp

        if not _is_xor_pair(left, right):
            raise NotImplementedError(
                f'the ({left!r}, {right!r}) pair is not an XOR pair; general '
                'subspace pairs are ROADMAP.md queue 1, item 10')

        msc = msc_mod.combine_terms(msc)
        self.L = left.L
        self.dim_left = left.get_dimension()
        self.dim_right = right.get_dimension()

        masks, offsets = msc_mod.mask_groups(msc)
        groups = []
        for g, m in enumerate(masks):
            sl = slice(offsets[g], offsets[g + 1])
            signs = msc['signs'][sl].astype(np.int64)
            coeffs = msc['coeffs'][sl].astype(np.complex128)
            m = int(m)

            if isinstance(left, sp.Parity):
                # validity of s2i is uniform over the group:
                # parity(bra) = left.space ^ parity(m) must equal right.space
                if (left.space ^ int(parity_np(np.int64(m)))) != right.space:
                    continue  # projected away entirely
                perm_mask = m >> 1
            else:
                perm_mask = m

            groups.append((m, perm_mask, signs, coeffs))

        self.groups = groups
        self.nterms = sum(len(g[2]) for g in groups)


class OperatorKernel:
    """A matrix-free matvec y = A @ x for one Full/Parity subspace pair.

    ``apply(x)`` takes the (2, dim_right) stacked-real tensor and returns the
    (2, dim_left) result, on x's device and in x's dtype.
    """

    def __init__(self, msc, left, right):
        self.plan = _Plan(msc, left, right)
        self.left = left
        self.right = right
        self.tables = XorTables(self.plan, left)
        self._krylov_ops = {}

    def apply(self, x):
        if x.shape != (2, self.plan.dim_right):
            raise ValueError(f'expected a (2, {self.plan.dim_right}) state, '
                             f'got {tuple(x.shape)}')
        return xor_apply(x.contiguous(), self.tables)

    def krylov_ops(self, m):
        """Cached Krylov building blocks for subspace size m."""
        if m not in self._krylov_ops:
            from ..solvers.krylov import KrylovOps
            self._krylov_ops[m] = KrylovOps(self.apply, m)
        return self._krylov_ops[m]
