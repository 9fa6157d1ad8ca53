"""
Device-side reductions over the Pauli term sweep (the JAX package's
``ops/reductions.py``) as torch ops: the matrix infinity norm and the
subspace conservation check.

Both are the matvec's term sweep with the accumulation replaced by a
reduction — as the reference implements them as variants of its shell
kernel: MatNorm_CPU (max over rows of the |coefficient| row sum,
bpetsc_template_2.c:906-981) and CheckConserves (logical AND over columns
that every active mask image lands inside the left subspace,
bpetsc_template_2.c:990-1056) — run over row chunks in a plain loop. The
host numpy oracles are ``Operator._infinity_norm_host`` and
``Operator._conserves_host``. With a process group up, the norm sweeps each
rank's own rows and the maxima meet in one all-reduce.
"""

import torch

from ..parallel import mesh, multihost
from . import msc as msc_mod
from .apply import _base
from .index_maps import device_map, parity

# rows per chunk: bounds the temporaries at a few (chunk,) vectors
RED_CHUNK_BITS = 20


def _groups(msc):
    """[(mask, [(sign, coeff), ...]), ...] of a combined MSC."""
    masks, offsets = msc_mod.mask_groups(msc)
    return [(int(m), [(int(s), complex(c)) for s, c in zip(
        msc['signs'][offsets[g]:offsets[g + 1]],
        msc['coeffs'][offsets[g]:offsets[g + 1]])])
        for g, m in enumerate(masks)]


def _coefficient(states, terms, real_dtype):
    """(fr, fi): sum over the terms of coeff * (-1)**parity(states & s)."""
    fr = torch.zeros(states.shape, dtype=real_dtype, device=states.device)
    fi = torch.zeros_like(fr)
    for s, c in terms:
        w = (1 - 2 * parity(states & s)).to(real_dtype)
        fr += c.real * w
        fi += c.imag * w
    return fr, fi


def build_infinity_norm(msc, left, right, real_dtype, device):
    """A () -> float computing max_row sum_groups |f_m(bra)| over rows of
    the left subspace, counting only columns inside the right subspace.
    ``msc`` must already be reduced (and XParity-rewritten); an XParity
    pair sweeps its parent's rows."""
    msc = msc_mod.combine_terms(msc)
    left_map = device_map(_base(left))
    right_map = device_map(_base(right))
    dim = _base(left).get_dimension()
    groups = _groups(msc)

    def norm_fn():
        best = torch.zeros((), dtype=real_dtype, device=device)
        first = mesh.row0(dim)
        stop = first + mesh.valid_rows(dim)  # no pad row
        C = min(1 << RED_CHUNK_BITS, dim)
        for start in range(first, stop, C):
            rows = torch.arange(start, min(start + C, stop),
                                dtype=torch.int64, device=device)
            kets = left_map.i2s(rows)
            row_sum = torch.zeros(rows.shape, dtype=real_dtype, device=device)
            for m, terms in groups:
                bra = kets ^ m
                fr, fi = _coefficient(bra, terms, real_dtype)
                _, valid = right_map.s2i(bra)
                row_sum += torch.sqrt(fr * fr + fi * fi) * valid
            best = torch.maximum(best, row_sum.max())
        return float(multihost.allreduce_max_(best))

    return norm_fn


def build_check_conserves(msc, left, right, real_dtype, device):
    """A () -> bool device check that the operator's image of the right
    subspace lies inside the left subspace: for every column state and
    every mask group with non-cancelling total coefficient, the image state
    must have a valid left index. ``msc`` must already be reduced (and
    XParity-rewritten); exact symbolic cancellations that survive as float
    roundoff are treated as zero relative to each group's coefficient
    scale. Every rank sweeps every column."""
    msc = msc_mod.combine_terms(msc)
    left_map = device_map(_base(left))
    right_map = device_map(_base(right))
    dim = _base(right).get_dimension()
    # relative-roundoff threshold on the squared magnitude, per group
    groups = [(m, terms, (1e-12 * sum(abs(c) for _s, c in terms)) ** 2)
              for m, terms in _groups(msc)]

    def check_fn():
        C = min(1 << RED_CHUNK_BITS, dim)
        for start in range(0, dim, C):
            cols = torch.arange(start, min(start + C, dim),
                                dtype=torch.int64, device=device)
            states = right_map.i2s(cols)
            leaves = torch.zeros((), dtype=torch.bool, device=device)
            for m, terms, tol2 in groups:
                fr, fi = _coefficient(states, terms, real_dtype)
                active = (fr * fr + fi * fi) > tol2
                _, valid = left_map.s2i(states ^ m)
                leaves |= (active & ~valid).any()
            if bool(leaves):
                return False
        return True

    return check_fn
