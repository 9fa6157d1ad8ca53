"""
Device-side matrix infinity norm over the Pauli term sweep (the JAX
package's ``ops/reductions.py::build_infinity_norm``) as torch ops, for
Full/Parity pairs.

It is the matvec's term sweep with the accumulation replaced by a reduction
— as the reference's MatNorm_CPU does (max over rows of the |coefficient|
row sum, bpetsc_template_2.c:906-981) — run over row chunks in a plain loop.
The host numpy oracle is ``Operator._infinity_norm_host``.
"""

import torch

from . import msc as msc_mod
from .index_maps import device_map, parity

# rows per chunk: bounds the temporaries at a few (chunk,) vectors
RED_CHUNK_BITS = 20


def build_infinity_norm(msc, left, right, real_dtype, device):
    """A () -> float computing max_row sum_groups |f_m(bra)| over rows of
    the left subspace, counting only columns inside the right subspace.
    ``msc`` must already be reduced."""
    msc = msc_mod.combine_terms(msc)
    left_map = device_map(left)
    right_map = device_map(right)
    dim = left.get_dimension()
    masks, offsets = msc_mod.mask_groups(msc)
    groups = [(int(m), [(int(s), complex(c)) for s, c in zip(
        msc['signs'][offsets[g]:offsets[g + 1]],
        msc['coeffs'][offsets[g]:offsets[g + 1]])])
        for g, m in enumerate(masks)]

    def norm_fn():
        best = torch.zeros((), dtype=real_dtype, device=device)
        C = min(1 << RED_CHUNK_BITS, dim)
        for start in range(0, dim, C):
            rows = torch.arange(start, min(start + C, dim), dtype=torch.int64,
                                device=device)
            kets = left_map.i2s(rows)
            row_sum = torch.zeros(rows.shape, dtype=real_dtype, device=device)
            for m, terms in groups:
                bra = kets ^ m
                fr = torch.zeros_like(row_sum)
                fi = torch.zeros_like(row_sum)
                for s, c in terms:
                    w = (1 - 2 * parity(bra & s)).to(real_dtype)
                    fr += c.real * w
                    fi += c.imag * w
                _, valid = right_map.s2i(bra)
                row_sum += torch.sqrt(fr * fr + fi * fi) * valid
            best = torch.maximum(best, row_sum.max())
        return float(best)

    return norm_fn
