"""The least time one H x could take on an H100, whatever engine runs it.

A frozen copy of the bound arithmetic of the port's kernel table (the
larger of the bytes at HBM rate and the float operations at the type's
peak outside the tensor cores), counted on the operator itself and not on
any engine's tables:

* bytes: x read once and y written once, both planes, at the state's
  real item size, over the rows one card holds;
* operations: for every nonzero matrix element, two fused multiply-adds
  (4 flops) for each nonzero part (real, imaginary) of the element times
  the complex x: 4 for a real or imaginary element, 8 for a complex one.

The nonzeros come from the plain reference's own tables
(``reference.full`` / ``reference.sector``), so the count is the same for
any engine the port picks.
"""

# NVIDIA H100 SXM data sheet: HBM3 bandwidth; FP32 and FP64 outside the
# tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'float64': 34e12}


def _flops(c):
    c = complex(c)
    return 4 * ((c.real != 0) + (c.imag != 0))


def full_flops(op):
    """Float operations of one H x over all 2**L rows of a
    ``reference.full.FullOperator``."""
    import torch
    rows = 1 << op.L
    total = 0
    if op.diag is not None:
        d = op.diag
        if d.is_complex():
            total += 4 * (int(torch.count_nonzero(d.real))
                          + int(torch.count_nonzero(d.imag)))
        else:
            total += 4 * int(torch.count_nonzero(d))
    for g in op.groups:
        per_pattern = rows >> len(g.own)
        total += sum(_flops(c) for _, c in g.patterns) * per_pattern
    return total


def sector_flops(op):
    """Float operations of one H x of a
    ``reference.sector.SectorOperator``."""
    import torch
    per = 4 if op.real else 8
    total = per * int(torch.count_nonzero(op.diag))
    for src, _, _ in op.pairs:
        total += per * int(src.numel())
    return total


def least_seconds(rows, itemsize, flops, dtype):
    """(seconds, 'bytes' or 'operations') of one H x on ``rows`` rows of
    one card, ``flops`` its share of the operations, ``dtype`` 'float32'
    or 'float64' (the state's real type)."""
    by_bytes = 2 * 2 * itemsize * rows / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    if by_bytes >= by_ops:
        return by_bytes, 'bytes'
    return by_ops, 'operations'
