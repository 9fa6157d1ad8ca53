"""The plain reference's matvec on the whole space of L spins: y = H x for
a complex vector x of 2**L entries, in plain PyTorch on any device.

Each flip-mask group of the term list (``pauli.groups``) is applied by
viewing x with the group's bits on axes of their own: for every pattern p
of those bits the block of x at p, times the group's coefficient at p,
adds onto the block of y at p ^ x. Flip bits beyond the first eight that
carry no sign (the pi pulse flips every spin) are merged into runs, and a
run flipped whole is that axis reversed. The diagonal (mask 0) is summed
once into a vector. Nothing here imports the port.
"""

import itertools

import torch

from . import pauli

OWN_AXES_MAX = 8


def split_view(t, L, bits, runs=()):
    """A view of the flat 2**L tensor ``t`` in which each bit of ``bits``
    has an axis of size 2 and each ``(lo, hi)`` of ``runs`` (bits lo..hi-1)
    an axis of its own; the other bits are merged. Returns (view, {bit or
    run: axis})."""
    cuts = [(b, b + 1, b) for b in bits] + [(lo, hi, (lo, hi))
                                             for lo, hi in runs]
    cuts.sort(reverse=True)
    shape, axis, top = [], {}, L
    for lo, hi, key in cuts:
        shape.append(1 << (top - hi))
        axis[key] = len(shape)
        shape.append(1 << (hi - lo))
        top = lo
    shape.append(1 << top)
    return t.view(*shape), axis


def _runs(bits):
    """Maximal runs (lo, hi) of consecutive set bits of a mask."""
    out, b = [], 0
    while bits >> b:
        if bits >> b & 1:
            lo = b
            while bits >> b & 1:
                b += 1
            out.append((lo, b))
        else:
            b += 1
    return out


def _bits(mask):
    return [b for b in range(mask.bit_length()) if mask >> b & 1]


class _Group:
    """One flip mask: its own-axis bits, its reversed runs, and the
    coefficient at every pattern of the own-axis bits."""

    def __init__(self, x, terms, L):
        zs = 0
        for _, z in terms:
            zs |= z
        flips = x & ~zs
        own = zs | (flips if len(_bits(x | zs)) <= OWN_AXES_MAX else 0)
        self.own = _bits(own)
        self.runs = _runs(x & ~own)
        self.x_own = x & own
        self.patterns = []
        for values in itertools.product((0, 1), repeat=len(self.own)):
            s = sum(v << b for v, b in zip(values, self.own))
            c = pauli.coefficient(terms, s)
            if c != 0:
                self.patterns.append((s, c))
        self.L = L

    def index(self, view, axis, s):
        idx = [slice(None)] * view.dim()
        for b in self.own:
            idx[axis[b]] = s >> b & 1
        return tuple(idx)

    def apply_add(self, x, y):
        xv, axis = split_view(x, self.L, self.own, self.runs)
        yv, _ = split_view(y, self.L, self.own, self.runs)
        # the own axes are indexed away, which shifts the run axes
        dims = [axis[r] - sum(axis[b] < axis[r] for b in self.own)
                for r in self.runs]
        for s, c in self.patterns:
            src = xv[self.index(xv, axis, s)]
            if dims:
                src = torch.flip(src, dims)
            yv[self.index(yv, axis, s ^ self.x_own)].add_(src, alpha=c)


class FullOperator:
    """H on Full(L) from a term list, for complex vectors on ``device``."""

    def __init__(self, terms, L, device, dtype=torch.complex128):
        self.L = L
        self.dtype = dtype
        self.device = torch.device(device)
        grouped = pauli.groups(terms)
        real = torch.float64 if dtype == torch.complex128 else torch.float32
        diag_terms = grouped.pop(0, [])
        is_real = all(c.imag == 0 for c, _ in diag_terms)
        self.diag = None
        if diag_terms:
            self.diag = torch.zeros(1 << L, dtype=real if is_real else dtype,
                                    device=self.device)
            for c, z in diag_terms:
                g = _Group(0, [(c, z)], L)
                dv, axis = split_view(self.diag, L, g.own)
                for s, cs in g.patterns:
                    dv[g.index(dv, axis, s)] += cs.real if is_real else cs
        self.groups = [_Group(x, ts, L) for x, ts in sorted(grouped.items())]

    def apply(self, x):
        """H x for a flat complex tensor of 2**L entries."""
        if self.diag is not None:
            y = self.diag * x
        else:
            y = torch.zeros_like(x)
        for g in self.groups:
            g.apply_add(x, y)
        return y
