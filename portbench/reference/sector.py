"""The plain reference's matvec on the states of L spins with exactly k of
them down (bit value 1): y = H x for a vector over those C(L, k) states,
in plain PyTorch on any device.

The states are ordered as dynamite_tpu's SpinConserve documents its basis
("sector-major"): by the top spin t (bit L-1), then by the number kr of
down spins among the bits La..L-2 (La = L // 2), then by the value of
those bits, then by the value of the low bits 0..La-1. The reference works
that order out again from the definition; it takes no table of the port.
H x is a gather per flip mask: every state s whose partner s ^ x is in the
space adds its coefficient times x[s] onto the partner's row.
Nothing here imports the port.
"""

import torch

from . import pauli


def popcount(v, L):
    """Set bits of each entry of an int64 tensor of L-bit values."""
    c = torch.zeros_like(v)
    for b in range(L):
        c += (v >> b) & 1
    return c


def parity(v):
    """popcount(v) & 1 of each entry of a non-negative int64 tensor."""
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def sector_states(L, k, device):
    """The C(L, k) states in the documented order (int64 tensor)."""
    s = torch.arange(1 << L, dtype=torch.int64, device=device)
    s = s[popcount(s, L) == k]
    La = L // 2
    Lr = L - La - 1
    t = s >> (L - 1)
    rest = (s >> La) & ((1 << Lr) - 1)
    key = ((t * (Lr + 1) + popcount(rest, Lr)) << (L - 1)) \
        | (s & ((1 << (L - 1)) - 1))
    return s[torch.argsort(key)]


class SectorOperator:
    """H on the k-down states of L spins from a term list, for real or
    complex vectors on ``device``. Real term lists give float64 tables."""

    def __init__(self, terms, L, k, device):
        self.L, self.k = L, k
        device = torch.device(device)
        states = sector_states(L, k, device)
        self.dim = states.numel()
        index = torch.full((1 << L,), -1, dtype=torch.int64, device=device)
        index[states] = torch.arange(self.dim, device=device)
        grouped = pauli.groups(terms)
        self.real = all(c.imag == 0 for ts in grouped.values()
                        for c, _ in ts)
        dtype = torch.float64 if self.real else torch.complex128

        def coefficient(ts, s):
            c = torch.zeros(s.shape, dtype=dtype, device=device)
            for cz, z in ts:
                sign = 1 - 2 * parity(s & z).to(torch.float64)
                c += (cz.real if self.real else cz) * sign
            return c

        self.diag = coefficient(grouped.pop(0, []), states)
        self.pairs = []
        for x, ts in sorted(grouped.items()):
            dst = index[states ^ x]
            src = torch.nonzero(dst >= 0).flatten()
            c = coefficient(ts, states[src])
            keep = c != 0
            self.pairs.append((src[keep], dst[src][keep], c[keep]))

    def apply(self, x):
        """H x for a vector over the space (its last axis)."""
        y = self.diag * x
        for src, dst, c in self.pairs:
            y.index_add_(-1, dst, c * x[..., src])
        return y

    def nnz(self):
        """Nonzero matrix elements (diagonal entries that are not 0, and
        every kept pair)."""
        return int(torch.count_nonzero(self.diag)) + sum(
            int(src.numel()) for src, _, _ in self.pairs)
