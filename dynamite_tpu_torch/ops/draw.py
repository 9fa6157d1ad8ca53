"""
Seeded Gaussian draws that do not depend on the world size: the random
vector of a seed is a function of (seed, global row) alone, as the JAX
package's random state is the same for any device count
(``dynamite_tpu/states.py``: it draws exactly (2, dim) values).

Row g's two values come from counters 2g + 1 and 2g + 2 of SplitMix64's
stream (Steele, Lea and Flood, "Fast splittable pseudorandom number
generators", OOPSLA 2014) from the mixed seed: each counter is hashed into
a 64-bit word, its top 53 bits make a uniform in (0, 1), and the two
uniforms a complex Gaussian by Box-Muller (real part in plane 0, imaginary
part in plane 1). Every step is an elementwise torch op in int64 and
float64, so each rank computes only its own rows, and a row's value at
world P is bitwise the one at world 1 on the same device type and torch
build, whatever each rank's thread count (``tests/test_torch_cards.py``
holds it past ATen's parallel grain, where a rank's chunk edges move, so
that vector and scalar log, cos or sin rounding apart would show). The
card's and the CPU's draws differ only by their libraries' log, sqrt, cos
and sin rounding. It does not reproduce the JAX package's random stream.
"""

import math

import torch

from ..parallel import mesh

_GAMMA = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_MASK64 = (1 << 64) - 1
# rows drawn at a time: bounds the int64 temporaries (32 MB each)
BLOCK = 1 << 22


def _signed(c):
    """A 64-bit word as the int64 with its bits (torch has no uint64
    arithmetic)."""
    c &= _MASK64
    return c - (1 << 64) if c >> 63 else c


def _shr(z, s):
    """Logical right shift of an int64 tensor: torch's ``>>`` is arithmetic,
    so the bits the sign shifted in are masked off."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix(z):
    """SplitMix64's output function of an int64 tensor (products wrap
    modulo 2^64)."""
    z = (z ^ _shr(z, 30)) * _signed(_M1)
    z = (z ^ _shr(z, 27)) * _signed(_M2)
    return z ^ _shr(z, 31)


def _uniform(word):
    """(top 53 bits + 1/2) / 2^53: a float64 strictly inside (0, 1)."""
    return (_shr(word, 11).to(torch.float64) + 0.5) * 2.0 ** -53


def normal_rows(seed, dim, dtype, device, rank=None, world=None):
    """This rank's (2, local_dim) rows of the standard complex Gaussian
    vector of ``seed`` over a space of dimension ``dim``
    (``parallel.mesh``'s layout; the process group's rank and world unless
    given), each plane N(0, 1), in ``dtype`` on ``device``; pad rows 0.
    Computed in float64 and rounded to ``dtype`` once."""
    local = mesh.local_dim(dim, world)
    first = mesh.row0(dim, rank, world)
    n = mesh.valid_rows(dim, rank, world)
    out = torch.zeros((2, local), dtype=dtype, device=device)
    key = int(mix(torch.tensor([_signed(int(seed))]))[0])
    gamma = _signed(_GAMMA)
    for start in range(0, n, BLOCK):
        stop = min(n, start + BLOCK)
        g = torch.arange(first + start, first + stop, dtype=torch.int64,
                         device=device)
        c1 = (2 * g + 1) * gamma + key
        u1 = _uniform(mix(c1))
        u2 = _uniform(mix(c1 + gamma))
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = (2.0 * math.pi) * u2
        out[0, start:stop] = r * torch.cos(theta)
        out[1, start:stop] = r * torch.sin(theta)
    return out
