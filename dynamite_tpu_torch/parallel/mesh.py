"""
The row layout of a state over ranks: the counterpart of the JAX package's
``parallel/mesh.py``.

The high ``device_bits`` bits of the state index pick the rank, as in the
reference (and in the original dynamite's bit-sliced MPI ownership): rank r
holds rows ``[r * local_dim, (r + 1) * local_dim)`` as a (2, local_dim)
tensor. A Pauli mask whose high bits are m_hi then pairs rank r with rank
``r ^ m_hi``, one pairwise exchange per distinct m_hi (``ops/apply.py``).

Only power-of-two world sizes that divide the dimension are laid out, which
covers Full and Parity spaces; no padding is needed.
"""

from . import multihost


def _check(dim, world):
    if world & (world - 1) or dim % world:
        raise NotImplementedError(
            f'a state of dimension {dim} over {world} ranks: the XOR path '
            'needs a power-of-two world size that divides the dimension; '
            'other layouts need the general all-gather sharded path '
            '(dynamite_tpu/ops/apply.py:649, ROADMAP.md queue 1, items 10 '
            'and 12)')


def device_bits(dim):
    """Bits of the state index that pick the rank."""
    world = multihost.world_size()
    _check(dim, world)
    return world.bit_length() - 1


def local_dim(dim):
    """Rows this rank holds."""
    world = multihost.world_size()
    _check(dim, world)
    return dim // world


def row0(dim):
    """The global index of this rank's first row."""
    return multihost.rank() * local_dim(dim)


def local_rows(planes, dim):
    """This rank's rows of a global (..., dim) array or tensor."""
    if planes.shape[-1] != dim:
        raise ValueError(f'expected a global array of {dim} rows, got shape '
                         f'{tuple(planes.shape)}')
    start = row0(dim)
    return planes[..., start:start + local_dim(dim)]
