"""
The row layout of a state over ranks: the counterpart of the JAX package's
``parallel/mesh.py``.

A state of dimension ``dim`` over P ranks is stored padded to
``storage_dim(dim) = ceil(dim / P) * P`` rows (the JAX package's
``storage_dim``, its analog of PETSc's uneven row partition): rank r holds
rows ``[r * local_dim, (r + 1) * local_dim)`` as a (2, local_dim) tensor,
``local_dim = ceil(dim / P)``. Rows at or past ``dim`` are pad rows and stay
exactly 0 under every state setter and every apply. The pads may span more
than the last rank: dim 5 over 4 ranks is stored as 8 rows, and rank 3
holds only pad rows.

Every route of ``ops/apply.py`` uses this layout. The XOR route further
needs a power-of-two world that divides the dimension (:func:`xor_layout`),
where no row is a pad: then the high ``device_bits`` bits of the state index
pick the rank, as in the reference (and in the original dynamite's
bit-sliced MPI ownership), and a Pauli mask whose high bits are m_hi pairs
rank r with rank ``r ^ m_hi``. Every other pair (and an XOR pair on any
other world) all-gathers its input or passes it around the ring.

The helpers take the process group's rank and world size unless they are
given an explicit ``rank`` and ``world``, so one process can lay out the
virtual ranks of ``ops/apply.py::VirtualTransport``.
"""

from . import multihost


def _world(world):
    return multihost.world_size() if world is None else int(world)


def _rank(rank):
    return multihost.rank() if rank is None else int(rank)


def xor_layout(dim, world=None):
    """Whether the XOR route can lay out a state of dimension ``dim``: a
    power-of-two world size that divides it."""
    world = _world(world)
    return not (world & (world - 1) or dim % world)


def _check(dim, world):
    if not xor_layout(dim, world):
        raise NotImplementedError(
            f'a state of dimension {dim} over {world} ranks: the XOR path '
            'needs a power-of-two world size that divides the dimension; '
            'other layouts take the general all-gather sharded path or its '
            'ring (ops/apply.py)')


def device_bits(dim, world=None):
    """Bits of the state index that pick the rank (the XOR route only)."""
    world = _world(world)
    _check(dim, world)
    return world.bit_length() - 1


def local_dim(dim, world=None):
    """Rows each rank holds, pad rows included: ceil(dim / world)."""
    return -(-dim // _world(world))


def storage_dim(dim, world=None):
    """The padded length of a state over ``world`` ranks: local_dim * world
    (``dim`` itself on one rank)."""
    world = _world(world)
    return local_dim(dim, world) * world


def row0(dim, rank=None, world=None):
    """The global index of a rank's first row."""
    return _rank(rank) * local_dim(dim, world)


def valid_rows(dim, rank=None, world=None):
    """How many of a rank's rows lie below ``dim`` (the rest are pads)."""
    n = local_dim(dim, world)
    return max(0, min(n, dim - row0(dim, rank, world)))


def local_rows(planes, dim, rank=None, world=None):
    """A rank's (..., local_dim) rows of a global (..., dim) array or
    tensor, its pad rows zero (a copy when it has pads)."""
    if planes.shape[-1] != dim:
        raise ValueError(f'expected a global array of {dim} rows, got shape '
                         f'{tuple(planes.shape)}')
    start = row0(dim, rank, world)
    n = local_dim(dim, world)
    if start + n <= dim:
        return planes[..., start:start + n]
    import torch
    if not isinstance(planes, torch.Tensor):
        planes = torch.from_numpy(planes)
    out = planes.new_zeros(planes.shape[:-1] + (n,))
    keep = valid_rows(dim, rank, world)
    out[..., :keep] = planes[..., start:start + keep]
    return out


def zero_pads_(local, dim, rank=None, world=None):
    """Set a rank's pad rows of a (..., local_dim) tensor to 0, in place;
    returns it."""
    keep = valid_rows(dim, rank, world)
    if keep < local.shape[-1]:
        local[..., keep:] = 0
    return local
