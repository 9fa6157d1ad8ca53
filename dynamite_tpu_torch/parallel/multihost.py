"""
One process per GPU over ``torch.distributed``: the counterpart of the JAX
package's ``parallel/multihost.py``, in the SPMD form of the original
dynamite's one MPI rank per GPU.

Typical driver, started with ``torchrun --nproc-per-node=N script.py``:

    from dynamite_tpu_torch.parallel import multihost
    multihost.initialize()      # NCCL on the GPUs, gloo on the CPU
    ... build operators and states as usual; each rank holds its rows ...

Without :func:`initialize` nothing changes: world size 1, rank 0, and every
helper here is a no-op.
"""

import os

import numpy as np
import torch
import torch.distributed as dist


def is_initialized():
    """Whether a process group is up (the distributed XOR path is on)."""
    return dist.is_available() and dist.is_initialized()


def rank():
    return dist.get_rank() if is_initialized() else 0


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def initialize(rank=None, world_size=None, init_method=None):
    """Start the process group and pin ``config.device`` to this rank's GPU.

    The backend is NCCL when ``config.device`` is CUDA (its default when a
    card is present) and gloo on the CPU. ``rank``, ``world_size`` and
    ``init_method`` default to what ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``env://``); pass them to run without it, e.g.
    ``init_method='tcp://localhost:29500'`` or ``'file:///path/store'``.
    The GPU is ``cuda:{LOCAL_RANK}``, else ``cuda:{rank % device_count}``.
    A second call does nothing.
    """
    from .. import config
    if is_initialized():
        return
    if rank is None:
        rank = int(os.environ.get('RANK', 0))
    if world_size is None:
        world_size = int(os.environ.get('WORLD_SIZE', 1))
    if init_method is None:
        init_method = 'env://'

    device = config.device
    if device.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK',
                                   rank % torch.cuda.device_count()))
        device = torch.device('cuda', local)
        torch.cuda.set_device(device)
        backend = 'nccl'
    else:
        backend = 'gloo'
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    config.device = device


def shutdown():
    """Tear the process group down (the end of a driver script)."""
    if is_initialized():
        dist.destroy_process_group()


def _comm_device():
    from .. import config
    return config.device


def broadcast_from_host0(value_array):
    """Agree on a small host value across ranks (e.g. an RNG seed): every
    rank gets rank 0's."""
    if world_size() == 1:
        return value_array
    box = [np.asarray(value_array)]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


def allgather_host_values(value_array):
    """Gather a small host array from every rank; returns an array with a
    leading axis over ranks (the operator consistency check uses it)."""
    if world_size() == 1:
        return np.asarray(value_array)[None]
    out = [None] * world_size()
    dist.all_gather_object(out, np.asarray(value_array))
    return np.stack(out)


def barrier():
    if world_size() > 1:
        device = _comm_device()
        if device.type == 'cuda':
            dist.barrier(device_ids=[device.index])
        else:
            dist.barrier()


def gather_rows(t, to_all=True, dim=None):
    """Each rank's (..., n) tensor put together along the last axis in rank
    order: on every rank, or with ``to_all=False`` on rank 0 only (None on
    the others). With ``dim``, the rows from ``dim`` on (the pad rows of
    ``parallel.mesh``'s layout) are dropped."""
    if world_size() > 1:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(world_size())]
        if to_all:
            dist.all_gather(parts, t)
        else:
            dist.gather(t, parts if rank() == 0 else None, dst=0)
            if rank() != 0:
                return None
        t = torch.cat(parts, dim=-1)
    if dim is not None and t.shape[-1] != dim:
        t = t[..., :dim]
    return t


def rows_to_rank0(t, dim, chunk):
    """Every rank's rows below ``dim`` of its (2, local_dim) tensor ``t``
    (``parallel.mesh``'s padded layout), brought to rank 0 in pieces of at
    most ``chunk`` rows: yields (start, piece) in global row order, piece
    the (2, n) rows [start, start + n) as a host float64 array on rank 0 and
    None on the other ranks. Every rank walks the same pieces, whose bounds
    are global; the rank that holds a piece sends it to rank 0 with one
    point-to-point send, so rank 0 holds one piece at a time and pad rows
    never leave their rank. Without a process group, the pieces of t."""
    from . import mesh
    me, world = rank(), world_size()
    for q in range(world):
        first = mesh.row0(dim, q, world)
        valid = mesh.valid_rows(dim, q, world)
        for start in range(0, valid, chunk):
            n = min(chunk, valid - start)
            piece = None
            if q == me:
                piece = t[:, start:start + n]
                if me != 0:
                    dist.send(piece.contiguous(), dst=0)
            elif me == 0:
                piece = t.new_empty((2, n))
                dist.recv(piece, src=q)
            if me == 0:
                piece = piece.to('cpu', torch.float64).numpy()
            yield first + start, piece


def rank_seed(seed):
    """The generator seed of this rank's rows of a random vector: ``seed``
    itself on rank 0, so one process draws what it drew before a process
    group existed, and a seed of its own on every other rank."""
    return (int(seed) + rank() * 0x9E3779B97F4A7C15) % 2**63


def allreduce_sum_(t):
    """Sum a device tensor over ranks, in place; returns it. Enqueued on the
    device (NCCL) with no host synchronization."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def allreduce_max_(t):
    """Max of a device tensor over ranks, in place; returns it."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t
