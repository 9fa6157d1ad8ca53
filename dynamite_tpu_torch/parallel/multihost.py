"""
One process per GPU over ``torch.distributed``: the counterpart of the JAX
package's ``parallel/multihost.py``, in the SPMD form of the original
dynamite's one MPI rank per GPU, on one host or across several.

Typical driver, started by any of the launchers :func:`initialize` reads:

    # torchrun --nnodes=2 --nproc-per-node=4 --rdzv-endpoint=H:P script.py
    # srun --nodes=2 --ntasks-per-node=4 python script.py
    # mpirun -n 8 --npernode 4 python script.py
    from dynamite_tpu_torch.parallel import multihost
    multihost.initialize()      # NCCL on the GPUs, gloo on the CPU
    ... build operators and states as usual; each rank holds its rows ...

The call is optional: under a launcher's complete environment that names
several processes, the port's first use (:func:`join_launch`) calls
:func:`initialize` itself, as the JAX package spans every chip of a
host with no call. Without a launcher nothing changes: world size 1, rank
0, and every helper here is a no-op.
"""

import os
import re
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing

# jax.distributed's coordinator port under SLURM and Open MPI: one of the
# 4096 ports up to 65535, chosen by the job id
_PORT_BASE = 65536 - 4096


def is_initialized():
    """Whether a process group is up (the distributed XOR path is on)."""
    return dist.is_available() and dist.is_initialized()


def rank():
    join_launch()
    return dist.get_rank() if is_initialized() else 0


def world_size():
    join_launch()
    return dist.get_world_size() if is_initialized() else 1


_JOIN = {'done': False}


def join_launch():
    """Once a process: under a launcher's complete environment that names
    several processes (:func:`launch_to_join`), start the group
    (:func:`initialize`) unless one is up. Called at the first question
    about the layout (:func:`rank`, :func:`world_size`) and at the port's
    first use of the device (``config._initialize``), so a script written
    for one process, which never calls :func:`initialize`, runs as one rank
    of the group."""
    if _JOIN['done']:
        return
    _JOIN['done'] = True
    if launch_to_join() is not None and not is_initialized():
        initialize()
        # a group nobody tears down can abort the process at its exit
        import atexit
        atexit.register(shutdown)


def launch_to_join(env=None):
    """The :class:`Launch` that the port's first use joins by itself, or
    None where it runs as one process: no launcher, a world of one, a
    SLURM batch step (``SLURM_PROCID`` without ``SLURM_STEP_ID`` or
    ``SLURM_STEP_NODELIST``: ``python script.py`` inside an ``sbatch``
    job), or an environment that lacks a value the group needs (a warning
    says which; an explicit :func:`initialize` raises on it)."""
    env = os.environ if env is None else env
    torchrun = 'RANK' in env or 'WORLD_SIZE' in env
    if (not torchrun and 'SLURM_PROCID' in env
            and 'SLURM_STEP_ID' not in env
            and 'SLURM_STEP_NODELIST' not in env):
        return None
    try:
        launch = detect_launch(env)
        if launch is not None and launch.host is None:
            _need(env, 'torchrun', 'MASTER_ADDR', 'MASTER_PORT')
    except ValueError as e:
        import warnings
        warnings.warn(f'{e}; running as one process')
        return None
    if launch is None or launch.world_size <= 1:
        return None
    return launch


class Launch(NamedTuple):
    """What a launcher's environment says about this process. ``host`` and
    ``port`` name the coordinator (rank 0's rendezvous), ``None`` where the
    launcher's own rendezvous (torchrun's ``env://``) takes them."""
    launcher: str
    rank: int
    world_size: int
    local_rank: int
    host: str = None
    port: int = None


def _need(env, launcher, *names):
    """The values of ``names`` in ``env``; raises where one is missing."""
    missing = [n for n in names if n not in env]
    if missing:
        raise ValueError(f'{launcher} environment without {", ".join(missing)}'
                         f': cannot join its job')
    return [env[n] for n in names]


def _ids(env, launcher, rank, world, local):
    return [int(v) for v in _need(env, launcher, rank, world, local)]


def _slurm_first_host(node_list):
    """The first host of a SLURM node list, in the forms ``node001``,
    ``node001,host2``, ``node[001-015],host2`` and ``node[001,007-015]``."""
    m = re.match(r'([^,\[]*)(?:\[([^,\]-]*))?', node_list)
    return m.group(1) + (m.group(2) or '')


def _ompi_launcher_host(uri):
    """The launcher's address in Open MPI's ``OMPI_MCA_orte_hnp_uri``, e.g.
    ``1531576320.0;tcp://10.96.0.1,10.148.0.1:34911`` or
    ``1314521088.0;tcp6://[fe80::b9b,2620:10d::2]:43370``: the first
    address of its ``tcp://`` or ``tcp6://[...]`` list."""
    m = re.search(r'tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]', uri)
    if m is None:
        raise ValueError(f'no tcp:// or tcp6:// address in Open MPI\'s '
                         f'OMPI_MCA_orte_hnp_uri {uri!r}')
    return m.group(1) or m.group(2)


def detect_launch(env=None):
    """The :class:`Launch` that the environment ``env`` (default
    ``os.environ``) describes, or None when no launcher set it. Read in
    this order, the first present wins:

    * torchrun (``RANK`` or ``WORLD_SIZE``): ``RANK``, ``WORLD_SIZE``,
      ``LOCAL_RANK``; the coordinator is torchrun's ``env://``
      (``MASTER_ADDR``, ``MASTER_PORT``).
    * SLURM's ``srun`` (``SLURM_PROCID``): ``SLURM_PROCID``,
      ``SLURM_NTASKS``, ``SLURM_LOCALID``; the coordinator is the first
      host of ``SLURM_STEP_NODELIST`` at port ``SLURM_JOB_ID % 4096 +
      61440``, as ``jax.distributed`` derives it, so a job script written
      for the JAX package runs unchanged.
    * Open MPI's ``mpirun`` (``OMPI_MCA_orte_hnp_uri``, which it alone
      sets): ``OMPI_COMM_WORLD_RANK``, ``..._SIZE``, ``..._LOCAL_RANK``;
      the coordinator is the launcher's address in that URI, at port
      ``(jobid // 4096) % 4096 + 61440`` (the jobid the URI starts with),
      as ``jax.distributed`` derives it.

    Under SLURM and Open MPI, ``MASTER_ADDR`` and ``MASTER_PORT`` take
    precedence over the derived coordinator where set. A launcher's
    environment that lacks one of its values raises ``ValueError``: it
    never reads as one process.

    Left out: Cloud TPU detection (the TPU's own), and JAX's Kubernetes
    detection, which needs the ``kubernetes`` client and an API server."""
    env = os.environ if env is None else env
    if 'RANK' in env or 'WORLD_SIZE' in env:
        return Launch('torchrun', *_ids(env, 'torchrun', 'RANK',
                                        'WORLD_SIZE', 'LOCAL_RANK'))
    if 'SLURM_PROCID' in env:
        ids = _ids(env, 'SLURM', 'SLURM_PROCID', 'SLURM_NTASKS',
                   'SLURM_LOCALID')
        if 'MASTER_ADDR' in env:
            host = env['MASTER_ADDR']
        else:
            host = _slurm_first_host(*_need(env, 'SLURM',
                                            'SLURM_STEP_NODELIST'))
        if 'MASTER_PORT' in env:
            port = int(env['MASTER_PORT'])
        else:
            job_id, = _need(env, 'SLURM', 'SLURM_JOB_ID')
            port = int(job_id) % 4096 + _PORT_BASE
        return Launch('slurm', *ids, host, port)
    if 'OMPI_MCA_orte_hnp_uri' in env:
        ids = _ids(env, 'Open MPI', 'OMPI_COMM_WORLD_RANK',
                   'OMPI_COMM_WORLD_SIZE', 'OMPI_COMM_WORLD_LOCAL_RANK')
        uri = env['OMPI_MCA_orte_hnp_uri']
        host = env.get('MASTER_ADDR') or _ompi_launcher_host(uri)
        if 'MASTER_PORT' in env:
            port = int(env['MASTER_PORT'])
        else:
            jobid = int(uri.split('.', 1)[0])
            port = (jobid // 4096) % 4096 + _PORT_BASE
        return Launch('ompi', *ids, host, port)
    return None


def _tcp(host, port):
    return f'tcp://[{host}]:{port}' if ':' in host else f'tcp://{host}:{port}'


def _card(local_rank):
    """This process's GPU: ``cuda:{local_rank}``, refused where this process
    sees no such card (two ranks on one card fail late in NCCL)."""
    n = torch.cuda.device_count()
    if not 0 <= local_rank < n:
        raise RuntimeError(f'local rank {local_rank} needs a GPU of its own, '
                           f'but this process sees {n} CUDA device(s): start '
                           f'at most {n} processes a host, or give each its '
                           f'own CUDA_VISIBLE_DEVICES')
    return torch.device('cuda', local_rank)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               *, rank=None, world_size=None, init_method=None):
    """Start the process group and pin ``config.device`` to this rank's GPU.

    The JAX package's signature comes first: ``coordinator_address``
    (``'host:port'``, rank 0's rendezvous), ``num_processes`` and
    ``process_id``. ``rank``, ``world_size`` and ``init_method`` (any
    ``torch.distributed`` URL, e.g. ``'file:///path/store'``) are the same
    values in torch's spelling; giving both spellings of one value raises.
    Each value not given comes from the launcher's environment
    (:func:`detect_launch`: torchrun, SLURM's srun, Open MPI's mpirun). With
    neither arguments nor a launcher this is one process: no group starts
    and nothing changes.

    The backend is NCCL when ``config.device`` is CUDA (its default when a
    card is present) and gloo on the CPU. The GPU is ``cuda:{local rank}``,
    the launcher's local rank (without a launcher, ``rank %
    device_count``); a local rank this process has no card for raises. A
    second call does nothing.
    """
    from .. import config
    for ours, theirs, a, b in (('coordinator_address', 'init_method',
                                coordinator_address, init_method),
                               ('num_processes', 'world_size',
                                num_processes, world_size),
                               ('process_id', 'rank', process_id, rank)):
        if a is not None and b is not None:
            raise TypeError(f'initialize() got both {ours} and {theirs}, '
                            f'two spellings of one value')
    # the first use of the port joins a launcher's group by itself
    # (join_launch); a second start would fail
    _JOIN['done'] = True
    if is_initialized():
        return
    if coordinator_address is not None:
        init_method = 'tcp://' + coordinator_address
    world_size = num_processes if world_size is None else world_size
    rank = process_id if rank is None else rank
    launch = detect_launch()
    if launch is None and (rank, world_size, init_method) == (None,) * 3:
        return
    if launch is not None:
        rank = launch.rank if rank is None else rank
        world_size = launch.world_size if world_size is None else world_size
        if init_method is None:
            init_method = ('env://' if launch.host is None
                           else _tcp(launch.host, launch.port))
    missing = [name for name, v in (('rank', rank), ('world_size', world_size),
                                    ('init_method', init_method))
               if v is None]
    if missing:
        raise ValueError(f'initialize() without {", ".join(missing)}, and no '
                         f'launcher environment gives it')

    # the device without initializing config: precision stays open, as
    # the JAX package's initialize() leaves it
    device = config._resolve_device()
    if device.type == 'cuda':
        device = _card(launch.local_rank if launch is not None
                       else rank % torch.cuda.device_count())
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


def collective(fn, *args, name=None, **kwargs):
    """Post one collective step of the port, ``fn(*args, **kwargs)`` (a
    ``torch.distributed`` call, or a function of a few that every rank
    calls at the same step), and count it in ``collective.posted``. The
    step is the span ``transport.<name>`` and counts one call in
    ``transport.<name>.calls`` (:mod:`..tracing`); ``name`` is ``fn``'s
    own by default (``all_reduce``, ``broadcast_object_list``, ...). Every
    rank takes the port's steps in the same order and counts each once,
    whether it sends, receives or has no part in it, so the counts of the
    ranks of a group are equal wherever no rank stopped short of a step
    that another took: an interactive session (``interactive.py``) keeps
    its ranks after an error only then, as no collective is left posted
    that a later one would match.

    A step is taken whole or not at all: while one runs
    (``collective.depth`` > 0) the session's SIGINT handler does not raise
    but sets ``collective.held``, and the KeyboardInterrupt is raised here
    once the step is through. (A rank blocked in a step that another rank
    never takes stays blocked; the session restarts the group.)"""
    span = 'transport.' + (name or fn.__name__.lstrip('_'))
    tracing.count(span + '.calls')
    collective.depth += 1
    try:
        collective.posted += 1
        with tracing.span(span):
            out = fn(*args, **kwargs)
    finally:
        collective.depth -= 1
        held = collective.held and not collective.depth
        if held:
            collective.held = False
    if held:
        raise KeyboardInterrupt
    return out


collective.posted = collective.depth = 0
collective.held = False


def _comm_device():
    from .. import config
    return config.device


def broadcast_from_host0(value_array):
    """Agree on a small host value across ranks (e.g. an RNG seed): every
    rank gets rank 0's."""
    if world_size() == 1:
        return value_array
    return broadcast_object(np.asarray(value_array))


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank (a collective)."""
    if world_size() == 1:
        return obj
    box = [obj]
    collective(dist.broadcast_object_list, box, src=0, device=_comm_device())
    return box[0]


def allgather_host_values(value_array):
    """Gather a small host array from every rank; returns an array with a
    leading axis over ranks (the operator consistency check uses it)."""
    if world_size() == 1:
        return np.asarray(value_array)[None]
    out = [None] * world_size()
    collective(dist.all_gather_object, out, np.asarray(value_array))
    return np.stack(out)


def barrier(name=None):
    """Wait until every rank reaches this point. ``name`` (the JAX
    package's argument) labels the barrier in any error it raises."""
    if world_size() > 1:
        device = _comm_device()
        try:
            if device.type == 'cuda':
                collective(dist.barrier, device_ids=[device.index])
            else:
                collective(dist.barrier)
        except RuntimeError as e:
            raise RuntimeError(f'barrier {name!r} failed on rank {rank()} of '
                               f'{world_size()}: {e}') from e


def gather_rows(t, to_all=True, dim=None):
    """Each rank's (..., n) tensor put together along the last axis in rank
    order: on every rank, or with ``to_all=False`` on rank 0 only (None on
    the others). With ``dim``, the rows from ``dim`` on (the pad rows of
    ``parallel.mesh``'s layout) are dropped."""
    if world_size() > 1:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(world_size())]
        if to_all:
            collective(dist.all_gather, parts, t)
        else:
            collective(dist.gather, t, parts if rank() == 0 else None, dst=0)
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
            elif me == 0:
                piece = t.new_empty((2, n))
            collective(_piece_to_rank0, piece, q, me)
            if me == 0:
                piece = piece.to('cpu', torch.float64).numpy()
            yield first + start, piece


def _piece_to_rank0(piece, q, me):
    """One piece of :func:`rows_to_rank0`: rank ``q`` sends it, rank 0
    receives it, every other rank has no part in it."""
    if q != 0 and q == me:
        dist.send(piece.contiguous(), dst=0)
    elif q != 0 and me == 0:
        dist.recv(piece, src=q)


def host_id():
    """The name of this rank's host: ``NCCL_HOSTID`` where set (NCCL's own
    override, which tells apart nodes emulated on one machine), else the
    host name."""
    import socket
    return os.environ.get('NCCL_HOSTID') or socket.gethostname()


def allreduce_sum_(t):
    """Sum a device tensor over ranks, in place; returns it. Enqueued on the
    device (NCCL) with no host synchronization. Counts the tensor's bytes
    in ``transport.all_reduce.bytes``."""
    if world_size() > 1:
        collective(dist.all_reduce, t, op=dist.ReduceOp.SUM)
        tracing.count('transport.all_reduce.bytes',
                      t.numel() * t.element_size())
    return t


def allreduce_max_(t):
    """Max of a device tensor over ranks, in place; returns it (its bytes
    counted as :func:`allreduce_sum_` counts them)."""
    if world_size() > 1:
        collective(dist.all_reduce, t, op=dist.ReduceOp.MAX)
        tracing.count('transport.all_reduce.bytes',
                      t.numel() * t.element_size())
    return t
