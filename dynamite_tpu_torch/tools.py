"""
Utilities: multi-process printing, version info, and device-memory tracking
(the JAX package's ``tools.py``; the reference's src/dynamite/tools.py built
them on MPI and PETSc's memory counters, here they are built on
``torch.distributed`` through :mod:`.parallel.multihost` and on the CUDA
caching allocator's counters).
"""

import numpy as np

from .parallel import multihost


def mpi_print(*args, rank=0, **kwargs):
    """Print from a single process (default rank 0)."""
    if multihost.rank() == rank:
        print(*args, **kwargs)


def complex_enabled():
    """API parity with the reference: complex arithmetic is always available
    (as stacked re/im reals on the device)."""
    return True


def _device_name():
    """The CUDA device's name, 'cpu' when the CPU was asked for, else a
    note that there is no device (a version query never raises)."""
    import torch
    from . import config
    device = config._device
    if device is not None and device.type == 'cpu':
        return 'cpu'
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(device)
    return 'no CUDA device'


def get_version():
    """Version information dictionary."""
    import torch
    from . import __version__
    return {
        'version': __version__,
        'torch': torch.__version__,
        'cuda': torch.version.cuda,
        'device': _device_name(),
    }


def get_version_str():
    info = get_version()
    return (f"dynamite_tpu_torch version {info['version']} "
            f"[torch {info['torch']}, CUDA {info['cuda']}, "
            f"device={info['device']}]")


### memory tracking

def _cuda_device():
    """config.device when it is a CUDA device, else None (the CPU holds no
    device memory to count)."""
    from . import config
    device = config.device
    return device if device.type == 'cuda' else None


def track_memory():
    """Begin tracking device memory usage (call before the computation): the
    peak restarts from what is allocated now."""
    import torch
    device = _cuda_device()
    if device is not None:
        torch.cuda.reset_peak_memory_stats(device)
    return True


def get_memory_usage(group_by='all', max_usage=False):
    """Device memory held by the port's tensors, in GB: the CUDA caching
    allocator's allocated bytes (``torch.cuda.memory_stats``), or their
    peak since :func:`track_memory` (``max_memory_allocated``). 0 on the
    CPU.

    group_by : 'rank' (this process), 'node' (alias of rank), or 'all'
        (summed over the ranks of the process group).
    max_usage : report the peak instead of the current value.
    """
    import torch
    if group_by not in ('rank', 'node', 'all'):
        raise ValueError("group_by must be 'rank', 'node', or 'all'")
    device = _cuda_device()
    value = 0
    if device is not None:
        if max_usage:
            value = torch.cuda.max_memory_allocated(device)
        else:
            value = torch.cuda.memory_stats(device).get(
                'allocated_bytes.all.current', 0)
    if group_by == 'all':
        value = int(np.sum(multihost.allgather_host_values(
            np.array([value], dtype=np.int64))))
    return value / 1e9


def MPI_COMM_WORLD():
    """API parity shim: a tiny object with .rank/.size mapped to the process
    group's rank and world size."""

    class _Comm:
        rank = multihost.rank()
        size = multihost.world_size()

        def barrier(self):
            multihost.barrier('barrier')

    return _Comm()


def spectral_site_order(n_sites, edges):
    """A site relabeling that clusters strongly-coupled sites into the same
    bit half — recursive spectral (Fiedler-vector) bisection of the
    interaction graph.

    The sector engine (ops/sector_apply.py) merges every interaction
    bond confined to the low bit half into shared per-sector column
    matrices and every bond confined to the high bits into shared row
    matrices, while each bond CROSSING the half boundary spawns its own
    channel family (tables and matmuls proportional to the number of
    distinct crossing masks). Site labels are physically arbitrary, so
    relabeling by this ordering minimizes the crossing count — on the
    27-site kagome torus it cuts crossing bonds from 28 to 12 and the
    matvec cost correspondingly. The same trick serves any engine keyed on
    bit locality (the reference has no analog: its kernels are
    order-insensitive CSR sweeps, bpetsc_template_2.c:371-504).

    Parameters
    ----------
    n_sites : int
    edges : iterable of (i, j) site pairs (weights ignored)

    Returns
    -------
    relabel : numpy int array, ``relabel[old_site] = new_site``
    """
    edges = [(int(i), int(j)) for i, j in edges]

    def order(nodes, depth=0):
        m = len(nodes)
        if m <= 2 or depth > 10:
            return list(nodes)
        idx = {v: k for k, v in enumerate(nodes)}
        A = np.zeros((m, m))
        for i, j in edges:
            if i in idx and j in idx:
                A[idx[i], idx[j]] = A[idx[j], idx[i]] = 1
        L = np.diag(A.sum(1)) - A
        _w, V = np.linalg.eigh(L)
        srt = [nodes[k] for k in np.argsort(V[:, 1])]
        half = m // 2
        return order(srt[:half], depth + 1) + order(srt[half:], depth + 1)

    nodes = order(list(range(int(n_sites))))
    relabel = np.empty(n_sites, dtype=np.int64)
    relabel[np.asarray(nodes)] = np.arange(n_sites)
    return relabel
