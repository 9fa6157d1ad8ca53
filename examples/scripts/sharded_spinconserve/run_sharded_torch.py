"""
Distributed SpinConserve at scale on dynamite_tpu_torch: matvec + Lanczos
through the sector engine's alpha ring (dynamite_tpu_torch/ops/
sector_shard.py) over ranks. The port of run_sharded.py beside it, which
drives JAX itself and so cannot run on the port through the package
switch.

The configuration is the reference's multi-node flagship: heisenberg(30)
at half filling, SpinConserve(30, 15), dim C(30, 15) = 155,117,520.

    # with the repository on PYTHONPATH, as every example script expects:
    # P virtual ranks in one process on one GPU (the per-rank code a
    # process group runs)
    python run_sharded_torch.py -L 30 --virtual 4 -m 2
    # one process per GPU on NCCL
    torchrun --standalone --nproc-per-node=4 run_sharded_torch.py -L 30 -m 2
    # on the CPU (small L)
    python run_sharded_torch.py -L 12 --device cpu --precision double

Besides the reference's timings and Ritz values it checks one column of H
exactly: the product with the Neel basis state |s> against H|s> computed
on the host from the operator's Pauli-string terms (1e-6 relative in
single precision, 1e-12 in double). ``--vs-one-device`` (one process only)
also holds the ranks' product of the start vector against the one-device
sector engine's (1e-5 relative in single precision, 1e-12 in double), its
tables made from the ring's sector plan.
"""

import argparse
import os
import sys
import time
from math import comb

import numpy as np
import torch

from dynamite_tpu_torch import config
from dynamite_tpu_torch.models import heisenberg
from dynamite_tpu_torch.ops.apply import (OperatorKernel, VirtualTransport,
                                          _Plan)
from dynamite_tpu_torch.ops.sector_apply import (SectorTables, sector_apply,
                                                  table_bytes_estimate)
from dynamite_tpu_torch.parallel import mesh, multihost
from dynamite_tpu_torch.subspaces import SpinConserve
from dynamite_tpu_torch.tools import mpi_print
from dynamite_tpu_torch.utils.bitwise import parity

NEEL_RTOL = {'single': 1e-6, 'double': 1e-12}
ONE_DEVICE_RTOL = {'single': 1e-5, 'double': 1e-12}
WARM_REPS = 3
SEED = 1  # of the start vector


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument('-L', type=int, default=30)
    p.add_argument('-k', type=int, default=None, help='default L//2')
    p.add_argument('-m', type=int, default=2, help='Lanczos steps')
    p.add_argument('--virtual', type=int, default=None, metavar='P',
                   help='run P virtual ranks in this one process')
    p.add_argument('--device', default=None,
                   help="config.device (e.g. 'cpu'); default the GPU")
    p.add_argument('--precision', choices=('single', 'double'),
                   default='single')
    p.add_argument('--vs-one-device', action='store_true',
                   help='also hold the product against the one-device '
                        'sector engine')
    return p.parse_args(argv)


def neel_column(msc, sub, L):
    """(index of the Neel state in ``sub``, rows and values of H|s>): each
    term (mask m, sign mask g, coefficient c) puts c (-1)^popc(s & g) at
    the row of s ^ m (ops/msc.py::msc_to_matrix's convention)."""
    s = int(sum(1 << i for i in range(0, L, 2)))
    col = int(sub.state_to_idx(s))
    rows = np.asarray(sub.state_to_idx(s ^ msc['masks']), dtype=np.int64)
    vals = msc['coeffs'] * (1 - 2 * parity(s & msc['signs']))
    keep = rows >= 0
    rows, inverse = np.unique(rows[keep], return_inverse=True)
    summed = np.zeros(len(rows), dtype=complex)
    np.add.at(summed, inverse, vals[keep])
    return col, rows, summed


class Layout:
    """The rows this process holds of a vector of dimension ``dim``: every
    rank's, padded, with virtual ranks or one process; else this rank's."""

    def __init__(self, dim, world, virtual):
        self.dim = dim
        n = mesh.local_dim(dim, world)
        self.lo = 0 if virtual else mesh.row0(dim, multihost.rank(), world)
        self.rows = n * world if virtual else n

    def put(self, planes, dtype, device):
        """This process's rows of the global (2, dim) numpy planes."""
        out = torch.zeros((2, self.rows), dtype=dtype, device=device)
        hi = min(self.dim, self.lo + self.rows)
        if hi > self.lo:
            out[:, :hi - self.lo] = torch.from_numpy(
                np.ascontiguousarray(planes[:, self.lo:hi])).to(device, dtype)
        return out

    def scatter(self, rows, vals, dtype, device):
        """The global vector with ``vals`` at ``rows``, zero elsewhere."""
        out = torch.zeros((2, self.rows), dtype=dtype, device=device)
        mine = (rows >= self.lo) & (rows < self.lo + self.rows)
        idx = torch.as_tensor(rows[mine] - self.lo, device=device)
        out[0, idx] = torch.as_tensor(vals[mine].real, dtype=dtype,
                                      device=device)
        out[1, idx] = torch.as_tensor(vals[mine].imag, dtype=dtype,
                                      device=device)
        return out


def max_over_ranks(value):
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=config.device)
    multihost.allreduce_max_(t)
    return float(t)


def sync():
    if config.device.type == 'cuda':
        torch.cuda.synchronize()
    multihost.barrier()


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def main(argv=None):
    """Run the example; returns its record (every rank)."""
    args = parse_args(argv)
    if args.device is not None:
        config.device = args.device
    config.precision = args.precision
    if int(os.environ.get('WORLD_SIZE', 1)) > 1:
        if args.virtual is not None:
            raise SystemExit('--virtual runs in one process, not under '
                             'torchrun')
        multihost.initialize()
    world = args.virtual or multihost.world_size()
    virtual = multihost.world_size() == 1
    if args.vs_one_device and not virtual:
        raise SystemExit('--vs-one-device needs one process')

    L = args.L
    k = args.k if args.k is not None else L // 2
    config.L = L
    # the sector tables at L=30 take several GB in single precision; lift
    # the one-device table budget the ring's route is gated on (as the
    # JAX package's run_sharded.py does)
    config.ell_budget = 16 << 30
    dtype, device = config.real_dtype, config.device
    dim = comb(L, k)
    mpi_print(f'L={L} k={k} dim={dim:,} ranks={world} '
              f'({"virtual" if virtual else "processes"}) '
              f'precision={args.precision} device={device}', flush=True)

    H = heisenberg(L)
    sub = SpinConserve(L, k)
    H.add_subspace(sub)
    msc = H._msc_on(sub)
    # the alpha ring's tables over the ranks, before the build (at world 1
    # too: one rank of the ring, not the one-device engine)
    est = table_bytes_estimate(_Plan(msc, sub, sub), sub, sub, world)
    mpi_print(f'tables estimated before the build: {est / 1e9:.3f} GB '
              f'over {world} ranks, {est / world / 1e9:.3f} GB a rank',
              flush=True)

    transport = VirtualTransport(world) if virtual else None
    kernel, build_s = timed(lambda: OperatorKernel(msc, sub, sub,
                                                   transport=transport))
    if kernel.engine != 'sector_ring':
        raise RuntimeError(f'the {kernel.engine} route, not the alpha ring')
    ring = kernel.sharded
    held = [ring.table_bytes(r, dtype, device) for r in range(world)]
    mpi_print(f'build (sector plan + ring tables): {build_s:.2f} s; '
              f'tables held a rank: {max(held) / 1e9:.3f} GB '
              f'({sum(held) / 1e9:.3f} GB over the ranks); '
              f'{ring.sector_plan.n_channels} channels', flush=True)

    lay = Layout(dim, world, virtual)
    real = np.float32 if args.precision == 'single' else np.float64
    w = np.random.default_rng(SEED).standard_normal((2, dim), dtype=real)
    w /= np.linalg.norm(w.astype(np.float64))
    v0 = lay.put(w, dtype, device)
    del w

    _y, cold_s = timed(lambda: kernel.apply(v0))
    del _y
    warm = []
    for _ in range(WARM_REPS):
        y, seconds = timed(lambda: kernel.apply(v0))
        warm.append(seconds)
    warm_s = float(np.median(warm))
    nnz = dim * H.nnz
    mpi_print(f'matvec cold: {cold_s * 1e3:.1f} ms; warm (median of '
              f'{WARM_REPS}): {warm_s * 1e3:.1f} ms ({nnz / warm_s:.3e} '
              f'nnz/s); each {[round(t * 1e3, 1) for t in warm]} ms',
              flush=True)

    rec = {'L': L, 'k': k, 'dim': dim, 'ranks': world, 'virtual': virtual,
           'precision': args.precision, 'engine': kernel.engine,
           'estimate_bytes': est, 'held_bytes_per_rank': held,
           'build_s': build_s, 'matvec_cold_ms': cold_s * 1e3,
           'matvec_ms': warm_s * 1e3, 'matvec_ms_each': [t * 1e3
                                                         for t in warm],
           'nnz_per_s': nnz / warm_s}

    if args.vs_one_device:
        # the one-device engine's tables from the ring's sector plan (the
        # host build is the most of a build at this size)
        one = SectorTables(ring.sector_plan.with_diagonal(kernel.plan,
                                                          device))
        y1, one_s = timed(lambda: sector_apply(v0[:, :dim].contiguous(),
                                               one))
        rel = float((y[:, :dim] - y1).abs().max() / y1.abs().max())
        pads = float(y[:, dim:].abs().max()) if y.shape[1] > dim else 0.0
        mpi_print(f'one-device sector engine: {one_s * 1e3:.1f} ms, '
                  f'ranks against it {rel:.3e} relative, pads {pads}',
                  flush=True)
        rec.update(one_device_ms=one_s * 1e3, rel_err_vs_one_device=rel)
        if not (rel <= ONE_DEVICE_RTOL[args.precision] and pads == 0.0):
            raise RuntimeError(f'the ranks\' product is {rel:.3e} from the '
                               'one-device engine\'s')
        del one, y1
    del y

    col, rows, vals = neel_column(msc, sub, L)
    e = lay.scatter(np.array([col]), np.array([1.0 + 0j]), dtype, device)
    want = lay.scatter(rows, vals, dtype, device)
    got = kernel.apply(e)
    neel = max_over_ranks((got - want).abs().max()) / np.abs(vals).max()
    mpi_print(f'Neel column H|s>: {len(rows)} nonzeros, {neel:.3e} '
              'relative from the host column', flush=True)
    rec.update(neel_nonzeros=len(rows), neel_rel_err=neel)
    if not neel <= NEEL_RTOL[args.precision]:
        raise RuntimeError(f'H|s> is {neel:.3e} from the host column')
    del e, want, got

    (V, alpha, beta), lz_s = timed(
        lambda: kernel.krylov_ops(args.m).lanczos(v0))
    a = alpha.double().cpu().numpy()
    b = beta.double().cpu().numpy()
    T = np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1)
    ritz = np.linalg.eigvalsh(T)
    mpi_print(f'{args.m}-step Lanczos: {lz_s:.2f} s', flush=True)
    mpi_print('alpha', a)
    mpi_print('beta', b)
    mpi_print(f'Ritz values after {args.m} steps: {ritz}')
    rec.update(lanczos_s=lz_s, alpha=a.tolist(), beta=b.tolist(),
               ritz=ritz.tolist())
    if not np.all(np.isfinite(ritz)):
        raise RuntimeError('Ritz values are not finite')
    if device.type == 'cuda':
        rec['peak_gb'] = torch.cuda.max_memory_allocated(device) / 1e9
        mpi_print(f'device peak: {rec["peak_gb"]:.2f} GB', flush=True)
    mpi_print('OK', flush=True)
    return rec


if __name__ == '__main__':
    main(sys.argv[1:])
    multihost.shutdown()
