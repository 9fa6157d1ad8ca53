"""
The matrix-free Pauli-string matvec engine.

An operator's MSC terms, grouped by mask m, define

    y[row] += f_m(bra) * x[col(bra)],   bra = i2s_left(row) ^ m
    f_m(bra) = sum_{terms t with mask m} coeff_t * (-1)**parity(bra & sign_t)
    col(bra) = s2i_right(bra)   (contribution dropped where invalid)

:class:`OperatorKernel` picks the engine for one (left, right) pair:

* both Full, both Parity, or XParity over either (its MSC already rewritten
  by ``XParity.reduce_msc``): col(bra) == row ^ m' for a reduced mask m', a
  pure XOR permutation, which runs in the hand-written CUDA kernel on CUDA
  tensors and in its plain PyTorch version on CPU tensors (see
  :mod:`.xor_apply`). Operators with many masks or terms (``use_scan``,
  e.g. SYK) stay on the kernel while its shared-memory tables hold them,
  in float32 and in float64; past that they take the XOR-dense channel
  engine (:mod:`.xor_dense`, dense products as torch ops), as the JAX
  package sends every such operator past its Pallas kernel;
* square SpinConserve pairs, plain or XParity-wrapped: the sector engine
  (:mod:`.sector_apply`), dense matmuls over the sector-major blocks, while
  ``config.use_sector`` is set;
* every other pair (Explicit/Auto, projections such as Full -> Parity,
  rectangular SpinConserve pairs, many-mask XOR operators the XOR-dense
  engine declines, SpinConserve operators past the sector engine's limits):
  the ELL engine (:mod:`.ell`), precomputed (G, rows) tables applied by the
  hand-written kernel ``csrc/ell_apply.cu``, while ``config.use_ell`` is
  set and the tables fit ``config.ell_budget``; otherwise the on-the-fly
  sweep :func:`general_sweep` (torch ops).

Over ranks (a process group up, :func:`..parallel.multihost.initialize`, or
a :class:`VirtualTransport`), each rank holds a (2, local_dim) block of rows
of the padded layout (:mod:`..parallel.mesh`), and the routes are the JAX
package's ``_build_sharded_callable`` and ``_build_sharded_general``
(``dynamite_tpu/ops/apply.py:598, :649``), in its order, as
:func:`sharded_route` names them for the kernel and for
``Operator.estimate_memory`` alike:

1. XOR pairs (Full, Parity, XParity over either) on a power-of-two world
   that divides the dimension: each rank exchanges blocks pairwise with
   the ranks its masks reach (:func:`exchange`), then runs the kernel's
   sharded route once, with the sign on the global row; a ``use_scan``
   operator past the kernel's tables runs the XOR-dense engine's per-rank
   apply on the same exchange instead
   (:func:`.xor_dense.xor_dense_apply_sharded`), while it takes the plan;
2. every other pair, XOR pairs on another world and many-mask XOR pairs
   that neither XOR engine takes included, the general route, which takes
   the first of:

   a. ``'sector_ring'``: the sector engine's alpha ring
      (:mod:`.sector_shard`), for the pairs the sector engine takes, while
      ``config.use_sector`` is set and its tables fit ``config.ell_budget``;
   b. ``'ell'``: each rank's own ELL tables (:class:`ShardedEll`), the
      input all-gathered, while ``config.use_ell`` is set and the whole
      padded (G, rows) count (:func:`.ell.table_bytes`) fits the budget;
   c. ``'sweep_ring'``: the on-the-fly sweep against the blocks of x passed
      around the ring (:class:`SweepRing`), when
      ``config.sharded_ring_general`` is True, or when it is None and a
      gathered input would take more than RING_GENERAL_BYTES;
   d. ``'sweep'``: the on-the-fly sweep over the gathered input
      (:class:`SweepGather`).

Every choice is made from global quantities, so every rank routes alike; a
failed build or launch raises and never turns into another route. The
sharded routes are written once, per rank over an explicit (rank, world),
against a transport: :class:`GroupTransport` (the process group's: NCCL on
the card, gloo on the CPU; this process is one rank) or
:class:`VirtualTransport` (P virtual ranks in lockstep in one process, on
one device: its all-gather concatenates the ranks' blocks and its ring pass
rotates them).
"""

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh, multihost
from ..utils.bitwise import parity as parity_np
from . import ell
from . import msc as msc_mod
from .index_maps import device_map, parity
from .sector_apply import (build_sector_apply, sector_apply, sector_supported,
                           table_bytes_estimate)
from .xor_apply import _MAX_SMEM, XorTables, xor_apply_sharded
from .xor_dense import (build_xor_dense, choose_split, xor_dense_apply,
                        xor_dense_apply_sharded)

# operators with more mask groups than this, or more terms than the next,
# are ``use_scan`` (the JAX package's ops/apply.py limits): here they may
# leave the XOR kernel for the XOR-dense engine, once its tables overflow
UNROLL_GROUP_LIMIT = 128
UNROLL_TERM_LIMIT = 512
# rows per chunk of the on-the-fly sweep (as ops/reductions.py)
SWEEP_CHUNK_BITS = 20
# a gathered input larger than this (bytes per rank) sends the sharded
# sweep around the ring instead (the JAX package's ops/apply.py:53)
RING_GENERAL_BYTES = 1 << 31


def _base(subspace):
    """The parent of an XParity subspace, else the subspace itself."""
    from .. import subspaces as sp
    return subspace.parent if isinstance(subspace, sp.XParity) else subspace


def _is_xor_pair(left, right):
    """Whether col(bra) reduces to a pure XOR permutation of row indices."""
    from .. import subspaces as sp
    left, right = _base(left), _base(right)
    if isinstance(left, sp.Full) and isinstance(right, sp.Full):
        return True
    if isinstance(left, sp.Parity) and isinstance(right, sp.Parity):
        return True
    return False


class _Plan:
    """Host-side compilation plan for one (msc, left, right) triple. Groups
    are (mask, perm_mask, signs, coeffs); perm_mask is the XOR permutation
    mask of an XOR pair, None otherwise."""

    def __init__(self, msc, left, right):
        from .. import subspaces as sp

        msc = msc_mod.combine_terms(msc)
        self.L = left.L
        self.dim_left = left.get_dimension()
        self.dim_right = right.get_dimension()
        self.left_map = device_map(left)
        # one map (and one set of device tables) for a square pair
        self.right_map = self.left_map if right is left else device_map(right)
        self.xor_mode = _is_xor_pair(left, right)

        lbase, rbase = _base(left), _base(right)

        masks, offsets = msc_mod.mask_groups(msc)
        groups = []
        for g, m in enumerate(masks):
            sl = slice(offsets[g], offsets[g + 1])
            signs = msc['signs'][sl].astype(np.int64)
            coeffs = msc['coeffs'][sl].astype(np.complex128)
            m = int(m)

            if self.xor_mode:
                if isinstance(lbase, sp.Parity):
                    # validity of s2i is uniform over the group:
                    # parity(bra) = left.space ^ parity(m) must equal
                    # right.space
                    if (lbase.space ^ int(parity_np(np.int64(m)))) \
                            != rbase.space:
                        continue  # projected away entirely
                    perm_mask = m >> 1
                else:
                    perm_mask = m
            else:
                perm_mask = None

            groups.append((m, perm_mask, signs, coeffs))

        self.groups = groups
        self.nterms = sum(len(g[2]) for g in groups)
        self.use_scan = (len(groups) > UNROLL_GROUP_LIMIT
                         or self.nterms > UNROLL_TERM_LIMIT)

    def row_states(self, rows):
        return self.left_map.i2s(rows)


def _group_coefficient(bra, signs, coeffs, dtype):
    """(fr, fi) of f_m(bra) = sum_t c_t (-1)**parity(bra & s_t); a part
    that no term has is None."""
    fr = fi = None
    for s, c in zip(signs, coeffs):
        w = (1 - 2 * parity(bra & int(s))).to(dtype)
        cr, ci = float(c.real), float(c.imag)
        if cr:
            fr = w * cr if fr is None else fr.add_(w, alpha=cr)
        if ci:
            fi = w * ci if fi is None else fi.add_(w, alpha=ci)
    return fr, fi


def _sweep_into(y, x, plan, rows, lo=0):
    """Add to y (2, stop - start) the on-the-fly products of the global
    rows [start, stop) = ``rows`` with the columns [lo, lo + x.shape[1]),
    read from x at col - lo: in chunks of 2**SWEEP_CHUNK_BITS rows, for
    each mask group, bra = i2s_left(row) ^ m, its Walsh coefficient, and
    x[s2i_right(bra) - lo] where the image is valid and inside the columns.
    Rows at or past the left dimension (pad rows) get nothing."""
    dtype = x.dtype
    start, stop = rows
    stop = min(stop, plan.dim_left)
    hi = lo + x.shape[1]
    block = lo > 0 or hi < plan.dim_right
    C = 1 << SWEEP_CHUNK_BITS
    for c0 in range(start, stop, C):
        c1 = min(c0 + C, stop)
        r = torch.arange(c0, c1, dtype=torch.int64, device=x.device)
        kets = plan.row_states(r)
        yr, yi = y[0, c0 - start:c1 - start], y[1, c0 - start:c1 - start]
        for m, _perm, signs, coeffs in plan.groups:
            bra = kets ^ m
            fr, fi = _group_coefficient(bra, signs, coeffs, dtype)
            col, valid = plan.right_map.s2i(bra)
            if block:
                valid = valid & (col >= lo) & (col < hi)
            xp = x[:, torch.where(valid, col - lo, 0)]
            ok = valid.to(dtype)
            if fr is not None:
                fr = fr * ok
                yr += fr * xp[0]
                yi += fr * xp[1]
            if fi is not None:
                fi = fi * ok
                yr -= fi * xp[1]
                yi += fi * xp[0]
    return y


def general_sweep(x, plan, rows=None):
    """y = A x on the fly, for any subspace pair: over rows in chunks of
    2**SWEEP_CHUNK_BITS, for each mask group, bra = i2s_left(row) ^ m, its
    Walsh coefficient, and x[s2i_right(bra)] where the image is valid (the
    JAX package's general branches of ``_build_local``,
    ``_build_local_chunked`` and ``_build_local_scan``). Torch ops, the
    same on every device; the route over ``config.ell_budget`` or with
    ``config.use_ell = False``, and the oracle of the ELL tables.

    ``rows`` = (start, stop) gives those global rows alone (one rank's, its
    pad rows 0), with x the gathered (2, storage_dim) input: the sharded
    sweep (:class:`SweepGather`). Counts its calls in
    ``general_sweep.applies``."""
    if rows is None:
        rows = (0, plan.dim_left)
    y = x.new_zeros((2, rows[1] - rows[0]))
    _sweep_into(y, x, plan, rows)
    general_sweep.applies += 1
    return y


general_sweep.applies = 0


def exchange(x_local, tables, bufs):
    """Fill ``bufs[i - 1]`` with the block of rank ``me ^ hi_list[i]``, for
    every m_hi != 0 of ``tables.hi_list`` (a :class:`ShardedXorTables`, or
    the XOR-dense engine's :class:`.xor_dense.DenseLayout`), by
    one pairwise send/recv per m_hi, all posted in one
    ``dist.batch_isend_irecv`` and waited on. Every rank takes the masks in
    the same sorted order. Returns the source list of the kernel's sharded
    route; counts ``exchange.exchanges`` and ``exchange.bytes`` (sent by
    this rank)."""
    me = multihost.rank()
    srcs, ops = [], []
    for m_hi in tables.hi_list:
        if m_hi == 0:
            srcs.append(x_local)
            continue
        buf = bufs[len(ops) // 2]
        ops.append(dist.P2POp(dist.isend, x_local, me ^ m_hi))
        ops.append(dist.P2POp(dist.irecv, buf, me ^ m_hi))
        srcs.append(buf)
    if ops:
        for req in multihost.collective(dist.batch_isend_irecv, ops):
            req.wait()
        exchange.exchanges += len(ops) // 2
        exchange.bytes += len(ops) // 2 * x_local.numel() \
            * x_local.element_size()
    return srcs


exchange.exchanges = 0
exchange.bytes = 0


def _nbytes(t):
    return t.numel() * t.element_size()


def all_gather_rows(x_local):
    """The (2, P * n) input put together from every rank's (2, n) block, in
    rank order, on every rank: ``dist.all_gather_into_tensor`` on NCCL,
    the list form of ``all_gather`` on gloo. Counts one call in
    ``all_gather_rows.gathers`` and the bytes this rank receives, (P - 1)
    blocks, in ``all_gather_rows.bytes``."""
    world = multihost.world_size()
    x_local = x_local.contiguous()
    if dist.get_backend() == 'nccl':
        out = x_local.new_empty((world,) + tuple(x_local.shape))
        multihost.collective(dist.all_gather_into_tensor, out, x_local)
        x = out.transpose(0, 1).reshape(2, -1)
    else:
        parts = [torch.empty_like(x_local) for _ in range(world)]
        multihost.collective(dist.all_gather, parts, x_local)
        x = torch.cat(parts, dim=1)
    all_gather_rows.gathers += 1
    all_gather_rows.bytes += (world - 1) * _nbytes(x_local)
    return x


all_gather_rows.gathers = 0
all_gather_rows.bytes = 0


def ring_pass(block):
    """Send ``block`` to rank (me + 1) mod P and return the one received
    from rank (me - 1) mod P, both posted in one ``dist.batch_isend_irecv``
    (at P = 2 both go to the one peer). Counts one pass in
    ``ring_pass.passes`` and the bytes this rank sends in
    ``ring_pass.bytes``."""
    me, world = multihost.rank(), multihost.world_size()
    block = block.contiguous()
    buf = torch.empty_like(block)
    ops = [dist.P2POp(dist.isend, block, (me + 1) % world),
           dist.P2POp(dist.irecv, buf, (me - 1) % world)]
    for req in multihost.collective(dist.batch_isend_irecv, ops):
        req.wait()
    ring_pass.passes += 1
    ring_pass.bytes += _nbytes(block)
    return buf


ring_pass.passes = 0
ring_pass.bytes = 0


class GroupTransport:
    """The process group's transport: this process is rank ``ranks[0]`` of
    ``world`` (NCCL on the card, gloo on the CPU). Its methods take and
    return one block per rank this process runs, here one."""

    virtual = False

    def __init__(self):
        self.world = multihost.world_size()
        self.ranks = (multihost.rank(),)

    def all_gather(self, blocks):
        return all_gather_rows(blocks[0])

    def ring_pass(self, blocks):
        return [ring_pass(blocks[0])]

    def pairwise(self, blocks, tables, bufs):
        """The XOR route's sources of this rank (:func:`exchange`)."""
        return [exchange(blocks[0], tables, bufs)]

    def gather(self, values):
        """Every rank's row of small host integers, (world, k) in rank
        order, from ``values``, one row per rank this process runs (a host
        collective: every rank calls it)."""
        return multihost.allgather_host_values(
            np.asarray(values[0], dtype=np.int64))


class VirtualTransport:
    """P virtual ranks run in lockstep by one process on one device: the
    all-gather concatenates their blocks, the ring pass rotates the list
    (rank r receives rank r - 1's block), the pairwise exchange picks
    blocks by index. Counts in the same counters as the process group's,
    for every virtual rank. The sharded routes run the same table builders
    and ring bodies on it as on a process group: this is how one card
    holds them at full width."""

    virtual = True

    def __init__(self, world):
        self.world = int(world)
        self.ranks = tuple(range(self.world))

    def all_gather(self, blocks):
        all_gather_rows.gathers += self.world
        all_gather_rows.bytes += (self.world - 1) * sum(map(_nbytes,
                                                            blocks))
        return torch.cat(blocks, dim=1)

    def ring_pass(self, blocks):
        ring_pass.passes += self.world
        ring_pass.bytes += sum(map(_nbytes, blocks))
        return blocks[-1:] + blocks[:-1]

    def pairwise(self, blocks, tables, bufs):
        out = []
        for r in self.ranks:
            out.append([blocks[r ^ m_hi] for m_hi in tables.hi_list])
            n = sum(1 for m_hi in tables.hi_list if m_hi)
            exchange.exchanges += n
            exchange.bytes += n * _nbytes(blocks[r])
        return out

    def gather(self, values):
        return np.asarray(values, dtype=np.int64)


def ring(transport, blocks, body, accs):
    """The ring over ``transport.world`` steps: at step t every rank r of
    the transport runs ``acc = body(r, t, block, acc)`` on the block that
    started on rank (r - t) mod P, then the blocks move one rank on (not
    after the last step). Returns the accumulators, one per rank the
    transport runs."""
    blocks = list(blocks)
    accs = list(accs)
    for t in range(transport.world):
        accs = [body(r, t, b, a)
                for r, b, a in zip(transport.ranks, blocks, accs)]
        if t + 1 < transport.world:
            blocks = transport.ring_pass(blocks)
    return accs


class _Sharded:
    """A general route over the ranks of a transport: (2, local_right)
    blocks of x in, (2, local_left) blocks of y out, one per rank the
    transport runs (:meth:`apply`)."""

    engine = None

    def __init__(self, plan, transport):
        self.plan = plan
        self.transport = transport
        self.world = transport.world
        self.local_left = mesh.local_dim(plan.dim_left, self.world)
        self.local_right = mesh.local_dim(plan.dim_right, self.world)

    def rows(self, rank):
        """A rank's global row range, pad rows included."""
        start = rank * self.local_left
        return start, start + self.local_left

    def table_bytes(self, rank, dtype, device):
        """A rank's table bytes in ``dtype`` on ``device``, any rank's,
        without a collective (none for the sweeps)."""
        return 0

    def total_bytes(self, dtype, device):
        """The table bytes of every rank, summed."""
        return sum(self.table_bytes(r, dtype, device)
                   for r in range(self.world))


class ShardedEll(_Sharded):
    """The ELL engine over ranks (the JAX package's ``_build_sharded_ell``,
    ``apply.py:984``): each rank builds and packs the tables of its own
    rows (``tables[rank]``, an :class:`.ell.EllTables` over the gathered
    input's width), and an apply all-gathers x and launches the ELL kernel
    once on each rank's tables. The build gathers every rank's
    conservation flag and table bytes in one host collective: the flag is
    AND-reduced (``conserved``), the bytes kept (``rank_bytes``, in the
    build's dtype and device), so no later count needs a collective."""

    engine = 'ell'

    def __init__(self, plan, transport):
        from .. import config
        super().__init__(plan, transport)
        sdim_right = self.local_right * self.world
        self.tables = {r: ell.EllTables(plan, self.rows(r), sdim_right)
                       for r in transport.ranks}
        self._built = ell._key(config.real_dtype, config.device)
        stats = transport.gather([
            (self.tables[r].build_conserving(*self._built),
             self.tables[r].nbytes(*self._built))
            for r in transport.ranks])
        self.conserved = bool(stats[:, 0].all())
        self.rank_bytes = [int(b) for b in stats[:, 1]]

    def apply(self, xs):
        x = self.transport.all_gather(xs)
        return [ell.ell_apply(x, self.tables[r].on(x.dtype, x.device))
                for r in self.transport.ranks]

    def table_bytes(self, rank, dtype, device):
        """A rank's table bytes in ``dtype`` on ``device``: those of its
        build (:meth:`.ell.EllTables.nbytes`), else the most its packed
        tables can take (:func:`.ell.packed_bound`)."""
        if ell._key(dtype, device) == self._built:
            return self.rank_bytes[rank]
        return ell.packed_bound(self.plan, dtype, self.rows(rank))


class SweepGather(_Sharded):
    """The on-the-fly sweep over ranks, by all-gather (the JAX package's
    ``apply.py:691-757``): each rank sweeps its rows against the gathered
    input."""

    engine = 'sweep'

    def apply(self, xs):
        x = self.transport.all_gather(xs)
        return [general_sweep(x, self.plan, self.rows(r))
                for r in self.transport.ranks]


def ring_sweep_step(plan, world, rank, step, block, y):
    """One step of the ring sweep on ``rank`` (the JAX package's
    ``_build_sharded_ring_general``, ``apply.py:774``): ``block`` holds the
    (2, local_right) rows of rank (rank - step) mod world, and y (2,
    local_left) gains the products of this rank's rows with the columns in
    that block. Returns y."""
    local_left = mesh.local_dim(plan.dim_left, world)
    base = ((rank - step) % world) * block.shape[1]
    start = rank * local_left
    return _sweep_into(y, block, plan, (start, start + local_left), lo=base)


class SweepRing(_Sharded):
    """The on-the-fly sweep over ranks, by ring: the blocks of x pass
    around the ring and each rank sweeps its rows against every block
    (:func:`ring_sweep_step`), so a rank holds one block of x at a time
    and does the sweep's work P times."""

    engine = 'sweep_ring'

    def apply(self, xs):
        plan, world = self.plan, self.world
        ys = ring(self.transport, xs,
                  lambda r, t, b, y: ring_sweep_step(plan, world, r, t, b,
                                                     y),
                  [x.new_zeros((2, self.local_left)) for x in xs])
        general_sweep.applies += len(ys)
        return ys


def ring_general_wanted(plan, world):
    """Whether the sharded sweep passes x around the ring:
    ``config.sharded_ring_general`` when set, else whether a gathered
    input would take more than RING_GENERAL_BYTES (the JAX package's
    ``_ring_general_wanted``, ``apply.py:760``)."""
    from .. import config
    if config.sharded_ring_general is not None:
        return bool(config.sharded_ring_general)
    sdim_right = mesh.storage_dim(plan.dim_right, world)
    return 2 * sdim_right * config.real_dtype.itemsize > RING_GENERAL_BYTES


def _xor_engine(plan, left, right, world=1):
    """The XOR engine of a square XOR-mode plan over ``world`` ranks (a
    layout the XOR route takes): ('xor', its :class:`XorTables`) while the
    kernel's shared-memory tables hold it (not ``use_scan``, or tables that
    fit in float32 and in float64), ('xor_dense', the split of
    :func:`.xor_dense.choose_split`) where the XOR-dense engine takes it,
    else (None, None). Decided from global quantities only."""
    tables = XorTables(plan, left)
    if not plan.use_scan or _kernel_holds(tables):
        return 'xor', tables
    split = choose_split(plan, left, right, world)
    if split is not None:
        return 'xor_dense', split
    return None, None


def _sharded_choice(plan, left, right, world):
    """(route, XOR engine, its tables or split) over ``world`` ranks: see
    :func:`sharded_route`."""
    from .. import config
    if plan.xor_mode and plan.dim_left == plan.dim_right \
            and mesh.xor_layout(plan.dim_right, world):
        engine, made = _xor_engine(plan, left, right, world)
        if engine is not None:
            return 'xor', engine, made
    if not plan.groups:
        return 'zero', None, None
    if (config.use_sector and sector_supported(plan, left, right)
            and table_bytes_estimate(plan, left, right) <= ell.ell_budget()):
        return 'sector_ring', None, None
    if config.use_ell and ell.table_bytes(
            plan, mesh.storage_dim(plan.dim_left, world)) <= ell.ell_budget():
        return 'ell', None, None
    route = 'sweep_ring' if ring_general_wanted(plan, world) else 'sweep'
    return route, None, None


def sharded_route(plan, left, right, world):
    """The route of a plan over ``world`` ranks, in the JAX package's order
    (``_build_sharded_callable``, ``_build_sharded_general``,
    ``apply.py:598, :649``), from global quantities only: 'xor' for XOR
    pairs on a power-of-two world that divides the dimension, through the
    XOR kernel or, for a ``use_scan`` plan past its tables, the XOR-dense
    engine (:func:`_xor_engine`); 'zero' when no term is left; else the
    general route's 'sector_ring', 'ell', 'sweep_ring' or 'sweep' (where
    a many-mask XOR pair goes that neither XOR engine takes). The kernel
    and ``estimate_memory`` both take it from here."""
    return _sharded_choice(plan, left, right, world)[0]


def _kernel_holds(tables):
    """Whether the XOR kernel's shared-memory tables hold the operator, in
    float32 and in float64."""
    return all(tables.smem_bytes(itemsize) <= _MAX_SMEM
               for itemsize in (4, 8))


class OperatorKernel:
    """A matrix-free matvec y = A @ x for one subspace pair.

    ``apply(x)`` takes the (2, dim_right) stacked-real tensor and returns the
    (2, dim_left) result, on x's device and in x's dtype. Over ranks it
    takes and gives this rank's (2, local_dim) rows with a process group
    up, or, with a :class:`VirtualTransport` (``transport=``), the whole
    padded (2, storage_dim) vectors of its P virtual ranks;
    :meth:`apply_ranks` takes and gives the ranks' blocks.

    The engine's tables are ``tables`` (XOR pairs: :class:`XorTables`),
    ``xor_dense`` (many-mask XOR pairs: :class:`.xor_dense.XorDenseTables`,
    summarized in ``xor_dense_info``), ``sector_plan`` and
    ``sector_tables`` (SpinConserve pairs) or ``ell_tables`` (the ELL
    engine: :class:`.ell.EllTables`); none of them for the on-the-fly
    sweep. Over ranks the general route is ``sharded`` (a
    :class:`.sector_shard.SectorRing`, :class:`ShardedEll`,
    :class:`SweepRing` or :class:`SweepGather`). ``engine`` names the
    route. ``conserves_hint`` is the sector or ELL engine's conservation
    flag, a byproduct of its build, the same on every rank (None for the
    XOR engine, whose pairs are decided symbolically, and for the sweeps).
    """

    def __init__(self, msc, left, right, transport=None):
        from .. import config

        self.plan = _Plan(msc, left, right)
        self.left = left
        self.right = right
        self.tables = None
        self.xor_dense = None
        self.xor_dense_info = None
        self.sector_plan = None
        self.sector_tables = None
        self.ell_tables = None
        self.sharded = None
        self.conserves_hint = None
        self._krylov_ops = {}
        self._recv_bufs = {}
        if transport is None and multihost.world_size() > 1:
            transport = GroupTransport()
        self.transport = transport

        if transport is not None:
            self._build_over_ranks()
            return
        if self.plan.xor_mode:
            engine, made = _xor_engine(self.plan, left, right)
            if engine == 'xor':
                self.tables = made
                return
            if engine == 'xor_dense':
                self._build_xor_dense(made, (0,), 1)
                return
        if not self.plan.groups:
            return  # every term projected away, or none to begin with
        if config.use_sector and sector_supported(self.plan, left, right):
            self.sector_tables, self.sector_plan = build_sector_apply(
                self.plan, left, right)
            if self.sector_tables is not None:
                self.conserves_hint = self.sector_plan.conserved
                return
        if config.use_ell and ell.table_bytes(self.plan) <= ell.ell_budget():
            # the first set of tables, in the configured precision, also
            # gives the conservation flag (the JAX package's
            # _try_ell_local)
            self.ell_tables = ell.EllTables(self.plan)
            self.conserves_hint = self.ell_tables.build_conserving(
                config.real_dtype, config.device)

    def _build_over_ranks(self):
        """The route over ranks that :func:`sharded_route` names, built:
        the XOR route's tables (the kernel's, or the XOR-dense engine's
        for every rank the transport runs), or the general route's
        ``sharded`` object."""
        from .sector_shard import SectorRing
        plan, transport = self.plan, self.transport
        route, engine, made = _sharded_choice(plan, self.left, self.right,
                                              transport.world)
        if engine == 'xor':
            self.tables = made
        elif engine == 'xor_dense':
            self._build_xor_dense(made, transport.ranks, transport.world)
        elif route == 'sector_ring':
            self.sharded = SectorRing(plan, self.left, self.right,
                                      transport)
            self.sector_plan = self.sharded.sector_plan
            self.conserves_hint = self.sector_plan.conserved
        elif route == 'ell':
            self.sharded = ShardedEll(plan, transport)
            self.conserves_hint = self.sharded.conserved
        elif route != 'zero':
            self.sharded = {'sweep_ring': SweepRing,
                            'sweep': SweepGather}[route](plan, transport)

    def _build_xor_dense(self, split, ranks, world):
        self.xor_dense = build_xor_dense(self.plan, split, ranks, world)
        self.xor_dense_info = self.xor_dense.info

    def sharded_default(self):
        """Whether the solvers' own work vectors (eigsolve's start vector)
        are spread over ranks: over a transport of more than one rank, as
        the JAX package's over a mesh of more than one device."""
        return self.transport is not None and self.transport.world > 1

    @property
    def engine(self):
        """The route :meth:`apply` takes: 'xor', 'xor_dense', 'sector',
        'ell', 'sweep', over ranks 'xor', 'xor_dense', 'sector_ring',
        'ell', 'sweep_ring' or 'sweep', or 'zero' (no term left)."""
        if self.tables is not None:
            return 'xor'
        if self.sharded is not None:
            return self.sharded.engine
        if self.xor_dense is not None:
            return 'xor_dense'
        if self.sector_tables is not None:
            return 'sector'
        if self.ell_tables is not None:
            return 'ell'
        return 'sweep' if self.plan.groups else 'zero'

    def apply(self, x):
        """This rank's rows of y (every row without a process group; the
        virtual ranks' padded vector with a :class:`VirtualTransport`).

        Over ranks see :meth:`apply_ranks`."""
        x = x.contiguous()
        transport = self.transport
        if transport is None:
            dim = self.plan.dim_right
            if x.shape != (2, dim):
                raise ValueError(f'expected (2, {dim}) planes, got '
                                 f'{tuple(x.shape)}')
            if self.tables is not None:
                return self._apply_xor([[x]], (0,), 1)[0]
            if self.xor_dense is not None:
                return xor_dense_apply(x, self.xor_dense)
            if self.sector_tables is not None:
                return sector_apply(x, self.sector_tables)
            if self.ell_tables is not None:
                tables = self.ell_tables.on(x.dtype, x.device)
                return ell.ell_apply(x, tables)
            if not self.plan.groups:
                return x.new_zeros((2, self.plan.dim_left))
            return general_sweep(x, self.plan)
        n = mesh.local_dim(self.plan.dim_right, transport.world)
        want = (2, n * transport.world) if transport.virtual else (2, n)
        if x.shape != want:
            what = 'padded vector' if transport.virtual else 'rows'
            raise ValueError(f'expected this transport\'s {want} {what}, '
                             f'got {tuple(x.shape)}')
        ys = self.apply_ranks([x[:, i * n:(i + 1) * n].contiguous()
                               for i in range(len(transport.ranks))])
        return ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    def apply_ranks(self, xs):
        """The (2, local_left) rows of y of every rank the transport runs,
        from their (2, local_right) rows of x, in the order of
        ``transport.ranks``.

        The XOR route exchanges blocks with the ranks ``me ^ m_hi``, then
        launches the kernel once a rank, or runs the XOR-dense engine's
        apply once a rank on the same sources; the general routes are their
        ``sharded`` object's. The XOR route's receive buffers,
        ``len(hi_list) - 1`` blocks, are kept per dtype and device between
        calls, so the memory grows with the number of distinct high
        masks."""
        transport = self.transport
        dim, world = self.plan.dim_right, transport.world
        local_bits = mesh.local_dim(dim, world).bit_length() - 1
        if self.tables is not None:
            layout = self.tables.for_layout(local_bits)
            srcs = transport.pairwise(xs, layout,
                                      self._recv_bufs_for(xs[0], layout))
            return self._apply_xor(srcs, transport.ranks, world)
        if self.xor_dense is not None:
            layout = self.xor_dense.layout(local_bits)
            srcs = transport.pairwise(xs, layout,
                                      self._recv_bufs_for(xs[0], layout))
            return [xor_dense_apply_sharded(s, self.xor_dense,
                                            mesh.row0(dim, r, world))
                    for s, r in zip(srcs, transport.ranks)]
        if self.sharded is not None:
            return self.sharded.apply(xs)
        n = mesh.local_dim(self.plan.dim_left, world)
        return [x.new_zeros((2, n)) for x in xs]

    def _recv_bufs_for(self, x, layout):
        """The receive buffers of the pairwise exchange on ``layout`` (its
        ``hi_list``), one block per m_hi != 0, per dtype and device."""
        key = (x.dtype, x.device)
        if key not in self._recv_bufs:
            self._recv_bufs[key] = torch.empty(
                (len(layout.hi_list) - (0 in layout.hi_list),) + x.shape,
                dtype=x.dtype, device=x.device)
        return self._recv_bufs[key]

    def _apply_xor(self, srcs, ranks, world):
        """The XOR kernel's sharded route, once per rank, on its sources."""
        dim = self.plan.dim_right
        if self.tables.n_groups == 0:
            return [torch.zeros_like(s[0]) for s in srcs]
        tables = self.tables.for_layout(
            self.tables.nbits - mesh.device_bits(dim, world))
        return [xor_apply_sharded(s, tables, mesh.row0(dim, r, world))
                for s, r in zip(srcs, ranks)]

    def krylov_ops(self, m):
        """Cached Krylov building blocks for subspace size m."""
        if m not in self._krylov_ops:
            from ..solvers.krylov import KrylovOps
            self._krylov_ops[m] = KrylovOps(self.apply, m)
        return self._krylov_ops[m]
