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
  (:mod:`.sector_apply`), dense matmuls over the sector-major blocks;
* every other pair (Explicit/Auto, projections such as Full -> Parity,
  rectangular SpinConserve pairs, many-mask XOR operators the XOR-dense
  engine declines, SpinConserve operators past the sector engine's limits):
  the ELL engine (:mod:`.ell`), precomputed (G, rows) tables applied by the
  hand-written kernel ``csrc/ell_apply.cu``, while ``config.use_ell`` is
  set and the tables fit ``config.ell_budget``; otherwise the on-the-fly
  sweep :func:`general_sweep` (torch ops).

Once a process group is up (:func:`..parallel.multihost.initialize`), each
rank holds a (2, local_dim) block of rows (:mod:`..parallel.mesh`) and the
XOR apply exchanges blocks pairwise with the ranks its masks reach, then runs
the kernel's sharded route once (:meth:`OperatorKernel.apply`). The sector,
XOR-dense and general engines and XParity pairs do not run distributed yet
(ROADMAP.md queue 1, item 12).
"""

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh, multihost
from ..utils.bitwise import parity as parity_np
from . import ell
from . import msc as msc_mod
from .index_maps import device_map, parity
from .sector_apply import build_sector_apply, sector_apply, sector_supported
from .xor_apply import _MAX_SMEM, XorTables, xor_apply_sharded
from .xor_dense import build_xor_dense, xor_dense_apply, xor_dense_supported

# operators with more mask groups than this, or more terms than the next,
# are ``use_scan`` (the JAX package's ops/apply.py limits): here they may
# leave the XOR kernel for the XOR-dense engine, once its tables overflow
UNROLL_GROUP_LIMIT = 128
UNROLL_TERM_LIMIT = 512
# rows per chunk of the on-the-fly sweep (as ops/reductions.py)
SWEEP_CHUNK_BITS = 20


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


def general_sweep(x, plan):
    """y = A x on the fly, for any subspace pair: over rows in chunks of
    2**SWEEP_CHUNK_BITS, for each mask group, bra = i2s_left(row) ^ m, its
    Walsh coefficient, and x[s2i_right(bra)] where the image is valid (the
    JAX package's general branches of ``_build_local``,
    ``_build_local_chunked`` and ``_build_local_scan``). Torch ops, the
    same on every device; the route over ``config.ell_budget`` or with
    ``config.use_ell = False``, and the oracle of the ELL tables. Counts
    its calls in ``general_sweep.applies``."""
    dtype = x.dtype
    y = x.new_zeros((2, plan.dim_left))
    C = 1 << SWEEP_CHUNK_BITS
    for start in range(0, plan.dim_left, C):
        stop = min(start + C, plan.dim_left)
        rows = torch.arange(start, stop, dtype=torch.int64, device=x.device)
        kets = plan.row_states(rows)
        yr, yi = y[0, start:stop], y[1, start:stop]
        for m, _perm, signs, coeffs in plan.groups:
            bra = kets ^ m
            fr, fi = _group_coefficient(bra, signs, coeffs, dtype)
            col, valid = plan.right_map.s2i(bra)
            xp = x[:, torch.where(valid, col, 0)]
            ok = valid.to(dtype)
            if fr is not None:
                fr = fr * ok
                yr += fr * xp[0]
                yi += fr * xp[1]
            if fi is not None:
                fi = fi * ok
                yr -= fi * xp[1]
                yi += fi * xp[0]
    general_sweep.applies += 1
    return y


general_sweep.applies = 0


def exchange(x_local, tables, bufs):
    """Fill ``bufs[i - 1]`` with the block of rank ``me ^ hi_list[i]``, for
    every m_hi != 0 of ``tables.hi_list`` (a :class:`ShardedXorTables`), by
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
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        exchange.exchanges += len(ops) // 2
        exchange.bytes += len(ops) // 2 * x_local.numel() \
            * x_local.element_size()
    return srcs


exchange.exchanges = 0
exchange.bytes = 0


def _kernel_holds(tables):
    """Whether the XOR kernel's shared-memory tables hold the operator, in
    float32 and in float64."""
    return all(tables.smem_bytes(itemsize) <= _MAX_SMEM
               for itemsize in (4, 8))


class OperatorKernel:
    """A matrix-free matvec y = A @ x for one subspace pair.

    ``apply(x)`` takes the (2, dim_right) stacked-real tensor and returns the
    (2, dim_left) result, on x's device and in x's dtype. With a process
    group up, x and the result are this rank's (2, local_dim) rows.

    The engine's tables are ``tables`` (XOR pairs: :class:`XorTables`),
    ``xor_dense`` (many-mask XOR pairs: :class:`.xor_dense.XorDenseTables`,
    summarized in ``xor_dense_info``), ``sector_plan`` and
    ``sector_tables`` (SpinConserve pairs) or ``ell_tables`` (the ELL
    engine: :class:`.ell.EllTables`); none of them for the on-the-fly
    sweep. ``engine`` names the route. ``conserves_hint`` is the sector or
    ELL engine's conservation flag, a byproduct of its build (None for the
    XOR engine, whose pairs are decided symbolically, and for the sweep).
    """

    def __init__(self, msc, left, right):
        from .. import subspaces as sp

        self.plan = _Plan(msc, left, right)
        self.left = left
        self.right = right
        self.tables = None
        self.xor_dense = None
        self.xor_dense_info = None
        self.sector_plan = None
        self.sector_tables = None
        self.ell_tables = None
        self.conserves_hint = None
        self._krylov_ops = {}
        self._recv_bufs = {}

        distributed = multihost.world_size() > 1
        xparity = isinstance(left, sp.XParity) or isinstance(right, sp.XParity)
        if self.plan.xor_mode:
            if distributed and xparity:
                raise NotImplementedError(
                    'XParity operators over ranks are not ported yet '
                    '(ROADMAP.md queue 1, item 12)')
            tables = XorTables(self.plan, left)
            if not self.plan.use_scan or _kernel_holds(tables):
                self.tables = tables
                return
            if xor_dense_supported(self.plan):
                if distributed:
                    raise NotImplementedError(
                        'the XOR-dense engine over ranks is not ported yet '
                        '(ROADMAP.md queue 1, item 12)')
                self.xor_dense = build_xor_dense(self.plan, left, right)
                if self.xor_dense is not None:
                    self.xor_dense_info = self.xor_dense.info
                    return
        if not self.plan.groups:
            return  # every term projected away, or none to begin with
        if distributed:
            raise NotImplementedError(
                f'the ({left!r}, {right!r}) pair over ranks needs the '
                'sharded sector, ELL or general engine, which is not ported '
                'yet (ROADMAP.md queue 1, item 12)')
        if sector_supported(self.plan, left, right):
            self.sector_tables, self.sector_plan = build_sector_apply(
                self.plan, left, right)
            if self.sector_tables is not None:
                self.conserves_hint = self.sector_plan.conserved
                return
        from .. import config
        if config.use_ell and ell.table_bytes(self.plan) <= ell.ell_budget():
            # the first set of tables, in the configured precision, also
            # gives the conservation flag (the JAX package's
            # _try_ell_local)
            self.ell_tables = ell.EllTables(self.plan)
            self.conserves_hint = self.ell_tables.build_conserving(
                config.real_dtype, config.device)

    @property
    def engine(self):
        """The route :meth:`apply` takes: 'xor', 'xor_dense', 'sector',
        'ell', 'sweep', or 'zero' (no term left)."""
        if self.tables is not None:
            return 'xor'
        if self.xor_dense is not None:
            return 'xor_dense'
        if self.sector_tables is not None:
            return 'sector'
        if self.ell_tables is not None:
            return 'ell'
        return 'sweep' if self.plan.groups else 'zero'

    def apply(self, x):
        """This rank's rows of y (every row without a process group).

        The sector, XOR-dense, ELL and sweep routes run on one device. The
        XOR engine exchanges blocks with the ranks ``me ^ m_hi``, then
        launches the kernel once. Without a group, or on one rank, the
        layout is one block and nothing is exchanged. The receive buffers,
        ``len(hi_list) - 1`` blocks, are kept per dtype and device between
        calls, so the memory grows with the number of distinct high masks."""
        x = x.contiguous()
        dim = self.plan.dim_right
        if self.tables is None:
            if x.shape != (2, dim):
                raise ValueError(f'expected (2, {dim}) planes, got '
                                 f'{tuple(x.shape)}')
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
        n = mesh.local_dim(dim)
        if x.shape != (2, n):
            raise ValueError(f'expected this rank\'s (2, {n}) rows, got '
                             f'{tuple(x.shape)}')
        if self.tables.n_groups == 0:
            return torch.zeros_like(x)
        tables = self.tables.for_layout(self.tables.nbits
                                        - mesh.device_bits(dim))
        key = (x.dtype, x.device)
        if key not in self._recv_bufs:
            self._recv_bufs[key] = torch.empty(
                (len(tables.hi_list) - (0 in tables.hi_list), 2, n),
                dtype=x.dtype, device=x.device)
        srcs = exchange(x, tables, self._recv_bufs[key])
        return xor_apply_sharded(srcs, tables, mesh.row0(dim))

    def krylov_ops(self, m):
        """Cached Krylov building blocks for subspace size m."""
        if m not in self._krylov_ops:
            from ..solvers.krylov import KrylovOps
            self._krylov_ops[m] = KrylovOps(self.apply, m)
        return self._krylov_ops[m]
