"""
The XOR-dense channel engine for many-mask XOR-mode operators (SYK): the
JAX package's ``ops/xor_dense.py`` as torch ops, its products in cuBLAS.

On an XOR-mode pair (Full/Parity, or XParity over either) a term acts in
index space as

    y[j] += c * (-1)^{pc(j & s)} * x[j ^ m].

Split the index j = (h, a) into high/low parts (a = La low bits) and view
each plane of the state as an (nh, na) matrix. Terms that share the high
parts (mh, sh) of their mask and sign and the type of their coefficient
(purely real or purely imaginary; every Pauli-string term is one or the
other) merge into one channel:

    Y += diag((-1)^{pc(h & sh)}) . X[h ^ mh, :] @ B_{mh,sh,type}^T

where B[a_out, a_in] = sum of c * sign * (-1)^{pc(a_out & s_low)} over the
channel's terms with a_in = a_out ^ m_low. A real-type channel multiplies
both planes by B; an imaginary-type one rotates them (yr -= B xi, yi += B
xr). The channel keys and the host sums that make each B are the JAX
package's, so at a fixed La the tables are equal bitwise.

The apply (:func:`xor_dense_apply`) takes the channels of one type in
batches of up to ``CHANNEL_BATCH``. For a batch of KB channels the
gathered, signed source rows form A (2 nh, KB na), row (plane, h), column
(channel, a_in), and the batch's stacked B^T form (KB na, na); then one
product A @ [B_1^T; ...; B_KB^T] sums the batch's channels into y. A batch
is three torch ops (a row gather, a sign multiply, an ``addmm_`` into y;
the imaginary class takes two ``addmm_``, one per plane). TF32 stays off
(``config``): float32 products run in full float32, float64 ones in DGEMM.

The tables go to the device without a full host copy: the host sums each
channel's terms per distinct m_low into a line of na values (the entries
B[a, a ^ m_low]), and the device table, zeroed, receives the lines by one
scatter per chunk of lines.

La minimizes a cost model (dense products, table stream, per-batch host
cost) under the table budget ``config.ell_budget`` (default 4 GiB, counting
the padded channels of the last batch of each class and every table the
engine allocates). Its constants (:data:`COST_MODEL`) were fitted on an
H100 (``chip_smoke.py --xor-dense-la``; PERF.md).

Over P ranks (a power-of-two world that divides the dimension, the XOR
route's layout), rank r holds the rows h in [r nh/P, (r + 1) nh/P), so a
channel (mh, sh, type) reads its source rows from the block of rank
r ^ m_hi, m_hi = mh >> (local_bits - La): the XOR route's high masks, and
its pairwise exchange. :func:`xor_dense_apply_sharded` takes one rank's
source blocks, one per entry of the layout's ``hi_list``
(:meth:`XorDenseTables.layout`), stacked as one (2, S nh_local, na) view.
The channel matrices are the same on every rank, so the ranks that one
process runs share them; only the row gathers and signs are a rank's own
(:meth:`XorDenseTables.on`), the signs taken on the global h. La is capped
at a rank's ``local_bits``, so a channel's low part stays inside a block.
:func:`xor_dense_apply` is the one-block call.

The engine's plain version is the XOR kernel's
:func:`.xor_apply.xor_apply_reference`, the on-the-fly sweep over the
terms.
"""

from collections import namedtuple

import numpy as np
import torch

from .. import tracing
from ..utils.bitwise import parity
from .ell import ell_budget
from .xor_apply import hi_list

MIN_DIM = 1 << 12     # below this, launch overhead dominates any engine
CHANNEL_BATCH = 64    # channels per product (the JAX package's batch)
_COEFF_TOL = 0.0      # exact: a term is real xor imaginary
_SCATTER_LINES = 4096  # lines per device scatter of the table build

#: The split's cost model: ``gemm_flops`` the products' rate, reached by
#: channels of width na at na / (na + ``halfwidth``); ``tile`` the product
#: tile the rows and columns are padded to; ``hbm_bps`` the table stream's
#: rate; ``step_s`` the host cost of one batch.
CostModel = namedtuple('CostModel',
                       'gemm_flops hbm_bps step_s tile halfwidth')
# fitted on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
# --xor-dense-la: SYK N=32 at La = 4..10 and N=40 at La = 9, float32; 9.5%
# rms error in log time; PERF.md): cuBLAS pads no tile, the products reach
# 52 TFLOP/s at wide channels, half of it at na = 128, and a batch costs
# ~30 us of host time that the device does not hide
COST_MODEL = CostModel(gemm_flops=52e12, hbm_bps=3.35e12, step_s=30e-6,
                       tile=1, halfwidth=128)


def _typed_channels_at(groups, eff, La):
    """Distinct (mh, sh, type) channel keys at a given split."""
    keys = set()
    for gi, (m, pm, signs, coeffs) in enumerate(groups):
        mh = pm >> La
        for (s_eff, _sgn), c in zip(eff[gi], coeffs):
            if abs(c.real) > _COEFF_TOL:
                keys.add((mh, s_eff >> La, 0))
            if abs(c.imag) > _COEFF_TOL:
                keys.add((mh, s_eff >> La, 1))
    return keys


def _padded(count):
    """Channels a class of ``count`` channels allocates: whole batches."""
    batch = min(CHANNEL_BATCH, count)
    return -(-count // batch) * batch if count else 0


def table_bytes(keys, La, nbits, coeff_bytes):
    """Device bytes of the tables for channel ``keys``: per padded channel
    its (na, na) matrix, its row index (int64) and row signs."""
    na, nh = 1 << La, 1 << (nbits - La)
    c_pad = sum(_padded(sum(1 for k in keys if k[2] == typ))
                for typ in (0, 1))
    return c_pad * (na * na * coeff_bytes + nh * 8 + nh * coeff_bytes)


def modeled_seconds(C, La, nbits, coeff_bytes, model=COST_MODEL):
    """The cost model's time of one apply with C channels at split La."""
    na = 1 << La
    nh = 1 << (nbits - La)
    # planes fold into rows: (2*nh, na) @ (na, na), padded to the product
    # tile; narrow channels underfill it
    flops = C * max(2 * nh, model.tile) * max(na, model.tile) * na * 2
    eff_rate = na / (na + model.halfwidth)
    return (flops / (model.gemm_flops * eff_rate)
            + (C * na * na * coeff_bytes + C * nh * na * 8) / model.hbm_bps
            + (C / CHANNEL_BATCH) * model.step_s)


def pick_split(groups, eff, nbits, budget, coeff_bytes, model=COST_MODEL,
               local_bits=None):
    """Choose La minimizing modeled apply time under the table budget, for
    one rank's block of 2**local_bits rows (the whole space by default):
    La at most local_bits, the tables and time those of one rank. Returns
    (modeled seconds, La, channels, table bytes) or None."""
    if local_bits is None:
        local_bits = nbits
    best = None
    for La in range(max(1, nbits // 2 - 3), min(nbits, local_bits + 1)):
        keys = _typed_channels_at(groups, eff, La)
        table = table_bytes(keys, La, local_bits, coeff_bytes)
        if table > budget:
            continue
        t = modeled_seconds(len(keys), La, local_bits, coeff_bytes, model)
        if best is None or t < best[0]:
            best = (t, La, len(keys), table)
    return best


def xor_dense_supported(plan):
    """Whether the engine takes this plan: a square XOR-mode pair of
    power-of-two dimension at least MIN_DIM, with more groups or terms than
    the unrolled paths take (``plan.use_scan``)."""
    from .. import config
    if not getattr(config, 'use_xor_dense', True):
        return False
    if not plan.xor_mode or plan.dim_left != plan.dim_right:
        return False
    if not plan.use_scan:
        return False  # few-mask operators keep the XOR kernel
    if plan.dim_right < MIN_DIM:
        return False
    return (plan.dim_right & (plan.dim_right - 1)) == 0


def _local_bits(nbits, world):
    """Bits of one rank's block over a power-of-two ``world``."""
    return nbits - (int(world).bit_length() - 1)


#: One rank layout of the engine: blocks of 2**local_bits rows, the
#: sources' high masks and each class's channel sources (per class an array
#: of indices into ``hi_list``).
DenseLayout = namedtuple('DenseLayout', 'local_bits hi_list channel_src')


class XorDenseTables:
    """The typed channels of one plan at a split La, on the host as lines
    and on a device as the apply's tables (:meth:`on`).

    * ``classes`` — per coefficient type present (0 real, 1 imaginary):
      (type, keys), the channel keys (mh, sh, type) sorted;
    * ``lines`` — per class: (channel, m_low, values) arrays, the nonzero
      diagonals B[a, a ^ m_low] of each channel's matrix (float64);
    * ``channels``, ``padded_channels``, ``table_bytes`` (the device tables
      of ``config.real_dtype`` on one device; over ranks see
      :meth:`rank_table_bytes`).
    """

    def __init__(self, plan, eff, La, coeff_bytes):
        nbits = plan.dim_right.bit_length() - 1
        self.nbits = nbits
        self.La = La
        na = 1 << La
        self.na = na
        self.nh = 1 << (nbits - La)
        self.coeff_bytes = coeff_bytes
        self.perm_masks = [int(g[1]) for g in plan.groups]
        amask = na - 1

        # ---- host sums of the typed channel matrices, by line ----------
        # (the JAX package's B[a, cols] += part * w, with each matrix's
        # entries on the diagonal of its m_low kept as one line)
        chan = {}
        a = np.arange(na, dtype=np.int64)
        for gi, (m, pm, signs, coeffs) in enumerate(plan.groups):
            pm = int(pm)
            mh, ml = pm >> La, pm & amask
            for (s_eff, const_sign), c in zip(eff[gi], coeffs):
                sh, sa = s_eff >> La, s_eff & amask
                w = 1.0 - 2.0 * parity(a & sa)
                for typ, part in ((0, (complex(c) * const_sign).real),
                                  (1, (complex(c) * const_sign).imag)):
                    if abs(part) <= _COEFF_TOL:
                        continue
                    lines = chan.setdefault((mh, sh, typ), {})
                    line = lines.get(ml)
                    if line is None:
                        line = lines[ml] = np.zeros(na, dtype=np.float64)
                    line += part * w

        self.classes, self.lines = [], []
        for typ in (0, 1):
            keys = sorted(k for k in chan if k[2] == typ)
            if not keys:
                continue
            ci, mls, vals = [], [], []
            for i, key in enumerate(keys):
                for ml, line in chan[key].items():
                    ci.append(i)
                    mls.append(ml)
                    vals.append(line)
            self.classes.append((typ, keys))
            self.lines.append((np.asarray(ci, dtype=np.int64),
                               np.asarray(mls, dtype=np.int64),
                               np.stack(vals)))
        self.channels = sum(len(keys) for _t, keys in self.classes)
        self.padded_channels = sum(_padded(len(keys))
                                   for _t, keys in self.classes)
        self.table_bytes = self.rank_table_bytes(1)
        self._mats = {}
        self._rank_tables = {}
        self._layouts = {}

    @property
    def info(self):
        """The split, channels and tables, as the JAX package's
        ``xor_dense_info`` reports them, and the padded channels and torch
        ops per apply."""
        return {'La': self.La, 'channels': self.channels,
                'padded_channels': self.padded_channels,
                'table_bytes': self.table_bytes,
                'torch_ops_per_apply': self.torch_ops_per_apply}

    @property
    def torch_ops_per_apply(self):
        """Torch ops one apply runs, each one launch or more (the zeroed
        output, then per batch a gather, a sign multiply and one product,
        two in the imaginary class); only a profiler counts the launches."""
        n = 1
        for typ, keys in self.classes:
            n += (len(keys) + CHANNEL_BATCH - 1) // CHANNEL_BATCH * (3 + typ)
        return n

    @property
    def dense_flops(self):
        """Float operations of the products per apply (padded channels
        included, 2 per multiply-add, both planes)."""
        return self.padded_channels * 2 * (2 * self.nh) * self.na * self.na

    @property
    def mat_bytes(self):
        """Device bytes of the channel matrices, which every rank a process
        runs shares."""
        return self.padded_channels * self.na * self.na * self.coeff_bytes

    def rank_table_bytes(self, world):
        """Device bytes of one rank's tables over ``world`` ranks: the
        channel matrices and its row gathers and signs (every rank holds
        the matrices on a device of its own)."""
        return table_bytes([k for _t, keys in self.classes for k in keys],
                           self.La, _local_bits(self.nbits, world),
                           self.coeff_bytes)

    def layout(self, local_bits):
        """The :class:`DenseLayout` of blocks of 2**local_bits rows
        (cached): La must not pass local_bits."""
        if local_bits not in self._layouts:
            if not self.La <= local_bits <= self.nbits:
                raise ValueError(f'a block of 2**{local_bits} rows does not '
                                 f'hold a channel of 2**{self.La} columns in '
                                 f'a space of 2**{self.nbits}')
            his = hi_list(self.perm_masks, local_bits)
            shift = local_bits - self.La
            src = [np.searchsorted(his, np.asarray(
                [mh >> shift for mh, _sh, _t in keys], dtype=np.int64))
                for _typ, keys in self.classes]
            self._layouts[local_bits] = DenseLayout(local_bits, his, src)
        return self._layouts[local_bits]

    def mats(self, dtype, device):
        """Per class (imaginary, Mt, KB) in ``dtype`` on ``device``, built
        once: Mt (C_pad, na, na) the transposed matrices B^T, in batches of
        KB channels."""
        key = (dtype, device)
        if key in self._mats:
            return self._mats[key]
        na = self.na
        a = torch.arange(na, dtype=torch.int64, device=device)
        runs = []
        for (typ, keys), (ci, mls, vals) in zip(self.classes, self.lines):
            Mt = torch.zeros((_padded(len(keys)), na, na), dtype=dtype,
                             device=device)
            for s in range(0, len(ci), _SCATTER_LINES):
                sl = slice(s, s + _SCATTER_LINES)
                c = torch.as_tensor(ci[sl], device=device)[:, None]
                ml = torch.as_tensor(mls[sl], device=device)[:, None]
                v = torch.as_tensor(vals[sl]).to(dtype).to(device)
                # B[a, a ^ ml] = v[a], stored transposed
                Mt[c, a[None, :] ^ ml, a[None, :]] = v
            runs.append((bool(typ), Mt, min(CHANNEL_BATCH, len(keys))))
        self._mats[key] = runs
        return runs

    def on(self, dtype, device, rank=0, world=1):
        """The apply's tables of ``rank`` of ``world`` in ``dtype`` on
        ``device``, built once: per class (imaginary, Mt, ridx, wt, KB) with
        Mt the shared matrices (:meth:`mats`) and, per batch, the rank's row
        gather ridx[b] of nh_local * KB rows (row h, then channel) into its
        stacked source blocks and signs wt[b] (nh_local, KB, 1). Channel
        (mh, sh) of local row h reads row src * nh_local + (h ^ (mh &
        (nh_local - 1))), src its source's index in the layout's hi_list,
        with the sign (-1)^pc((rank * nh_local + h) & sh); a padded channel
        reads row h, with sign 0. The first call for a key is the span
        ``build.upload``, counted in ``build.uploads``."""
        key = (int(rank), int(world), dtype, device)
        if key not in self._rank_tables:
            tracing.count('build.uploads')
            with tracing.span('build.upload'):
                self._rank_tables[key] = self._upload(dtype, device, rank,
                                                      world)
        return self._rank_tables[key]

    def _upload(self, dtype, device, rank, world):
        local_bits = _local_bits(self.nbits, world)
        lay = self.layout(local_bits)
        nhl = 1 << (local_bits - self.La)
        h = np.arange(nhl, dtype=np.int64)
        hg = (int(rank) << (local_bits - self.La)) + h
        runs = []
        for (imag, Mt, KB), (_typ, keys), src in zip(
                self.mats(dtype, device), self.classes, lay.channel_src):
            c_pad = Mt.shape[0]
            rowidx = np.tile(h, (c_pad, 1))
            wh = np.zeros((c_pad, nhl))
            for i, (mh, sh, _t) in enumerate(keys):
                rowidx[i] = src[i] * nhl + (h ^ (mh & (nhl - 1)))
                wh[i] = 1.0 - 2.0 * parity(hg & sh)
            nb = c_pad // KB
            ridx = torch.as_tensor(
                rowidx.reshape(nb, KB, nhl).transpose(0, 2, 1)
                .reshape(nb, -1).copy(), device=device)
            wt = torch.as_tensor(
                wh.reshape(nb, KB, nhl).transpose(0, 2, 1)[..., None].copy(),
                device=device).to(dtype)
            runs.append((imag, Mt, ridx, wt, KB))
        return runs


def choose_split(plan, left, right, world=1):
    """(eff, La, coeff_bytes, table_bytes) of the split the engine would
    build for the plan in ``config.real_dtype`` over ``world`` ranks (a
    power-of-two world dividing the dimension), or None when it declines
    the plan (unsupported, or no split under ``config.ell_budget``). La is
    capped at a rank's local bits; table_bytes is one rank's. Every input is
    global, so every rank chooses alike."""
    from .. import config
    from .xor_apply import _effective_sign_mask

    if not xor_dense_supported(plan):
        return None

    nbits = plan.dim_right.bit_length() - 1
    local_bits = _local_bits(nbits, world)
    cb = torch.empty((), dtype=config.real_dtype).element_size()

    # effective index-space sign masks (folds the Parity subspace bit)
    eff = []
    try:
        for m, pm, signs, coeffs in plan.groups:
            eff.append([_effective_sign_mask(int(s), int(m), left, right)
                        for s in signs])
    except TypeError:
        return None

    budget = ell_budget()
    # manual override for tuning experiments (config.xor_dense_la)
    La_cfg = getattr(config, 'xor_dense_la', None)
    if La_cfg is not None:
        La = int(La_cfg)
        if La > local_bits:
            raise ValueError(f'config.xor_dense_la = {La}: over the cap of '
                             f'{local_bits}, the bits of one rank\'s block '
                             f'of a dimension 2**{nbits} over {world} ranks')
        need = table_bytes(_typed_channels_at(plan.groups, eff, La), La,
                           local_bits, cb)
        if need > budget:
            raise ValueError(f'config.xor_dense_la = {La}: its tables take '
                             f'{need} bytes, over config.ell_budget = '
                             f'{budget}')
        return eff, La, cb, need
    pick = pick_split(plan.groups, eff, nbits, budget, cb,
                      local_bits=local_bits)
    if pick is None:
        return None
    return eff, pick[1], cb, pick[3]


def build_xor_dense(plan, split, ranks=(0,), world=1):
    """The engine's :class:`XorDenseTables` for a plan at a split of
    :func:`choose_split`, with the tables of each of ``ranks`` of ``world``
    built in ``config.real_dtype`` on ``config.device`` (the matrices
    once)."""
    from .. import config
    eff, La, cb, _need = split
    tables = XorDenseTables(plan, eff, La, cb)
    for r in ranks:
        tables.on(config.real_dtype, config.device, r, world)
    return tables


def xor_dense_apply_sharded(srcs, tables, row0):
    """Rows [row0, row0 + local_dim) of y = H x through the channels of
    :class:`XorDenseTables`, from one rank's source blocks: ``srcs[i]`` the
    (2, local_dim) block of x of rank (row0 / local_dim) ^ hi_list[i] of
    the layout (:meth:`XorDenseTables.layout`). Torch ops on x's device and
    in x's dtype; for a batch of channels one row gather from the stacked
    sources, one sign multiply and one ``addmm_`` (two for the imaginary
    class). Counts one call in ``xor_dense.applies``; it launches no
    kernel of its own (the products are cuBLAS's). An unusable input
    raises."""
    n = srcs[0].shape[-1]
    local_bits = n.bit_length() - 1
    if n != 1 << local_bits:
        raise ValueError(f'xor_dense_apply: a block of {n} rows is not a '
                         'power of two')
    lay = tables.layout(local_bits)
    if len(srcs) != len(lay.hi_list):
        raise ValueError(f'xor_dense_apply: {len(lay.hi_list)} source '
                         f'blocks expected, got {len(srcs)}')
    if any(s.shape != (2, n) for s in srcs):
        raise ValueError(f'xor_dense_apply: every source block must be (2, '
                         f'{n}), got {[tuple(s.shape) for s in srcs]}')
    dim = 1 << tables.nbits
    if row0 % n or not 0 <= row0 < dim:
        raise ValueError(f'xor_dense_apply: row offset {row0} is not a '
                         'block start')
    world = dim // n
    na = tables.na
    nhl = n // na
    x = srcs[0] if len(srcs) == 1 else torch.stack(list(srcs), dim=1)
    xv = x.reshape(2, -1, na)
    y = srcs[0].new_zeros((2, n))
    yv = y.view(2 * nhl, na)
    for imag, Mt, ridx, wt, KB in tables.on(x.dtype, x.device, row0 // n,
                                            world):
        for b in range(ridx.shape[0]):
            A = xv.index_select(1, ridx[b]).view(2, nhl, KB, na)
            A.mul_(wt[b])
            Bt = Mt[b * KB:(b + 1) * KB].view(KB * na, na)
            A = A.view(2, nhl, KB * na)
            if imag:
                # y += i (B x): yr -= B xi, yi += B xr
                yv[:nhl].addmm_(A[1], Bt, alpha=-1)
                yv[nhl:].addmm_(A[0], Bt)
            else:
                yv.addmm_(A.view(2 * nhl, KB * na), Bt)
    tracing.count('xor_dense.applies')
    return y


def xor_dense_apply(x, tables):
    """y = H x on (2, dim) planes holding every row: the sharded apply with
    one block (one source, row offset 0), counted in
    ``xor_dense.applies``."""
    return xor_dense_apply_sharded([x], tables, 0)
