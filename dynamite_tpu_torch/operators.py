"""
Symbolic Pauli-string operators and their algebra.

An Operator holds an MSC term list plus a registry of (left, right) subspace
pairs; for each pair it builds (and caches) a matrix-free matvec kernel
(:class:`dynamite_tpu_torch.ops.apply.OperatorKernel`) — the analog of the
reference's per-subspace-pair PETSc shell matrices
(reference: src/dynamite/operators.py).
"""

import re
import warnings
from dataclasses import dataclass
from string import ascii_lowercase
from zlib import crc32

import numpy as np

from . import config, tracing
from .utils import validate
from .utils.bitwise import parity
from .ops import msc as msc_tools
from .ops.apply import _base
from .parallel import multihost
from .subspaces import Explicit, Full, Parity
from .states import State


class Operator:
    """A quantum operator: a sum of coefficiented Pauli strings.

    Usually built via the factory functions in this module (sigmax, op_sum,
    index_sum, ...) rather than instantiated directly.
    """

    def __init__(self, msc=None, text=None):
        self._max_spin_idx = None
        self._kernels = {}
        self._norm_cache = {}
        self._is_reduced = False
        self._shell = config.shell
        self._precompute_diagonal = True
        self._allow_projection = False
        self._msc = None

        if msc is not None:
            self.msc = msc

        if config.subspace is not None:
            self._subspaces = [(config.subspace, config.subspace)]
        else:
            self._subspaces = [(Full(), Full())]

        if config.L is not None:
            self.L = config.L

        self._text = text if text is not None else OpText()

    def copy(self):
        """A copy of the operator (without its compiled kernels)."""
        rtn = Operator()
        rtn.msc = self.msc.copy()
        rtn.is_reduced = self.is_reduced
        rtn.shell = self.shell
        rtn.allow_projection = self.allow_projection
        if self._subspaces:
            for left, right in self.get_subspace_list():
                rtn.add_subspace(left, right)
        rtn._text = self._text  # immutable, safe to share
        return rtn

    # computations — bound from computations.py, which imports this
    # package's solvers and states, so the import waits for the first call
    def evolve(self, *args, **kwargs):
        from .computations import evolve
        return evolve(self, *args, **kwargs)

    def eigsolve(self, *args, **kwargs):
        from .computations import eigsolve
        return eigsolve(self, *args, **kwargs)

    @classmethod
    def from_msc(cls, msc):
        """An operator from an MSC structured array (masks, signs, coeffs)
        — e.g. the ``msc`` of a JAX-package operator, carried across as
        numpy."""
        return cls(msc=np.array(msc, dtype=msc_tools.msc_dtype),
                   text=_text_atom('[operator from msc]',
                                   r'\left[\text{operator from msc}\right]',
                                   '<Operator from msc>'))

    # -- length and dimensions -------------------------------------------------

    @property
    def max_spin_idx(self):
        """Largest spin index on which the operator has support."""
        if self._max_spin_idx is None:
            self._max_spin_idx = (0 if self.msc is None
                                  else msc_tools.max_spin_idx(self.msc))
        return self._max_spin_idx

    @property
    def L(self):
        """The spin chain length."""
        self._update_L_from_subspaces()
        return self.left_subspace.L

    def _update_L_from_subspaces(self):
        L = None
        for pair in self._subspaces:
            for subspace in pair:
                if subspace.L is not None:
                    if L is None:
                        L = subspace.L
                    elif L != subspace.L:
                        raise ValueError('All subspaces of an operator must '
                                         'have the same spin chain length L.')
        if L is not None:
            self.L = L

    @L.setter
    def L(self, value):
        value = validate.L(value)
        if value < self.max_spin_idx + 1:
            raise ValueError('Cannot set L smaller than one plus the '
                             'largest spin index on which the operator has '
                             f'support (max_spin_idx = {self.max_spin_idx})')
        for left, right in self._subspaces:
            left.L = value
            right.L = value

    def establish_L(self):
        """Set L to the minimal possible value if it isn't set yet."""
        self.L = self.get_length()

    def get_length(self):
        """L if set, else one plus the largest supported spin index."""
        if self.L is None:
            return self.max_spin_idx + 1
        return self.L

    @property
    def dim(self):
        """(left, right) matrix dimensions."""
        self.establish_L()
        return (self.left_subspace.get_dimension(),
                self.right_subspace.get_dimension())

    @property
    def nnz(self):
        """Nonzero elements per row (= number of distinct masks)."""
        return msc_tools.nnz_per_row(self.msc)

    @property
    def nterms(self):
        """Number of terms in the reduced Pauli-string sum."""
        self.reduce_msc()
        return len(self.msc)

    @property
    def msc_size(self):
        """(deprecated) use nterms"""
        warnings.warn('Operator.msc_size is deprecated, use Operator.nterms '
                      'instead', DeprecationWarning, stacklevel=2)
        return self.nterms

    @property
    def density(self):
        """nnz per row / row length (an upper bound on subspaces)."""
        return self.nnz / self.dim[1]

    # -- flags -------------------------------------------------------------------

    @property
    def shell(self):
        """API parity flag: all operators are matrix-free (shell)."""
        return self._shell

    @shell.setter
    def shell(self, value):
        value = validate.shell(value)
        if value != self._shell:
            self.destroy_mat()
        self._shell = value

    @property
    def precompute_diagonal(self):
        """API parity flag (the diagonal term group is always fused)."""
        return self._precompute_diagonal

    @precompute_diagonal.setter
    def precompute_diagonal(self, value):
        self._precompute_diagonal = bool(value)

    @property
    def allow_projection(self):
        """Whether to allow subspace pairs for which applying the operator
        implements a projection (the subspace isn't conserved)."""
        return self._allow_projection

    @allow_projection.setter
    def allow_projection(self, value):
        self._allow_projection = bool(value)

    # -- subspace registry ----------------------------------------------------------

    @property
    def left_subspace(self):
        return self.get_subspace_list()[-1][0]

    @property
    def right_subspace(self):
        return self.get_subspace_list()[-1][1]

    @property
    def subspace(self):
        """The default subspace (most recently added)."""
        if self.left_subspace != self.right_subspace:
            raise ValueError('Left and right subspaces are different for '
                             'this operator. Use Operator.left_subspace and '
                             'Operator.right_subspace to access them '
                             'individually.')
        return self.left_subspace

    @subspace.setter
    def subspace(self, value):
        self.add_subspace(value, value)

    def add_subspace(self, left, right=None):
        """Register a (left, right) subspace pair the operator can act on."""
        if right is None:
            right = left
        elif (left is not right and
              (not left.product_state_basis or not right.product_state_basis)):
            raise ValueError('subspaces must be the same object if either is '
                             'not a product state basis')

        left = validate.subspace(left)
        right = validate.subspace(right)

        if self.L is None:
            if left.L is not None:
                self.L = left.L
            elif right.L is not None:
                self.L = right.L

        if self.L is not None:
            for subspace in (left, right):
                if subspace.L is None:
                    subspace.L = self.L
                elif subspace.L != self.L:
                    raise ValueError('operator and subspaces must all have '
                                     'same spin chain length')

        if not self.has_subspace(left, right):
            self.get_subspace_list().append((left, right))

    def get_subspace_list(self):
        self._update_L_from_subspaces()
        return self._subspaces

    def has_subspace(self, left, right=None):
        if right is None:
            right = left
        for (ls, rs) in self.get_subspace_list():
            if left.identical(ls) and right.identical(rs):
                return True
        return False

    # -- conservation check ------------------------------------------------------------

    def conserves(self, left, right=None):
        """Whether the image of the right subspace under the operator lies
        inside the left subspace. Full and Parity pairs are decided
        symbolically; other pairs by a device reduction over the same term
        sweep as the matvec (reference analog: the distributed shell
        CheckConserves, bpetsc_template_2.c:990-1056)."""
        msc, base_left, base_right, early = self._conserves_prep(left, right)
        if early is not None:
            return early
        return self._device_conserves(msc, base_left, base_right)

    @staticmethod
    def _device_conserves(msc, base_left, base_right):
        from .ops.reductions import build_check_conserves
        config._initialize()
        check = build_check_conserves(msc, base_left, base_right,
                                      config.real_dtype, config.device)
        return bool(check())

    def _conserves_prep(self, left, right):
        """Shared setup for the device and host conservation checks.
        Returns (msc, base_left, base_right, early_result): early_result is
        the symbolic decision, or None when the device check must run."""
        self.establish_L()

        if right is None:
            right = left

        if not left.product_state_basis or not right.product_state_basis:
            if left is not right:
                raise ValueError('if left or right subspace is not a product '
                                 'state basis, they must be the same object')

        left.L = self.L
        right.L = self.L

        self.reduce_msc()
        if not left.product_state_basis:
            msc, conserved = left.reduce_msc(self.msc, check_conserves=True)
            if not conserved:
                return None, None, None, False
        else:
            msc = self.msc

        base_left, base_right = _base(left), _base(right)

        # Full left always contains every image state
        if isinstance(base_left, Full):
            return msc, base_left, base_right, True

        # Parity pairs are decidable symbolically: a mask's image flips the
        # number parity by parity(mask), so every (non-cancelling) mask must
        # map the right sector exactly onto the left one
        if isinstance(base_left, Parity) and isinstance(base_right, Parity):
            masks = np.unique(msc_tools.combine_terms(msc)['masks'])
            want = base_left.space ^ base_right.space
            return msc, base_left, base_right, bool(
                np.all(parity(masks) == want))

        return msc, base_left, base_right, None

    def _conserves_host(self, left, right=None):
        """Host numpy version of :meth:`conserves` — the small-dimension
        oracle for the device reduction."""
        msc, base_left, base_right, early = self._conserves_prep(left, right)
        if early is not None:
            return early

        masks, offsets = msc_tools.mask_groups(msc)
        signs = msc['signs']
        coeffs = msc['coeffs']
        dim = base_right.get_dimension()

        # per-column coefficient totals that cancel analytically can leave
        # float roundoff (e.g. in symbolically-squared operators); treat
        # them as zero relative to each group's coefficient scale
        group_scale = np.add.reduceat(np.abs(coeffs), offsets[:-1])
        tol = 1e-12 * group_scale

        block = 1 << 14
        for start in range(0, dim, block):
            stop = min(start + block, dim)
            cols = np.arange(start, stop, dtype=np.int64)
            states = base_right.idx_to_state(cols)
            sgn = 1 - 2 * parity(states[:, None] & signs[None, :])
            totals = np.add.reduceat(sgn * coeffs[None, :], offsets[:-1],
                                     axis=1)
            for g, m in enumerate(masks):
                active = np.abs(totals[:, g]) > tol[g]
                if not np.any(active):
                    continue
                images = states[active] ^ m
                if np.any(base_left.state_to_idx(images) == -1):
                    return False
        return True

    # -- text representations ------------------------------------------------------------

    def __str__(self):
        return self._text.plain

    def __repr__(self):
        return self._text.code

    def _repr_latex_(self):
        return '$' + self._text.display_tex() + '$'

    def table(self):
        """ASCII table of the operator's terms."""
        return msc_tools.table(self.msc, self.get_length())

    # -- serialization ------------------------------------------------------------

    def serialize(self):
        """Serialize just the MSC term list to bytes (byte-compatible with
        the reference format)."""
        return msc_tools.serialize(self.msc)

    @classmethod
    def from_bytes(cls, data):
        return Operator(
            msc=msc_tools.deserialize(data),
            text=_text_atom('[operator from bytes]',
                            r'\left[\text{operator from bytes}\right]',
                            '<Operator from bytes>'))

    def save(self, filename):
        """Write the serialized terms to ``filename``: rank 0 writes, once
        every rank is done with what came before (an earlier save's file,
        which this one may overwrite, still being read), and every rank
        waits until it has (a collective: every rank calls it; the file is
        read back where it lies, a shared filesystem across hosts)."""
        multihost.barrier('operator_save_begin')
        if multihost.rank() == 0:
            with open(filename, 'wb') as f:
                f.write(self.serialize())
        # other ranks must not read the file before it is written
        multihost.barrier('operator_save')

    @classmethod
    def load(cls, filename):
        with open(filename, 'rb') as f:
            return cls.from_bytes(f.read())

    # -- kernel (matrix) management ------------------------------------------------------------

    def get_mat(self, subspaces=None):
        """Get (building if needed) the compiled matvec kernel for a
        subspace pair — the analog of the reference's PETSc matrix."""
        if subspaces is None:
            subspaces = (self.left_subspace, self.right_subspace)
        if subspaces not in self._kernels:
            self.build_mat(subspaces)
        return self._kernels[subspaces]

    def build_mat(self, subspaces=None):
        """Build the matvec kernel for a subspace pair and cache it."""
        from .ops.apply import OperatorKernel

        if subspaces is None:
            subspaces = (self.left_subspace, self.right_subspace)

        if not self.has_subspace(*subspaces):
            raise ValueError('Attempted to build matrix for a subspace that '
                             'has not been added to the operator.')

        config._initialize()

        with tracing.span('build.msc'):
            self.reduce_msc()

            if not subspaces[0].product_state_basis:
                msc, xp_ok = subspaces[0].reduce_msc(self.msc,
                                                     check_conserves=True)
                if not self.allow_projection and not xp_ok:
                    raise ValueError(self._projection_message())
            else:
                msc = self.msc

            self._check_consistent_msc(msc)

            if not msc_tools.is_hermitian(msc):
                raise ValueError('Building non-Hermitian matrices currently '
                                 'not supported.')

        kernel = OperatorKernel(msc, subspaces[0], subspaces[1])

        with tracing.span('build.conserves'):
            conserves = (self.allow_projection
                         or self._conserves_for_build(subspaces, kernel))
        if not conserves:
            raise ValueError(self._projection_message())

        self._kernels[subspaces] = kernel

    def _conserves_for_build(self, subspaces, kernel):
        """The conservation gate of build_mat, in increasing order of cost:
        symbolic shortcuts (Full/Parity), the sector engine's build
        byproduct, then the standalone device reduction."""
        msc, base_left, base_right, early = self._conserves_prep(*subspaces)
        if early is not None:
            return early
        # the build byproduct is a row-wise (left-subspace) test, equivalent
        # to the reference's column-wise CheckConserves only for square
        # pairs; rectangular pairs must take the standalone reduction
        if subspaces[0] == subspaces[1] and kernel.conserves_hint is not None:
            return kernel.conserves_hint
        return self._device_conserves(msc, base_left, base_right)

    @staticmethod
    def _check_consistent_msc(msc):
        """Check that the operator is the same on every rank: a CRC32 of its
        terms, all-gathered (the JAX package's check across host
        processes; the reference's cross-rank CRC, operators.py:633-651)."""
        if multihost.world_size() == 1:
            return
        checksum = np.array([crc32(msc.tobytes())], dtype=np.uint32)
        all_sums = multihost.allgather_host_values(checksum)
        if not np.all(all_sums == all_sums.flat[0]):
            raise RuntimeError(
                'operator is inconsistent across ranks. Was it constructed '
                'using non-deterministic code, such as random numbers with '
                'inconsistent seeds?')

    @staticmethod
    def _projection_message():
        return ("Constructing the operator's matrix on this subspace "
                'yields a projection (e.g. subspace is not conserved by '
                'the operator). If this behavior is desired, set the '
                'Operator.allow_projection parameter to True.')

    def destroy_mat(self, subspaces=None):
        """Drop cached kernels (freeing their device tables)."""
        if subspaces is not None:
            self._kernels.pop(subspaces, None)
        else:
            self._kernels.clear()

    def estimate_memory(self, mpi_size=None, ncv=None):
        """Estimated device memory (GB) used when applying the operator,
        summed across ranks (cf. the reference's shell-mode formula,
        operators.py:692-758).

        Counts the MSC terms and the state tables of Explicit/Auto
        subspaces (every rank), and the tables of the engine that the
        dispatch would build for the default (left, right) pair
        (:meth:`_engine_table_bytes`). With ``ncv`` given, also the Krylov
        workspace: the (ncv+1, 2, dim) basis and two work vectors
        (``solvers.krylov.workspace_bytes``)."""
        if mpi_size is None:
            mpi_size = multihost.world_size()

        from .ops.index_maps import device_map
        usage = self.msc.nbytes
        explicit = {id(sp): sp for sp in (_base(self.left_subspace),
                                          _base(self.right_subspace))
                    if isinstance(sp, Explicit)}
        usage += sum(device_map(sp).table_bytes() for sp in explicit.values())
        usage *= mpi_size

        usage += self._engine_table_bytes(mpi_size)

        if ncv is not None:
            from .solvers.krylov import workspace_bytes
            usage += workspace_bytes(self.right_subspace.get_dimension(), ncv,
                                     config.real_dtype.itemsize)
        return usage / 1e9

    def _engine_table_bytes(self, mpi_size):
        """Device bytes of the tables that the dispatch of
        :class:`.ops.apply.OperatorKernel` would build for the default
        (left, right) pair in ``config.real_dtype``: the XOR kernel's
        diagonal stream (one plane, two with an imaginary diagonal), the
        XOR-dense channels, the sector engine's matrices (every rank), or
        the ELL tables; nothing for the on-the-fly sweep. The packed ELL
        tables' size depends on the data: before the pair's kernel has
        built them on ``config.device`` this counts the most they can take
        (:func:`.ops.ell.packed_bound`: an index and one coefficient, two
        with imaginary coefficients, per group and row over whole 32-row
        slices, and the slice pointers), and after that the bytes they
        hold (:meth:`.ops.ell.EllTables.nbytes`).

        Over ``mpi_size`` > 1 ranks, a pair off the XOR route counts the
        general route's tables (:meth:`_sharded_table_bytes`). On it, the
        diagonal stream counts each rank's rows, and the XOR-dense engine
        every rank's tables at the split capped to a rank's block (each
        rank holds the channel matrices) and its receive buffers, one
        block per nonzero high mask."""
        from .ops import ell as ell_mod
        from .ops.apply import _Plan, _xor_engine, sharded_route
        from .ops.sector_apply import (TABLE_BUDGET, sector_supported,
                                       table_bytes_estimate)
        from .ops.xor_apply import hi_list
        from .parallel import mesh

        left, right = self.left_subspace, self.right_subspace
        self.establish_L()
        plan = _Plan(self._msc_on(left), left, right)
        if not plan.groups:
            return 0
        cb = config.real_dtype.itemsize
        if mpi_size > 1:
            route = sharded_route(plan, left, right, mpi_size)
            if route != 'xor':
                return self._sharded_table_bytes(plan, route, mpi_size)
        if plan.xor_mode:
            # over ranks only on the XOR route's layout (above)
            engine, made = _xor_engine(plan, left, right, mpi_size)
            if engine == 'xor':
                if not made.use_diag:
                    return 0
                return plan.dim_left * cb * (2 if made.has_imag_diag
                                             else 1)
            if engine == 'xor_dense':
                n = mesh.local_dim(plan.dim_right, mpi_size)
                his = hi_list([g[1] for g in plan.groups],
                              n.bit_length() - 1)
                recv = (len(his) - (0 in his)) * 2 * n * cb
                return (made[3] + recv) * mpi_size
        elif config.use_sector and sector_supported(plan, left, right):
            est = table_bytes_estimate(plan, left, right)
            if est <= TABLE_BUDGET:
                return est * mpi_size  # replicated on every rank
        if config.use_ell \
                and ell_mod.table_bytes(plan) <= ell_mod.ell_budget():
            kernel = self._kernels.get((left, right))
            tables = (kernel.ell_tables if kernel is not None
                      and kernel.ell_tables is not None
                      else ell_mod.EllTables(plan))
            return tables.nbytes(config.real_dtype, config.device)
        return 0

    def _sharded_table_bytes(self, plan, route, mpi_size):
        """The table bytes of the general ``route`` over ``mpi_size``
        ranks (:func:`.ops.apply.sharded_route`), summed over them, with
        no collective. Once the default pair's kernel is built over a
        transport of that many ranks, the bytes its ranks hold (the alpha
        ring's counted from its plan, the ELL tables' gathered by their
        build); before that, for the alpha ring the sector engine's
        estimate over the ranks (:func:`.ops.sector_apply.
        table_bytes_estimate`), and for the ELL route the most each rank's
        packed tables can take (:func:`.ops.ell.packed_bound`); nothing
        for the sweeps."""
        from .ops import ell as ell_mod
        from .ops.sector_apply import table_bytes_estimate
        from .parallel import mesh
        left, right = self.left_subspace, self.right_subspace
        kernel = self._kernels.get((left, right))
        if kernel is not None and kernel.sharded is not None \
                and kernel.transport.world == mpi_size:
            return kernel.sharded.total_bytes(config.real_dtype,
                                              config.device)
        if route == 'sector_ring':
            return table_bytes_estimate(plan, left, right, mpi_size)
        if route == 'ell':
            n = mesh.local_dim(plan.dim_left, mpi_size)
            return sum(ell_mod.packed_bound(plan, config.real_dtype,
                                            (r * n, (r + 1) * n))
                       for r in range(mpi_size))
        return 0

    def spy(self, subspaces=None, max_size=1024):
        """Plot the nonzero structure with matplotlib (imported here: the
        port does not need it anywhere else)."""
        if any(d > max_size for d in self.dim):
            raise ValueError('Matrix too big to spy. Either build a smaller '
                             'operator, or adjust the maximum spy size with '
                             'the argument "max_size"')
        from matplotlib import pyplot as plt
        plt.figure()
        dense = np.array((self.to_numpy(subspaces=subspaces) != 0).toarray(),
                         dtype=float)
        plt.imshow(np.log(dense + 1e-9), cmap='Greys')
        plt.show()

    # -- applying ------------------------------------------------------------

    def create_states(self):
        """A (bra, ket) pair compatible with this operator."""
        self.establish_L()
        return (State(subspace=self.left_subspace),
                State(subspace=self.right_subspace))

    def dot(self, x, result=None):
        """y = A @ x for a State x."""
        x.assert_initialized()
        self.establish_L()

        right_subspace = x.subspace
        right_match = [(l, r) for l, r in self.get_subspace_list()
                       if r.identical(right_subspace)]
        if not right_match:
            raise ValueError('No operator subspace found that matches input '
                             'vector subspace. Try adding the subspace with '
                             'the Operator.add_subspace method.')

        if result is None:
            if len(right_match) != 1:
                raise ValueError('Ambiguous subspace for result vector. Pass '
                                 'a state with the desired subspace as the '
                                 '"result" option to Operator.dot.')
            left_subspace = right_match[0][0]
            result = State(L=left_subspace.L, subspace=left_subspace)
        else:
            left_subspace = result.subspace

        if (left_subspace, right_subspace) not in right_match:
            raise ValueError('Subspaces of matrix and result vector do not '
                             'match.')

        kernel = self.get_mat(subspaces=(left_subspace, right_subspace))
        result.data = kernel.apply(x.data)
        result.set_initialized()
        return result

    def expectation(self, state, tmp_state=None):
        """<state| A |state> (real part; operators are Hermitian)."""
        if tmp_state is None:
            tmp_state = self.dot(state)
        else:
            self.dot(state, result=tmp_state)
        return state.dot(tmp_state).real

    def infinity_norm(self, subspaces=None):
        """The matrix infinity norm max_row sum_col |A[row, col]|.

        Computed matrix-free on the device: a pass over rows evaluating
        sum_m |f_m(bra)| (each mask contributes one element per row),
        reduced with max — the same term sweep as the matvec kernel
        (reference analog: the distributed shell MatNorm,
        bpetsc_template_2.c:906-981). The result is cached per subspace
        pair, like the reference caches it in the shell context.
        """
        if subspaces is None:
            subspaces = (self.left_subspace, self.right_subspace)
        if subspaces in self._norm_cache:
            return self._norm_cache[subspaces]
        self.establish_L()
        msc = self._msc_on(subspaces[0])

        from .ops.reductions import build_infinity_norm
        norm_fn = build_infinity_norm(msc, subspaces[0], subspaces[1],
                                      config.real_dtype, config.device)
        result = norm_fn()
        self._norm_cache[subspaces] = result
        return result

    def _infinity_norm_host(self, subspaces=None):
        """Host numpy version of :meth:`infinity_norm` — the
        small-dimension oracle for the device reduction."""
        if subspaces is None:
            subspaces = (self.left_subspace, self.right_subspace)
        self.establish_L()
        msc = self._msc_on(subspaces[0])

        masks, offsets = msc_tools.mask_groups(msc)
        signs = msc['signs']
        coeffs = msc['coeffs']

        left, right = subspaces
        base_left, base_right = _base(left), _base(right)
        dim = left.get_dimension()

        best = 0.0
        block = 1 << 16
        for start in range(0, dim, block):
            stop = min(start + block, dim)
            rows = np.arange(start, stop, dtype=np.int64)
            kets = base_left.idx_to_state(rows)
            row_sum = np.zeros(stop - start)
            for g, m in enumerate(masks):
                sl = slice(offsets[g], offsets[g + 1])
                bra = kets ^ m
                sgn = 1 - 2 * parity(bra[:, None] & signs[None, sl])
                elem = np.abs(sgn @ coeffs[sl])
                # entries whose column falls outside the right subspace are
                # projected away (reference: the shell MatNorm only sums
                # in-subspace columns, bpetsc_template_2.c:906-981)
                valid = base_right.state_to_idx(bra) >= 0
                row_sum += np.where(valid, elem, 0.0)
            best = max(best, float(row_sum.max(initial=0.0)))
        return best

    # -- MSC management ------------------------------------------------------------

    @property
    def msc(self):
        """The (mask, sign, coefficient) term list."""
        return self._msc

    @msc.setter
    def msc(self, value):
        value = validate.msc(value)
        self._max_spin_idx = None
        self.is_reduced = False
        self._norm_cache.clear()
        self._msc = value

    def reduce_msc(self):
        """Combine and sort the MSC terms."""
        if not self.is_reduced:
            self.msc = msc_tools.combine_terms(self.msc)
            self.is_reduced = True

    def _msc_on(self, subspace):
        """The reduced MSC as it acts on ``subspace``: rewritten through
        ``XParity.reduce_msc`` where the subspace is an XParity."""
        self.reduce_msc()
        if subspace.product_state_basis:
            return self.msc
        return subspace.reduce_msc(self.msc)

    @property
    def is_reduced(self):
        return self._is_reduced

    @is_reduced.setter
    def is_reduced(self, value):
        self._is_reduced = value

    def get_shifted_msc(self, shift, wrap_idx=None):
        """The MSC term list translated along the chain by ``shift``."""
        return msc_tools.shift(self.msc, shift, wrap_idx)

    def truncate(self, tol=1e-12):
        """Drop terms with |coefficient| < tol."""
        self.msc = msc_tools.truncate(self.msc, tol=tol)

    # -- numpy interface ------------------------------------------------------------

    def to_numpy(self, subspaces=None, sparse=True):
        """The operator as a scipy sparse (or dense numpy) matrix — the
        debugging/oracle path."""
        self.establish_L()
        if subspaces is None:
            subspaces = (self.left_subspace, self.right_subspace)
        return msc_tools.msc_to_matrix(
            self._msc_on(subspaces[0]),
            (subspaces[0].get_dimension(), subspaces[1].get_dimension()),
            subspaces[0].idx_to_state,
            subspaces[1].state_to_idx,
            sparse)

    # -- algebra ------------------------------------------------------------

    def __add__(self, x):
        if not isinstance(x, Operator):
            if x == 0:
                return self.copy()
            x = x * identity()
        return self._op_add(x)

    def __radd__(self, x):
        if not isinstance(x, Operator):
            if x == 0:
                return self.copy()
            x = x * identity()
        return x + self

    def __sub__(self, x):
        return self + -x

    def __rsub__(self, x):
        return x + -self

    def __neg__(self):
        return -1 * self

    def __mul__(self, x):
        if isinstance(x, Operator):
            return self._op_mul(x)
        if isinstance(x, State):
            return self.dot(x)
        return self._num_mul(x)

    def __rmul__(self, x):
        if isinstance(x, State):
            return TypeError('Left vector-matrix multiplication not '
                             'currently supported.')
        return self._num_mul(x)

    def __truediv__(self, x):
        if isinstance(x, Operator):
            raise TypeError('Dividing by Operators not supported.')
        return (1 / x) * self

    def __eq__(self, x):
        if isinstance(x, Operator):
            self.reduce_msc()
            x.reduce_msc()
            return np.array_equal(self.msc, x.msc)
        raise TypeError(f'Equality not supported for types '
                        f'{type(self)} and {type(x)}')

    def _check_compatible(self, other):
        if self.shell != other.shell:
            raise ValueError("cannot combine operators whose 'shell' "
                             'settings differ (set '
                             'dynamite_tpu_torch.config.shell for a global '
                             'default)')
        if self.allow_projection != other.allow_projection:
            raise ValueError("cannot combine operators whose "
                             "'allow_projection' settings differ")
        if self.L != other.L:
            raise ValueError(f'cannot combine operators with different '
                             f'chain lengths ({self.L} vs {other.L}; set '
                             'dynamite_tpu_torch.config.L for a global '
                             'default)')

        subsp_1 = self.get_subspace_list()
        subsp_2 = other.get_subspace_list()
        if len(subsp_1) != len(subsp_2):
            raise ValueError(_SUBSPACE_MISMATCH_MSG)
        for (l1, r1) in subsp_1:
            if not any(l1.identical(l2) and r1.identical(r2)
                       for (l2, r2) in subsp_2):
                raise ValueError(_SUBSPACE_MISMATCH_MSG)

    def _op_add(self, o):
        self._check_compatible(o)
        rtn = self.copy()
        rtn.msc = msc_tools.msc_sum([self.msc, o.msc])
        rtn._text = _text_sum([self._text, o._text])
        return rtn

    def _op_mul(self, o):
        self._check_compatible(o)
        rtn = self.copy()
        rtn.msc = msc_tools.msc_product([self.msc, o.msc])
        rtn._text = _text_product([self._text, o._text])
        return rtn

    def scale(self, x):
        """Scale the operator in place by a number."""
        if x == 1:
            return
        try:
            self.msc['coeffs'] *= x
        except (ValueError, TypeError):
            raise TypeError(f'Cannot scale operator by type {type(x)}')
        # compiled kernels and cached norms bake in the coefficients
        self.destroy_mat()
        self._norm_cache.clear()
        coeff_str = msc_tools.format_coeff(x, parens=True)
        self._text = _text_scaled(coeff_str, self._text)

    def _num_mul(self, x):
        rtn = self.copy()
        rtn.scale(x)
        return rtn


_SUBSPACE_MISMATCH_MSG = (
    'cannot combine operators whose registered subspace lists differ (set '
    'dynamite_tpu_torch.config.subspace for a global default)')


# -- factory functions ------------------------------------------------------------

def sigmax(i=0):
    r"""The Pauli :math:`\sigma_x` operator on site i."""
    i = validate.spin_index(i)
    return Operator(
        msc=[(1 << i, 0, 1)],
        text=_text_atom(f'σx[{i}]', r'\sigma^x_{IDX%d}' % i, f'sigmax({i})'))


def sigmay(i=0):
    r"""The Pauli :math:`\sigma_y` operator on site i."""
    i = validate.spin_index(i)
    return Operator(
        msc=[(1 << i, 1 << i, 1j)],
        text=_text_atom(f'σy[{i}]', r'\sigma^y_{IDX%d}' % i, f'sigmay({i})'))


def sigmaz(i=0):
    r"""The Pauli :math:`\sigma_z` operator on site i."""
    i = validate.spin_index(i)
    return Operator(
        msc=[(0, 1 << i, 1)],
        text=_text_atom(f'σz[{i}]', r'\sigma^z_{IDX%d}' % i, f'sigmaz({i})'))


def sigma_plus(i=0):
    r""":math:`\sigma_+ = \sigma_x + i\sigma_y` on site i."""
    i = validate.spin_index(i)
    rtn = sigmax(i) + 1j * sigmay(i)
    rtn._text = _text_atom(f'σ+[{i}]', r'\sigma^+_{IDX%d}' % i,
                           f'sigma_plus({i})')
    return rtn


def sigma_minus(i=0):
    r""":math:`\sigma_- = \sigma_x - i\sigma_y` on site i."""
    i = validate.spin_index(i)
    rtn = sigmax(i) - 1j * sigmay(i)
    rtn._text = _text_atom(f'σ-[{i}]', r'\sigma^-_{IDX%d}' % i,
                           f'sigma_minus({i})')
    return rtn


def identity():
    """The identity operator."""
    return Operator(msc=[(0, 0, 1)], text=_text_atom('1', '𝟙', 'identity()'))


def zero():
    """The zero operator."""
    return Operator(msc=[], text=_text_atom('0', '0', 'zero()'))


def op_sum(terms, nshow=3):
    """The sum of an iterable of operators."""
    terms = list(terms)
    return Operator(
        msc=msc_tools.msc_sum(t.msc for t in terms),
        text=_text_sum((t._text for t in terms), shown=nshow))


def op_product(terms):
    """The product of an iterable of operators."""
    terms = list(terms)
    if not terms:
        return identity()
    return Operator(
        msc=msc_tools.msc_product(t.msc for t in terms),
        text=_text_product(t._text for t in terms))


def _index_extent(op, size, start, fn_name):
    """Resolve the chain extent for index_sum/index_product. Returns
    (site count for translated copies, the size= value for the repr —
    None when it was inherited from L)."""
    if size is None:
        if op.L is None:
            raise ValueError(
                f'{fn_name} needs to know how long the chain is: pass '
                f'size=, or set L on the operator or on '
                f'dynamite_tpu_torch.config')
        return validate.L(op.L), None
    return validate.L(size), size


def index_sum(op, size=None, start=0, boundary='open'):
    """Translate ``op`` along the chain and sum the copies.

    boundary='open' places copies while they fit; 'closed' wraps around
    (periodic).
    """
    size, size_arg = _index_extent(op, size, start, 'index_sum')

    if boundary == 'open':
        n_copies = size - op.max_spin_idx
        if n_copies < 1:
            raise ValueError(
                f'the operator touches spin {op.max_spin_idx}, so no '
                f'translated copy fits in an extent of {size} sites')
        wrap_at = None
    elif boundary == 'closed':
        if start != 0:
            raise ValueError("index_sum with boundary='closed' covers the "
                             'whole ring, so start must be 0')
        n_copies = size
        wrap_at = size
    else:
        raise ValueError(
            f"boundary may be 'open' or 'closed', not {boundary!r}")

    sites = range(start, start + n_copies)
    return Operator(
        msc=msc_tools.msc_sum(op.get_shifted_msc(i, wrap_at) for i in sites),
        text=_text_indexed('index_sum', op, sites, size_arg, start,
                           periodic=(boundary == 'closed')))


def index_product(op, size=None, start=0):
    """Translate ``op`` along the chain and multiply the copies."""
    if size == 0:
        return identity()
    size, size_arg = _index_extent(op, size, start, 'index_product')

    n_copies = size - op.max_spin_idx
    if n_copies < 1:
        raise ValueError(
            f'the operator touches spin {op.max_spin_idx}, so no '
            f'translated copy fits in an extent of {size} sites')
    sites = range(start, start + n_copies)
    return Operator(
        msc=msc_tools.msc_product(op.get_shifted_msc(i, wrap_idx=None)
                                  for i in sites),
        text=_text_indexed('index_product', op, sites, size_arg, start))


def load_from_file(filename):
    """DEPRECATED: use Operator.load"""
    warnings.warn('operators.load_from_file is deprecated; use '
                  'operators.Operator.load', DeprecationWarning, stacklevel=2)
    return Operator.load(filename)


def from_bytes(data):
    """DEPRECATED: use Operator.from_bytes"""
    warnings.warn('operators.from_bytes is deprecated; use '
                  'operators.Operator.from_bytes', DeprecationWarning,
                  stacklevel=2)
    return Operator.from_bytes(data)


@dataclass(frozen=True)
class OpText:
    """The printable forms of an operator expression.

    An :class:`OpText` is an immutable value; algebra on operators produces
    new ones through the ``_text_*`` combinators below rather than mutating
    in place. Fields:

    ``plain``
        what ``str(op)`` shows.
    ``tex``
        LaTeX source. Site subscripts are spelled ``{IDXn}`` so that
        :func:`index_sum` / :func:`index_product` can splice a summation
        variable into them; the marker is stripped at display time.
    ``code``
        what ``repr(op)`` shows — an evaluable expression when possible.
    ``group``
        delimiters (``'()'``, ``'[]'`` or ``''``) that must surround the
        expression when it is embedded inside a larger one. Atoms use ``''``.
    """

    plain: str = '[operator]'
    tex: str = r'\[\text{operator}\]'
    code: str = 'Operator()'
    group: str = ''

    def embed(self, form):
        """Render field ``form`` ('plain' | 'tex' | 'code') suitable for
        inlining inside a larger expression: grouped expressions get their
        delimiters (TeX gets sizing ``\\left``/``\\right``; code always uses
        parentheses), atoms pass through unchanged."""
        src = getattr(self, form)
        if not self.group:
            return src
        if form == 'tex':
            return rf'\left{self.group[0]}{src}\right{self.group[1]}'
        if form == 'code':
            return f'({src})'
        return f'{self.group[0]}{src}{self.group[1]}'

    def display_tex(self):
        """Final LaTeX for display: the {IDX...} markers become plain
        subscript braces."""
        return self.tex.replace('{IDX', '{')


def _text_atom(plain, tex, code):
    """Text for a leaf operator (a Pauli, identity, ...): never needs
    surrounding delimiters."""
    return OpText(plain, tex, code, '')


def _text_sum(texts, shown=None):
    """Text for a sum. ``shown`` truncates the plain/tex forms to the first
    few summands (with an ellipsis); ``code`` always lists every term so the
    repr stays evaluable."""
    texts = list(texts)
    plains = [t.plain for t in texts]
    texs = [t.tex for t in texts]
    if shown is not None and len(texts) > shown:
        plains = plains[:shown] + ['...']
        texs = texs[:shown] + [r'\cdots']
    return OpText(' + '.join(plains), ' + '.join(texs),
                  ' + '.join(t.code for t in texts), '()')


def _text_product(texts):
    """Text for a product: each factor rendered in embeddable form."""
    texts = list(texts)
    return OpText('*'.join(t.embed('plain') for t in texts),
                  ''.join(t.embed('tex') for t in texts),
                  '*'.join(t.embed('code') for t in texts), '')


def _text_scaled(coeff_str, text):
    """Text for ``coeff * expression``."""
    return OpText(f'{coeff_str}*{text.embed("plain")}',
                  coeff_str + text.embed('tex'),
                  f'{coeff_str}*{text.embed("code")}', '')


def _text_indexed(kind, op, sites, size_arg, start, periodic=False):
    """Text for index_sum / index_product over ``sites``.

    The summand's {IDXn} site markers are rewritten to {IDX<var>+n} so the
    displayed TeX shows e.g. sigma^x_{i+1} under the sum symbol.
    """
    lo, hi = sites[0], sites[-1]

    plain = f'{kind}({op}, sites {lo}-{hi}{", periodic" if periodic else ""})'

    code_args = [repr(op)]
    if size_arg is not None:
        code_args.append(f'size={size_arg}')
    if start != 0:
        code_args.append(f'start={start}')
    if periodic:
        code_args.append("boundary='closed'")
    code = f'{kind}({", ".join(code_args)})'

    inner = op._text.embed('tex')
    var = _fresh_tex_var(inner)
    # {IDX3} -> {IDXi+3}, except offset 0 which shows as just {IDXi}
    inner = inner.replace('{IDX', '{IDX' + var + '+')
    inner = inner.replace('{IDX' + var + '+0', '{IDX' + var)
    symbol = r'\sum' if kind == 'index_sum' else r'\prod'
    tex = rf'{symbol}\limits_{{{var}={lo}}}^{{{hi}}}{inner}'

    return OpText(plain, tex, code, '[]')


def _fresh_tex_var(tex_str):
    """A summation-variable letter not yet used by any {IDX...} marker in
    ``tex_str`` (so nested index_sums display distinct indices)."""
    used = {m.group(1) for m in re.finditer(r'\{IDX([a-z])', tex_str)}
    for letter in ascii_lowercase[ascii_lowercase.find('i'):] + 'abcdefgh':
        if letter not in used:
            return letter
    return 'i'
