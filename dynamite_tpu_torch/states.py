"""
State vectors on ``config.device``.

A State's data is a real tensor of shape (2, dim) — row 0 the real part,
row 1 the imaginary part — the JAX package's layout (see
:mod:`dynamite_tpu_torch.ops.cvec`). With a process group up
(:mod:`dynamite_tpu_torch.parallel.multihost`), each rank holds only its
(2, local_dim) rows (:mod:`dynamite_tpu_torch.parallel.mesh`), the rows past
the dimension being pad rows that every setter leaves at 0; functions that
take or give a whole vector as numpy gather or slice it.

Reference semantics: src/dynamite/states.py (PETSc.Vec wrapper).
"""

import os
import pickle
from os import urandom

import numpy as np
import torch

from . import config, subspaces
from .utils import validate
from .ops import cvec
from .parallel import mesh, multihost

# the subspace metadata of a saved state names its classes under the JAX
# package's module path, so a file saved by either package loads in the other
_SAVED_MODULE = 'dynamite_tpu.subspaces'
_LOADABLE = {'Full': subspaces.Full, 'Parity': subspaces.Parity,
             'SpinConserve': subspaces.SpinConserve,
             'Explicit': subspaces.Explicit, 'Auto': subspaces.Auto,
             'XParity': subspaces.XParity}
# numpy's own globals in a pickled array (SpinConserve's binomial table),
# under numpy 2's module path and numpy 1's
_NUMPY_GLOBALS = {('numpy.core.multiarray', '_reconstruct'),
                  ('numpy._core.multiarray', '_reconstruct'),
                  ('numpy', 'ndarray'), ('numpy', 'dtype'),
                  # protocol 2 spells bytes as a latin-1 string
                  ('_codecs', 'encode')}


class _SubspaceUnpickler(pickle.Unpickler):
    """Unpickles saved subspace metadata into this package's classes (and
    the numpy arrays they hold), and nothing else."""

    def find_class(self, module, name):
        if module in (_SAVED_MODULE, subspaces.__name__):
            if name in _LOADABLE:
                return _LOADABLE[name]
            raise pickle.UnpicklingError(
                f'unknown subspace class {module}.{name} in state metadata')
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f'unexpected global {module}.{name} in state metadata')


def _dump_subspace(subspace, f):
    # protocol 2 spells a class as the text line "c<module>\n<name>\n", so
    # the module path can be renamed without touching anything else (an
    # XParity names its own class and its parent's)
    data = pickle.dumps(subspace, protocol=2)
    ours = b'c' + subspaces.__name__.encode() + b'\n'
    if not data.count(ours):
        raise RuntimeError('unexpected pickle of the subspace metadata')
    f.write(data.replace(ours, b'c' + _SAVED_MODULE.encode() + b'\n'))


class UninitializedError(RuntimeError):
    pass


class State:
    """
    A quantum state vector.

    Parameters
    ----------
    state : int or str, optional
        Initial product state (integer bitstring or 'UDDU...'/'0110...'
        string), or 'random' / 'uniform'.

    subspace : Subspace, optional
        The subspace the state lives on (default: config.subspace or Full).

    L : int, optional
        Spin chain length (defaults to config.L / the subspace's L).

    seed : int, optional
        RNG seed when ``state='random'``.
    """

    def __init__(self, state=None, subspace=None, L=None, seed=None):
        if subspace is None:
            subspace = config.subspace if config.subspace is not None \
                else subspaces.Full()
        self._subspace = validate.subspace(subspace)

        if L is not None:
            self.L = L

        self._data = None
        self._initialized = False
        self.repr_binary = True

        if state is not None:
            if state == 'random':
                self.set_random(seed=seed)
            elif state == 'uniform':
                self.set_uniform()
            else:
                self.set_product(state)

    # -- basic properties ----------------------------------------------------

    @property
    def L(self):
        return self.subspace.L

    @L.setter
    def L(self, value):
        if self.L is not None and self.L != value:
            raise ValueError('L is already set to a different value '
                             '(possibly by subspace)')
        self.subspace.L = value

    @property
    def subspace(self):
        return self._subspace

    def __len__(self):
        return self.subspace.get_dimension()

    @property
    def initialized(self):
        return self._initialized

    def set_initialized(self):
        self._initialized = True

    def assert_initialized(self):
        if not self.initialized:
            raise UninitializedError('State vector data has not been set yet')

    @property
    def storage_dim(self):
        """Length of this rank's state axis, pad rows included (the
        dimension on one process)."""
        return mesh.local_dim(len(self))

    @property
    def data(self):
        """The (2, storage_dim) re/im tensor on ``config.device``. Lazily
        allocated as zeros."""
        if self._data is None:
            if self.L is None:
                raise ValueError('must set L first')
            self._data = self._zeros()
        return self._data

    def _zeros(self):
        return torch.zeros((2, self.storage_dim), dtype=config.real_dtype,
                           device=config.device)

    @data.setter
    def data(self, value):
        self._data = value

    @property
    def vec(self):
        """Alias of :attr:`data` for rough API parity with the reference's
        ``State.vec``."""
        return self.data

    # -- initialization -------------------------------------------------------

    @classmethod
    def str_to_state(cls, s, L):
        """Convert 'UDU...'/'010...' (leftmost char = spin 0) or an integer
        to the product-state integer."""
        if isinstance(s, str):
            if len(s) != L:
                raise ValueError(f'got a {len(s)}-character state string for '
                                 f'a chain of L={L} spins')
            bad = set(s) - set('UD01')
            if bad:
                raise ValueError(f'state string may contain only U/D/0/1; '
                                 f'found {sorted(bad)}')
            state = 0
            for i, c in enumerate(s):
                if c in ('D', '1'):
                    state |= 1 << i
        else:
            state = int(s)
            if state >> L != 0:
                raise ValueError(f'integer {state} (0b{state:b}) needs more '
                                 f'than L={L} bits, so it is not a product '
                                 'state of this chain')
        return state

    def set_product(self, s):
        """Set to the product state ``s`` (integer or string; see
        :meth:`str_to_state`)."""
        if self.L is None and isinstance(s, str):
            self.L = len(s)

        idx = int(self.subspace.state_to_idx(self.str_to_state(s, self.L)))
        if idx == -1:
            raise ValueError('Provided initial state not in requested '
                             'subspace.')

        # only the rank that owns row idx writes it
        data = self._zeros()
        local = idx - mesh.row0(len(self))
        if 0 <= local < self.storage_dim:
            data[0, local] = 1
        self._data = data
        self.set_initialized()

        self.repr_binary = isinstance(s, str) and any(c in '01' for c in s)

    def set_uniform(self):
        """Uniform superposition over the subspace's basis states."""
        data = self._zeros()
        data[0, :mesh.valid_rows(len(self))] = 1 / np.sqrt(len(self))
        self._data = data
        self.set_initialized()

    def set_random(self, seed=None, normalize=True):
        """Normalized complex Gaussian random state, drawn on the device
        from a ``torch.Generator`` seeded with ``seed`` (a fresh random seed
        from rank 0 when None). Each rank draws its rows from a generator
        seeded with (seed, rank), so the state depends on the world size,
        as the JAX package's depends on its mesh. The same seed and world
        size give the same state on the same device type; it does not
        reproduce the JAX package's random stream. Pad rows are 0 whatever
        the generator draws there."""
        if seed is None:
            seed = int(multihost.broadcast_from_host0(np.asarray(
                [int.from_bytes(urandom(4), 'big', signed=False)],
                dtype=np.int64))[0])
        device = config.device
        gen = torch.Generator(device=device)
        gen.manual_seed(multihost.rank_seed(seed))
        data = torch.randn((2, self.storage_dim), generator=gen,
                           dtype=config.real_dtype, device=device)
        mesh.zero_pads_(data, len(self))
        if normalize:
            data = cvec.scale_real(data, 1.0 / float(cvec.norm(data)))
        self._data = data
        self.set_initialized()

    def set_all_by_function(self, val_fn, vectorize=False):
        """Set each element to ``val_fn(state_int)`` evaluated along the
        subspace's basis (this rank's rows of it)."""
        first = mesh.row0(len(self))
        n = mesh.valid_rows(len(self))
        vec = np.zeros(self.storage_dim, dtype=np.complex128)
        block = 65536
        for start in range(0, n, block):
            stop = min(n, start + block)
            states = self.subspace.idx_to_state(
                np.arange(first + start, first + stop))
            if vectorize:
                vec[start:stop] = val_fn(states)
            else:
                for i, st in zip(range(start, stop), states):
                    vec[i] = val_fn(int(st))
        self._set_local(torch.from_numpy(np.stack([vec.real, vec.imag])))

    def set_all_numpy(self, vec):
        """Set the full vector from a host complex array (each rank takes
        its rows)."""
        vec = np.asarray(vec)
        if vec.shape != (len(self),):
            raise ValueError('array shape does not match subspace dimension')
        self.set_planes(np.stack([vec.real, vec.imag]))

    def set_planes(self, planes):
        """Set the vector from a (2, dim) real array or tensor of re/im
        planes — the JAX package's ``State.data`` layout, so a state carries
        across as ``set_planes(np.asarray(ref_state.data))``. Each rank
        takes its rows."""
        if not isinstance(planes, torch.Tensor):
            planes = torch.from_numpy(np.array(planes))
        if planes.shape != (2, len(self)):
            raise ValueError(f'expected a (2, {len(self)}) array of re/im '
                             f'planes, got {tuple(planes.shape)}')
        self._set_local(mesh.local_rows(planes, len(self)))

    def _set_local(self, planes):
        self._data = planes.to(device=config.device, dtype=config.real_dtype,
                               copy=True).contiguous()
        self.set_initialized()

    # -- conversions -----------------------------------------------------------

    def to_numpy(self, to_all=True):
        """Return the whole state as a host complex128 numpy array. With a
        process group up the ranks' rows are all-gathered, or with
        ``to_all=False`` gathered to rank 0 only, and the other ranks get
        None (a collective: every rank calls it)."""
        self.assert_initialized()
        data = multihost.gather_rows(self.data, to_all, dim=len(self))
        if data is None:
            return None
        arr = data.detach().to('cpu', torch.float64).numpy()
        return arr[0] + 1j * arr[1]

    # -- measurement/projection -------------------------------------------------

    def project(self, index, value):
        """Projective measurement: zero all amplitudes where spin ``index``
        is not ``value``, then renormalize. In place."""
        self.assert_initialized()
        if index < 0 or index >= self.L:
            raise ValueError('spin index out of range')
        if value not in (0, 1):
            raise ValueError('value must be 0 or 1')

        first = mesh.row0(len(self))
        states = self.subspace.idx_to_state(np.arange(
            first, first + mesh.valid_rows(len(self)), dtype=np.int64))
        keep = np.zeros(self.storage_dim, dtype=bool)
        keep[:len(states)] = ((states >> index) & 1) == value
        keep = torch.as_tensor(keep, device=self.data.device)
        data = cvec.mask_rows(self.data, keep)
        self.data = cvec.scale_real(data, 1.0 / float(cvec.norm(data)))

    def entanglement_entropy(self, keep):
        """Bipartite entanglement entropy, keeping the spins in ``keep``."""
        from .computations import entanglement_entropy
        return entanglement_entropy(self, keep)

    # -- vector algebra ----------------------------------------------------------

    def copy(self, result=None):
        if result is None:
            result = State(L=self.L, subspace=self.subspace.copy())
        if self.subspace != result.subspace:
            raise ValueError('subspace of state and result must match')
        if self.initialized:
            result.data = self.data.clone()
            result.set_initialized()
        elif result.initialized:
            raise UninitializedError('Cannot copy from uninitialized state '
                                     'to one that has been initialized')
        return result

    def dot(self, x):
        """Inner product <self|x> (conjugate-linear in self)."""
        self.assert_initialized()
        x.assert_initialized()
        if not self.subspace == x.subspace:
            raise ValueError('subspaces of the states do not match')
        re, im = cvec.vdot(self.data, x.data)
        return complex(float(re), float(im))

    def norm(self):
        self.assert_initialized()
        return float(cvec.norm(self.data))

    def normalize(self):
        self.assert_initialized()
        self.data = cvec.scale_real(self.data, 1.0 / self.norm())

    def scale(self, c):
        self.assert_initialized()
        c = complex(c)
        if c.imag == 0:
            self.data = cvec.scale_real(self.data, c.real)
        else:
            self.data = cvec.scale_complex(self.data, c.real, c.imag)

    def axpy(self, alpha, x):
        """self += alpha * x"""
        self.scale_and_sum(alpha, 1, x)

    def scale_and_sum(self, alpha, beta, x):
        """self = alpha*x + beta*self (axpby)."""
        self.assert_initialized()
        x.assert_initialized()
        if not self.subspace == x.subspace:
            raise ValueError('subspaces do not match')
        if self.data is x.data:
            raise ValueError('x and y cannot be the same State object')
        alpha, beta = complex(alpha), complex(beta)
        self.data = cvec.axpby(alpha.real, alpha.imag, x.data,
                               beta.real, beta.imag, self.data)

    def __imul__(self, c):
        self.scale(c)
        return self

    def __mul__(self, c):
        rtn = self.copy()
        rtn *= c
        return rtn

    def __rmul__(self, c):
        return self * c

    def __itruediv__(self, c):
        self.scale(1 / c)
        return self

    def __iadd__(self, x):
        if isinstance(x, State):
            self.axpy(1.0, x)
        else:
            self.assert_initialized()
            self.data = cvec.shift(self.data, complex(x).real,
                                   complex(x).imag)
        return self

    def __add__(self, x):
        rtn = self.copy()
        rtn += x
        return rtn

    def __radd__(self, x):
        return self + x

    def __isub__(self, x):
        if isinstance(x, State):
            self.axpy(-1.0, x)
        else:
            self += -x
        return self

    def __sub__(self, x):
        rtn = self.copy()
        rtn -= x
        return rtn

    def __rsub__(self, x):
        rtn = self.copy()
        rtn *= -1
        return rtn + x

    # -- save / load --------------------------------------------------------------

    # elements copied to the host per save/load step: bounds the host memory
    # of a checkpoint to ~2 * 8 bytes * this, independent of the state size
    SAVE_CHUNK = 1 << 24

    def save(self, fname):
        """Save as ``<fname>.vec`` (raw binary re/im float64 array) plus
        ``<fname>.metadata`` (pickled subspace) — the JAX package's format.
        Rank 0 writes both files: the vector is streamed to disk in
        SAVE_CHUNK-row pieces, each rank's valid rows sent to rank 0 one
        piece at a time (:func:`.parallel.multihost.rows_to_rank0`), so
        host memory stays bounded and pad rows never reach the file. The
        save ends with a barrier, so no rank reads the file before it is
        written (a collective: every rank calls it)."""
        self.assert_initialized()
        dim = len(self)
        f = None
        try:
            if multihost.rank() == 0:
                with open(fname + '.metadata', 'wb') as fm:
                    _dump_subspace(self.subspace, fm)
                f = open(fname + '.vec', 'wb')
                f.truncate(2 * dim * 8)
            for start, piece in multihost.rows_to_rank0(self.data, dim,
                                                        self.SAVE_CHUNK):
                if f is not None:
                    f.seek(start * 8)
                    f.write(piece[0].tobytes())
                    f.seek((dim + start) * 8)
                    f.write(piece[1].tobytes())
        finally:
            if f is not None:
                f.close()
        multihost.barrier('state_save')

    @classmethod
    def from_file(cls, fname):
        """Load a state saved with :meth:`save` by either package. Each
        rank checks the file's size itself (so a bad file raises on every
        rank, with no collective to hang in) and reads only its own rows
        from the memmap, in SAVE_CHUNK-row pieces; its pad rows are 0."""
        with open(fname + '.metadata', 'rb') as f:
            subspace = _SubspaceUnpickler(f).load()
        dim = subspace.get_dimension()
        if os.path.getsize(fname + '.vec') != 2 * dim * 8:
            raise RuntimeError('corrupt data encountered when loading state '
                               'from file')

        rtn = cls(subspace=subspace)
        data = rtn._zeros()
        first, valid = mesh.row0(dim), mesh.valid_rows(dim)
        mm = np.memmap(fname + '.vec', dtype=np.float64, mode='r',
                       shape=(2, dim))
        for start in range(0, valid, cls.SAVE_CHUNK):
            stop = min(start + cls.SAVE_CHUNK, valid)
            piece = np.array(mm[:, first + start:first + stop])
            data[:, start:stop] = torch.from_numpy(piece)
        del mm
        rtn.data = data
        rtn.set_initialized()
        return rtn

    # -- pretty printing ------------------------------------------------------------

    def _idx_to_str(self, idx):
        state = int(self.subspace.idx_to_state(int(idx)))
        alphabet = '01' if self.repr_binary else 'UD'
        return ''.join(alphabet[(state >> i) & 1] for i in range(self.L))

    def _nonzero_elements(self):
        vec = self.to_numpy()
        nz = np.flatnonzero(vec)
        if len(nz) > 10:
            take = list(nz[:3]) + [None] + [nz[-1]]
        else:
            take = list(nz)
        return [(i, vec[i] if i is not None else 0) for i in take]

    @staticmethod
    def _coeff_strs(nonzeros):
        if all(v in (0, 1) for _, v in nonzeros):
            return [''] * len(nonzeros)
        if all(complex(v).imag == 0 for _, v in nonzeros):
            fmt = lambda v: f'{v.real:0.3f}'
        else:
            fmt = lambda v: f'({v.real:0.3f}+{v.imag:0.3f}j)'
        return ['' if v == 0 else fmt(complex(v)) for _, v in nonzeros]

    def __str__(self):
        if not self.initialized:
            return repr(self)
        nonzeros = self._nonzero_elements()
        if not nonzeros:
            return repr(self)
        coeffs = self._coeff_strs(nonzeros)
        parts = []
        for (idx, v), c in zip(nonzeros, coeffs):
            if idx is None:
                parts.append('...')
            else:
                parts.append(c + '|' + self._idx_to_str(idx) + '>')
        return ' + '.join(parts)

    def __repr__(self):
        if not self.initialized:
            desc = 'with uninitialized contents'
        elif not self._nonzero_elements():
            desc = 'of norm zero'
        else:
            desc = str(self)
        return f'<State {desc} on subspace {self.subspace!r}>'
