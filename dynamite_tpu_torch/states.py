"""
State vectors on ``config.device``.

A State's data is a real tensor of shape (2, dim) — row 0 the real part,
row 1 the imaginary part — the JAX package's layout (see
:mod:`dynamite_tpu_torch.ops.cvec`). There is no sharding, so the storage
length is the subspace dimension.

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

# the subspace metadata of a saved state names its classes under the JAX
# package's module path, so a file saved by either package loads in the other
_SAVED_MODULE = 'dynamite_tpu.subspaces'
_LOADABLE = {'Full': subspaces.Full, 'Parity': subspaces.Parity}


class _SubspaceUnpickler(pickle.Unpickler):
    """Unpickles saved subspace metadata into this package's classes, and
    nothing else."""

    def find_class(self, module, name):
        if module in (_SAVED_MODULE, subspaces.__name__):
            if name in _LOADABLE:
                return _LOADABLE[name]
            raise NotImplementedError(
                f'loading a state on a {name} subspace is not ported yet '
                '(ROADMAP.md queue 1)')
        raise pickle.UnpicklingError(
            f'unexpected global {module}.{name} in state metadata')


def _dump_subspace(subspace, f):
    # protocol 2 spells a class as the text line "c<module>\n<name>\n", so
    # the module path can be renamed without touching anything else
    data = pickle.dumps(subspace, protocol=2)
    ours = b'c' + subspaces.__name__.encode() + b'\n'
    if data.count(ours) != 1:
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
        """Physical length of the state axis (no sharding: the dimension)."""
        return len(self)

    @property
    def data(self):
        """The (2, dim) re/im tensor on ``config.device``. Lazily allocated
        as zeros."""
        if self._data is None:
            if self.L is None:
                raise ValueError('must set L first')
            self._data = torch.zeros((2, len(self)), dtype=config.real_dtype,
                                     device=config.device)
        return self._data

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

        data = torch.zeros((2, len(self)), dtype=config.real_dtype,
                           device=config.device)
        data[0, idx] = 1
        self._data = data
        self.set_initialized()

        self.repr_binary = isinstance(s, str) and any(c in '01' for c in s)

    def set_uniform(self):
        """Uniform superposition over the subspace's basis states."""
        dim = len(self)
        data = torch.zeros((2, dim), dtype=config.real_dtype,
                           device=config.device)
        data[0] = 1 / np.sqrt(dim)
        self._data = data
        self.set_initialized()

    def set_random(self, seed=None, normalize=True):
        """Normalized complex Gaussian random state, drawn on the device
        from a ``torch.Generator`` seeded with ``seed`` (a fresh random seed
        when None). The same seed gives the same state on the same device
        type; it does not reproduce the JAX package's random stream."""
        if seed is None:
            seed = int.from_bytes(urandom(4), 'big', signed=False)
        device = config.device
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % 2**63)
        data = torch.randn((2, len(self)), generator=gen,
                           dtype=config.real_dtype, device=device)
        if normalize:
            data = cvec.scale_real(data, 1.0 / float(cvec.norm(data)))
        self._data = data
        self.set_initialized()

    def set_all_by_function(self, val_fn, vectorize=False):
        """Set each element to ``val_fn(state_int)`` evaluated along the
        subspace's basis."""
        dim = len(self)
        vec = np.empty(dim, dtype=np.complex128)
        block = 65536
        for start in range(0, dim, block):
            stop = min(dim, start + block)
            states = self.subspace.idx_to_state(np.arange(start, stop))
            if vectorize:
                vec[start:stop] = val_fn(states)
            else:
                for i, st in zip(range(start, stop), states):
                    vec[i] = val_fn(int(st))
        self.set_all_numpy(vec)

    def set_all_numpy(self, vec):
        """Set the full vector from a host complex array."""
        vec = np.asarray(vec)
        if vec.shape != (len(self),):
            raise ValueError('array shape does not match subspace dimension')
        self.set_planes(np.stack([vec.real, vec.imag]))

    def set_planes(self, planes):
        """Set the vector from a (2, dim) real array or tensor of re/im
        planes — the JAX package's ``State.data`` layout, so a state carries
        across as ``set_planes(np.asarray(ref_state.data))``."""
        if not isinstance(planes, torch.Tensor):
            planes = torch.from_numpy(np.array(planes))
        if planes.shape != (2, len(self)):
            raise ValueError(f'expected a (2, {len(self)}) array of re/im '
                             f'planes, got {tuple(planes.shape)}')
        self._data = planes.to(device=config.device, dtype=config.real_dtype,
                               copy=True).contiguous()
        self.set_initialized()

    # -- conversions -----------------------------------------------------------

    def to_numpy(self, to_all=True):
        """Return the state as a host complex128 numpy array. ``to_all`` is
        accepted for reference API parity."""
        self.assert_initialized()
        arr = self.data.detach().to('cpu', torch.float64).numpy()
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

        dim = len(self)
        states = self.subspace.idx_to_state(np.arange(dim, dtype=np.int64))
        keep = torch.as_tensor(((states >> index) & 1) == value,
                               device=self.data.device)
        data = cvec.mask_rows(self.data, keep)
        self.data = cvec.scale_real(data, 1.0 / float(cvec.norm(data)))

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
        The vector is streamed to disk in SAVE_CHUNK-element pieces."""
        self.assert_initialized()
        dim = len(self)
        with open(fname + '.metadata', 'wb') as fm:
            _dump_subspace(self.subspace, fm)
        with open(fname + '.vec', 'wb') as f:
            f.truncate(2 * dim * 8)
            for start in range(0, dim, self.SAVE_CHUNK):
                piece = self.data[:, start:start + self.SAVE_CHUNK].to(
                    'cpu', torch.float64).numpy()
                f.seek(start * 8)
                f.write(piece[0].tobytes())
                f.seek((dim + start) * 8)
                f.write(piece[1].tobytes())

    @classmethod
    def from_file(cls, fname):
        """Load a state saved with :meth:`save` by either package."""
        with open(fname + '.metadata', 'rb') as f:
            subspace = _SubspaceUnpickler(f).load()
        dim = subspace.get_dimension()
        if os.path.getsize(fname + '.vec') != 2 * dim * 8:
            raise RuntimeError('corrupt data encountered when loading state '
                               'from file')

        rtn = cls(subspace=subspace)
        data = torch.empty((2, dim), dtype=config.real_dtype,
                           device=config.device)
        mm = np.memmap(fname + '.vec', dtype=np.float64, mode='r',
                       shape=(2, dim))
        for start in range(0, dim, cls.SAVE_CHUNK):
            piece = np.array(mm[:, start:start + cls.SAVE_CHUNK])
            data[:, start:start + piece.shape[1]] = torch.from_numpy(piece)
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
