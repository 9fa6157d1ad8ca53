"""
dynamite_tpu_torch — the PyTorch/CUDA port of :mod:`dynamite_tpu`: symbolic
Pauli-string Hamiltonians, Krylov time evolution and Lanczos eigensolving on
the ``Full`` and ``Parity`` spaces, with the matrix-free XOR matvec as a
hand-written CUDA kernel for Hopper (``csrc/xor_apply.cu``).

The public API keeps the JAX package's module layout:

* :mod:`dynamite_tpu_torch.operators` — Operator, sigmax/y/z, op_sum, ...
* :mod:`dynamite_tpu_torch.states` — State
* :mod:`dynamite_tpu_torch.subspaces` — Full, Parity
* :mod:`dynamite_tpu_torch.computations` — evolve, eigsolve
* ``dynamite_tpu_torch.config`` — global defaults (L, subspace, precision,
  device)

State vectors are ``(2, dim)`` real tensors (re/im planes), the JAX
package's layout, so the Krylov code and the tests compare like with like.
"""

__version__ = '0.1.0'

from .utils import validate


class _Config:
    """Package-wide configuration (the JAX package's ``_Config``, with a
    ``torch.device`` in place of the platform and mesh)."""

    def __init__(self):
        self.initialized = False
        self._L = None
        self._shell = True
        self._subspace = None
        self._precision = None
        self._device = None

    # -- one-shot initialization ------------------------------------------

    def initialize(self, precision=None, device=None, slepc_args=None,
                   version_check=None, gpu=None):
        """Initialize the configuration.

        Only the first call has any effect; it is called automatically (with
        defaults) the first time device computation is needed.

        Parameters
        ----------
        precision : str, optional
            'single' (float32 planes) or 'double' (float64 planes).
            Defaults to 'double'.

        device : str or torch.device, optional
            Where states and operator tables live. Defaults to CUDA when
            ``torch.cuda.is_available()``, else the CPU.

        slepc_args, version_check, gpu :
            Accepted for call-compatibility with the reference; ignored.
        """
        if self.initialized:
            raise RuntimeError('config.initialize() can only be called once.')
        if device is not None:
            self.device = device
        self._initialize(precision=precision)

    def _initialize(self, precision=None):
        if self.initialized:
            return

        import torch

        if precision is None:
            precision = self._precision or 'double'
        if precision not in ('single', 'double'):
            raise ValueError("precision must be 'single' or 'double'")
        self._precision = precision

        # TF32 keeps ~10 mantissa bits. The Krylov basis dots and combines
        # are float32 matmuls; the JAX package measured a 3e-3 eigsolve
        # residual floor and a visible norm drift when those contractions
        # ran at reduced precision, so they must run in full float32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        if self._device is None:
            self._device = torch.device(
                'cuda' if torch.cuda.is_available() else 'cpu')

        self.initialized = True

    # -- global defaults ---------------------------------------------------

    @property
    def L(self):
        """Global default spin chain length (not retroactive)."""
        return self._L

    @L.setter
    def L(self, value):
        self._L = validate.L(value)

    @property
    def shell(self):
        """Kept for API parity with the reference: every operator is
        matrix-free."""
        return self._shell

    @shell.setter
    def shell(self, value):
        self._shell = validate.shell(value)

    @property
    def subspace(self):
        """Global default subspace applied to new operators and states."""
        return self._subspace

    @subspace.setter
    def subspace(self, value):
        self._subspace = None if value is None else validate.subspace(value)

    @property
    def precision(self):
        """Floating point precision: 'single' or 'double'."""
        if self._precision is None:
            return 'double'
        return self._precision

    @precision.setter
    def precision(self, value):
        if self.initialized and value != self._precision:
            raise RuntimeError('cannot change precision after initialization')
        if value not in ('single', 'double'):
            raise ValueError("precision must be 'single' or 'double'")
        self._precision = value

    @property
    def device(self):
        """The torch.device that holds states and operator tables."""
        self._initialize()
        return self._device

    @device.setter
    def device(self, value):
        import torch
        self._device = torch.device(value)

    @property
    def gpu(self):
        """Whether states live on a CUDA device."""
        return self.device.type == 'cuda'

    # dtype policy ---------------------------------------------------------

    @property
    def real_dtype(self):
        """The torch dtype of each re/im plane."""
        import torch
        return torch.float64 if self.precision == 'double' else torch.float32


config = _Config()
