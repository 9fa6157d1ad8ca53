"""
The port on a CUDA device: the hand-written XOR kernel against its plain
PyTorch version, and Operator.dot / evolve / eigsolve through the kernel.

Every test here needs a card (marker ``cuda``) and skips without one. The
file imports no JAX, so it runs on a machine without it, from the root of
the repository (``--noconftest`` skips tests/conftest.py, which sets up
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: kernel against plain version max|dy|/max|y| <= 1e-5 (float32)
and 1e-12 (float64), as in chip_smoke.py; solvers as in
test_torch_solvers.py.
"""

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.computations import eigsolve, evolve
from dynamite_tpu_torch.ops.xor_apply import xor_apply, xor_apply_reference
from dynamite_tpu_torch.states import State


# One torch thread per xdist worker. torch on every core in several workers
# overloads the machine, and the JAX package's CPU collectives then miss
# XLA's rendezvous timeout and abort the worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

L = 13
SPACES = ['full', 'even', 'odd']

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The CUDA device; the port's config is left at its defaults, which
    put states on it."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    config._L = None
    config._subspace = None
    if config.device.type != 'cuda':
        pytest.skip('config.device is not the CUDA device')
    return config.device


def _sub(space, L=L):
    if space == 'full':
        return subspaces.Full(L=L)
    return subspaces.Parity(space, L=L)


def _planes(dim, seed=0):
    x = np.random.RandomState(seed).standard_normal((2, dim))
    return x / np.linalg.norm(x)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('space', SPACES)
def test_kernel_vs_plain_on_card(card, space, dtype):
    H = models.mbl(L)
    H.allow_projection = True
    H.add_subspace(_sub(space))
    tables = H.get_mat().tables
    x = torch.from_numpy(_planes(tables.dim)).to(card, dtype)
    before = xor_apply.launches
    y = xor_apply(x, tables)
    torch.cuda.synchronize()
    assert xor_apply.launches == before + 1
    want = xor_apply_reference(x, tables)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    err = (y - want).abs().max() / want.abs().max()
    assert float(err) <= tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_with_large_tables(card, dtype):
    """~3000 random Pauli strings: the group/term tables exceed the 48 KB
    of shared memory a launch gets by default."""
    from dynamite_tpu_torch.operators import Operator
    from dynamite_tpu_torch.utils.bitwise import parity
    rng = np.random.RandomState(9)
    n = 3000
    masks = rng.randint(0, 1 << L, n)
    signs = rng.randint(0, 1 << L, n)
    r = rng.uniform(-1, 1, n)
    coeffs = np.where(parity(masks & signs) == 1, 1j * r, r)
    H = Operator.from_msc(np.array(list(zip(masks, signs, coeffs)),
                                   dtype=[('masks', np.int64),
                                          ('signs', np.int64),
                                          ('coeffs', np.complex128)]))
    H.add_subspace(_sub('full'))
    tables = H.get_mat().tables
    assert tables.smem_bytes(torch.empty((), dtype=dtype).element_size()) \
        > 48 * 1024
    x = torch.from_numpy(_planes(tables.dim)).to(card, dtype)
    y = xor_apply(x, tables)
    want = xor_apply_reference(x, tables)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - want).abs().max() / want.abs().max()) <= tol


def test_dot_on_card_matches_cpu(card):
    H = models.localized(L)
    sub = _sub('full')
    H.add_subspace(sub)
    psi = State(subspace=sub)
    psi.set_planes(_planes(sub.get_dimension(), seed=1))
    assert psi.data.is_cuda
    before = xor_apply.launches
    got = H.dot(psi).to_numpy()
    assert xor_apply.launches == before + 1
    want = H.to_numpy() @ psi.to_numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize('space', SPACES)
def test_evolve_and_eigsolve_on_card(card, space):
    H = models.localized(10)
    sub = _sub(space, L=10)
    H.add_subspace(sub)
    v = _planes(sub.get_dimension(), seed=2)
    psi = State(subspace=sub)
    psi.set_planes(v)

    before = xor_apply.launches
    got = evolve(H, psi, t=1.0).to_numpy()
    assert xor_apply.launches > before
    want = scipy.sparse.linalg.expm_multiply(-1j * H.to_numpy(),
                                             v[0] + 1j * v[1])
    assert np.linalg.norm(got - want) < 1e-6

    evals = eigsolve(H, nev=2)
    exact = np.linalg.eigvalsh(H.to_numpy().toarray())[:2]
    assert np.allclose(evals[:2], exact, rtol=1e-10, atol=1e-12)
