"""
The port's XOR matvec (plan + plain PyTorch version of the Hopper kernel)
against the JAX package: its XLA engine in float64 and its Pallas kernel
(interpret mode) in float32, on Full and both Parity sectors.

The same numpy inputs go through both packages. Tolerances, as max|dy| /
max|y|: 1e-12 in float64 (both sum the same terms in another order) and
1e-5 in float32. The CUDA kernel itself is compared with the same plain
version on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.ops import pallas_apply as ref_pallas
from dynamite_tpu.ops.pallas_apply import build_pallas_apply

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch import tracing
from dynamite_tpu_torch.ops import xor_apply as port_xor
from dynamite_tpu_torch.ops.xor_apply import xor_apply, xor_apply_reference
from dynamite_tpu_torch.states import State

# One torch thread per xdist worker. torch on every core in several workers
# overloads the machine, and the JAX package's CPU collectives then miss
# XLA's rendezvous timeout and abort the worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

# dim >= 2**10 for the Pallas kernel (pallas_apply.MIN_BLOCK_BITS)
L = 13
MODELS = ['localized', 'ising', 'heisenberg', 'mbl']
SPACES = ['full', 'even', 'odd']


@pytest.fixture(autouse=True)
def reset_config():
    # the port runs on the card unless asked for the CPU
    saved_device = config._device
    config.device = 'cpu'
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    yield
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    config._device = saved_device


def _sub(pkg, space):
    if space == 'full':
        return pkg.Full(L=L)
    return pkg.Parity(space, L=L)


def _pair(model, space):
    """The same operator and subspace in both packages (projection allowed:
    ising's X field leaves the Parity sectors)."""
    H_ref = getattr(ref_models, model)(L)
    H_ref.allow_projection = True
    sub_ref = _sub(ref_subspaces, space)
    H_ref.add_subspace(sub_ref)
    H = getattr(models, model)(L)
    H.allow_projection = True
    sub = _sub(subspaces, space)
    H.add_subspace(sub)
    return H_ref, sub_ref, H, sub


def _planes(dim, dtype, seed=0):
    x = np.random.RandomState(seed).standard_normal((2, dim)).astype(dtype)
    return x / np.linalg.norm(x)


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(
        np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize('space', SPACES)
@pytest.mark.parametrize('model', MODELS)
def test_xor_apply_vs_reference(model, space):
    H_ref, sub_ref, H, sub = _pair(model, space)
    ref_kernel = H_ref.get_mat()
    kernel = H.get_mat()
    assert len(kernel.plan.groups) == len(ref_kernel.plan.groups)
    dim = sub.get_dimension()

    # float64: the reference's XLA engine
    x64 = _planes(dim, np.float64)
    want = np.asarray(ref_kernel.apply(jnp.asarray(x64)))
    got = kernel.apply(torch.from_numpy(x64)).numpy()
    assert _rel(got, want) < 1e-12

    # float32: the reference's Pallas kernel, run in interpret mode
    fn = build_pallas_apply(ref_kernel.plan, sub_ref, sub_ref,
                            interpret=True)
    assert fn is not None
    x32 = _planes(dim, np.float32)
    want32 = np.asarray(fn(jnp.asarray(x32)))
    got32 = xor_apply(torch.from_numpy(x32), kernel.tables).numpy()
    assert got32.dtype == np.float32
    assert _rel(got32, want32) < 1e-5


@pytest.mark.parametrize('space', SPACES)
def test_effective_sign_mask_vs_reference(space):
    """The host plan's sign folding term by term (mbl has Z, ZZ, XX and YY
    terms, so every branch of the fold is taken)."""
    H_ref, sub_ref, H, sub = _pair('mbl', space)
    plan = H.get_mat().plan
    n = 0
    for m, _perm, signs, _coeffs in plan.groups:
        for s in signs:
            assert port_xor._effective_sign_mask(int(s), m, sub, sub) == \
                ref_pallas._effective_sign_mask(int(s), m, sub_ref, sub_ref)
            n += 1
    assert n == plan.nterms > 0


@pytest.mark.parametrize('space', SPACES)
def test_dot_and_norm_vs_reference(space):
    """Operator.dot on States and the device infinity norm, against the
    reference package (its matvec on an unsharded array) and the numpy
    oracles."""
    H_ref, sub_ref, H, sub = _pair('localized', space)
    dim = sub.get_dimension()
    vec = _planes(dim, np.float64, seed=3)
    psi = State(subspace=sub)
    psi.set_planes(vec)

    w = np.asarray(H_ref.get_mat().apply(jnp.asarray(vec)))
    want = w[0] + 1j * w[1]
    got = H.dot(psi).to_numpy()
    assert _rel(got, want) < 1e-12
    oracle = H.to_numpy() @ psi.to_numpy()
    assert _rel(got, oracle) < 1e-12

    nrm = H.infinity_norm()
    assert abs(nrm - H_ref.infinity_norm()) <= 1e-12 * nrm
    assert abs(nrm - H._infinity_norm_host()) <= 1e-12 * nrm


def test_non_xor_pair_raises():
    """A (Full, Parity) pair is not an XOR pair: it takes the general
    route (ELL), not the XOR kernel, and agrees with the oracle."""
    H = models.heisenberg(L)
    H.allow_projection = True
    full, even = subspaces.Full(L=L), subspaces.Parity('even', L=L)
    H.add_subspace(full, even)
    k = H.get_mat(subspaces=(full, even))
    assert k.engine == 'ell' and k.tables is None
    x = np.random.RandomState(4).standard_normal((2, even.get_dimension()))
    got = k.apply(torch.as_tensor(x)).numpy()
    want = H.to_numpy(subspaces=(full, even)) @ (x[0] + 1j * x[1])
    assert np.max(np.abs(got[0] + 1j * got[1] - want)) <= \
        1e-12 * np.max(np.abs(want))


def test_cpu_wrapper_counts_no_launch():
    H = models.ising(L)
    H.add_subspace(subspaces.Full(L=L))
    tables = H.get_mat().tables
    before = tracing.counter('xor.launches')
    x = torch.from_numpy(_planes(tables.dim, np.float64))
    y = xor_apply(x, tables)
    assert tracing.counter('xor.launches') == before
    assert torch.equal(y, xor_apply_reference(x, tables))
