"""
The sharded route of the port's XOR kernel (plain PyTorch version) on P
virtual shards of one vector, against the port's one-block version and the
JAX package's sharded routes: its Pallas kernel in interpret mode inside
shard_map and its XLA sharded engine, on a mesh of P devices
(as tests/integration/test_pallas.py::test_pallas_sharded_vs_oracle runs
them).

The same numpy inputs go through both packages. Tolerances, as max|dy| /
max|y|: the port's shards equal the slices of its one-block output exactly
(the same terms per row, in the same order); 1e-5 against the Pallas route
in float32 and 1e-12 against the XLA engine in float64 (both sum the terms
in another order). The CUDA kernel is compared with the same plain version
on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from dynamite_tpu import config as ref_config
from dynamite_tpu import models as ref_models
from dynamite_tpu import subspaces as ref_subspaces
from dynamite_tpu.ops.pallas_apply import (PallasXorPlan,
                                           build_pallas_sharded_parts)
from dynamite_tpu.parallel.mesh import make_mesh

from dynamite_tpu_torch import config
from dynamite_tpu_torch import models
from dynamite_tpu_torch import subspaces
from dynamite_tpu_torch.ops.xor_apply import (xor_apply_reference,
                                              xor_apply_sharded_reference)

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)

# (model, L, space): Full; Parity even with XX/YY terms that cross the
# device bits; Parity odd with projection, whose ZZ sign masks hit bit 0 and
# fold over every index bit, device bits included
CASES = [('localized', 13, 'full'), ('heisenberg', 14, 'even'),
         ('ising', 14, 'odd')]


@pytest.fixture(autouse=True)
def reset_config():
    saved = ref_config.mesh
    # the port runs on the card unless asked for the CPU
    saved_device = config._device
    config.device = 'cpu'
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    yield
    ref_config._mesh = saved
    for cfg in (ref_config, config):
        cfg._L = None
        cfg._subspace = None
    config._device = saved_device


def _sub(pkg, L, space):
    return pkg.Full(L=L) if space == 'full' else pkg.Parity(space, L=L)


def _planes(dim, dtype, seed=0):
    x = np.random.RandomState(seed).standard_normal((2, dim)).astype(dtype)
    return x / np.linalg.norm(x)


def _rel(got, want):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(
        np.max(np.abs(want)), 1e-30)


def _shards(x, tables, P):
    """The P shards of the sharded route, each from its own row offset and
    its partner blocks x[:, (me ^ h) * n : ...]."""
    st = tables.for_layout(tables.nbits - (P.bit_length() - 1))
    n = st.local_dim
    out = []
    for me in range(P):
        srcs = [x[:, (me ^ h) * n:((me ^ h) + 1) * n] for h in st.hi_list]
        out.append(xor_apply_sharded_reference(srcs, st, me * n))
    return st, out


@pytest.mark.parametrize('P', [2, 4, 8])
@pytest.mark.parametrize('model,L,space', CASES)
def test_sharded_route_vs_one_block_and_reference(model, L, space, P):
    H = getattr(models, model)(L)
    H.allow_projection = True
    sub = _sub(subspaces, L, space)
    H.add_subspace(sub)
    tables = H.get_mat().tables
    dim = tables.dim

    # the shards equal the slices of the one-block plain version
    x64 = torch.from_numpy(_planes(dim, np.float64))
    x32 = torch.from_numpy(_planes(dim, np.float32))
    shards = {}
    for x in (x64, x32):
        whole = xor_apply_reference(x, tables)
        st, parts = _shards(x, tables, P)
        n = st.local_dim
        for me, y in enumerate(parts):
            assert y.dtype == x.dtype
            assert torch.equal(y, whole[:, me * n:(me + 1) * n])
        shards[x.dtype] = torch.cat(parts, dim=1).numpy()
    # the Parity sign folds and the high ZZ masks reach the device bits
    assert any(int(s) >> st.local_bits for s in tables.term_s)

    # the JAX package on a mesh of P devices
    ref_config._mesh = make_mesh(mesh_shape=(P,))
    H_ref = getattr(ref_models, model)(L)
    H_ref.allow_projection = True
    sub_ref = _sub(ref_subspaces, L, space)
    H_ref.add_subspace(sub_ref)
    kernel = H_ref.get_mat(subspaces=(sub_ref, sub_ref))
    device_bits = P.bit_length() - 1
    parts = build_pallas_sharded_parts(kernel.plan, sub_ref, sub_ref,
                                       device_bits, interpret=True)
    assert parts is not None
    fn = kernel._wrap_sharded_pallas(parts)
    spec = NamedSharding(ref_config.mesh, PartitionSpec(None, 'd'))
    got = np.asarray(jax.jit(fn)(jax.device_put(jnp.asarray(x32.numpy()),
                                                spec)))
    assert _rel(shards[torch.float32], got) < 1e-5
    want = np.asarray(kernel.sharded_fn(
        jax.device_put(jnp.asarray(x64.numpy()), spec)))
    assert _rel(shards[torch.float64], want) < 1e-12

    # the host split: the same source blocks as the TPU kernel's plan
    plan = PallasXorPlan(kernel.plan, sub_ref, sub_ref,
                         device_bits=device_bits)
    assert st.hi_list == plan.hi_list
    if space != 'odd':
        # the split exercises the exchange
        assert any(h != 0 for h in st.hi_list)
    n = st.local_dim
    for g, m in enumerate(tables.group_mask):
        assert st.hi_list[st.src_idx[g]] == int(m) >> st.local_bits
        assert st.m_lo[g] == int(m) & (n - 1)
