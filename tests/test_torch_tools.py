"""
The port's ``tools`` module (``tests/unit/test_tools.py``'s cases, on the
CPU) and its device default: without a CUDA device, and unless the CPU was
asked for, the first device computation raises.
"""

import numpy as np
import pytest
import torch

from dynamite_tpu import tools as ref_tools

import dynamite_tpu_torch
from dynamite_tpu_torch import config, tools

# One torch thread per xdist worker (ROADMAP.md queue 3).
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu_device():
    """The port runs on the card unless asked for the CPU: these tests ask."""
    saved = config._device
    config.device = 'cpu'
    yield
    config._device = saved


def test_mpi_print(capsys):
    tools.mpi_print('hello', 42)
    assert capsys.readouterr().out == 'hello 42\n'
    tools.mpi_print('not rank 1', rank=1)
    assert capsys.readouterr().out == ''


def test_version():
    info = tools.get_version()
    assert info['version'] == dynamite_tpu_torch.__version__
    assert info['torch'] == torch.__version__
    assert info['cuda'] == torch.version.cuda
    assert info['device'] == 'cpu'
    assert 'dynamite_tpu_torch' in tools.get_version_str()


def test_memory_tracking():
    """On the CPU no device memory is counted; the peak is never below the
    current value."""
    assert tools.track_memory()
    x = torch.zeros(1 << 16)
    usage = tools.get_memory_usage(group_by='rank')
    assert usage == 0
    assert tools.get_memory_usage(group_by='all', max_usage=True) >= usage
    with pytest.raises(ValueError):
        tools.get_memory_usage(group_by='bogus')
    del x


def test_comm_shim():
    comm = tools.MPI_COMM_WORLD()
    assert comm.rank == 0
    assert comm.size == 1
    comm.barrier()


def test_complex_enabled():
    assert tools.complex_enabled() == ref_tools.complex_enabled()


def test_spectral_site_order():
    """The relabeling is a valid permutation, does not increase the number
    of bonds crossing the low/high bit-half cut, and equals the JAX
    package's."""
    n = 18
    # a torus-like graph: ring + skip connections
    edges = [(i, (i + 1) % n) for i in range(n)] + \
            [(i, (i + 5) % n) for i in range(n)]
    relabel = tools.spectral_site_order(n, edges)
    assert sorted(relabel) == list(range(n))
    assert np.array_equal(relabel, ref_tools.spectral_site_order(n, edges))

    def cut(es):
        half = n // 2
        return sum(1 for i, j in es if (i < half) != (j < half))

    new_edges = [(relabel[i], relabel[j]) for i, j in edges]
    assert cut(new_edges) <= cut(edges)


def test_default_device_without_a_card_raises(monkeypatch):
    """A fresh configuration without a CUDA device and without a request for
    the CPU raises at the first device computation, naming the way to ask;
    asked for, the CPU is used."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = dynamite_tpu_torch._Config()
    with pytest.raises(RuntimeError, match="config.device = 'cpu'"):
        cfg.device
    assert cfg.real_dtype == torch.float64  # host-only settings still work
    cfg.device = 'cpu'
    assert cfg.device == torch.device('cpu') and not cfg.gpu

    # the package's own config, through a state: it raises too
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import Full
    monkeypatch.setattr(config, '_device', None)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        State(state='random', subspace=Full(L=4))
