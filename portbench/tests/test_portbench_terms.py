"""Each term list against a dense NumPy matrix at L=8, the port's operator
of it against the upstream study's own construction, and the plain
reference's matvecs against the dense matrix."""

import numpy as np
import pytest
import torch

from portbench.core.manifest import Manifest
from portbench.hamiltonians import floquet, mbl
from portbench.reference import expm, full, lanczos, pauli, sector

L = 8
MAN = Manifest()
FLOQUET = MAN.config('floquet_L26')['params']
MBL = MAN.config('mbl_L24')['params']


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def port_cpu():
    from dynamite_tpu_torch import config
    config.device = 'cpu'
    config.L = L
    yield config
    config._L = None


def _fields():
    return mbl.draw_fields(MBL, L, np.random.default_rng(5))


def _port_dense(op, subspace=None):
    if subspace is not None:
        op.subspace = subspace
    return np.asarray(op.to_numpy(sparse=False))


def test_pauli_letters_match_the_port(port_cpu):
    from dynamite_tpu_torch.operators import sigmax, sigmay, sigmaz
    for letter, op in (('X', sigmax), ('Y', sigmay), ('Z', sigmaz)):
        for site in (0, 3, 7):
            np.testing.assert_allclose(
                pauli.dense([(1.0, ((site, letter),))], L),
                _port_dense(op(site)), atol=0)


def test_floquet_terms_are_the_study(port_cpu):
    """The term list equals run_floquet.py's Hamiltonian and pulse as the
    script builds them with the port's operators."""
    from dynamite_tpu_torch.operators import (index_product, index_sum,
                                              op_sum, sigmax, sigmay, sigmaz)
    p = FLOQUET
    zz = op_sum(1 / r ** p['alpha'] * index_sum(0.25 * sigmaz(0) * sigmaz(r))
                for r in range(1, L))
    xx = index_sum(0.25 * sigmax(0) * sigmax(1))
    field = index_sum(op_sum(h * 0.5 * s() for h, s in
                             zip(p['h'], (sigmax, sigmay, sigmaz))))
    H = p['Jz'] * zz + p['Jx'] * xx + field
    np.testing.assert_allclose(pauli.dense(floquet.terms(p, L), L),
                               _port_dense(H), atol=1e-13)
    np.testing.assert_allclose(pauli.dense(floquet.pulse(p, L), L),
                               _port_dense(index_product(sigmax())),
                               atol=0)


def test_mbl_terms_are_the_study(port_cpu):
    from dynamite_tpu_torch.operators import index_sum, sigmax, sigmay, sigmaz
    f = _fields()
    heis = 0.25 * sum(s(0) * s(1) for s in (sigmax, sigmay, sigmaz))
    H = index_sum(heis) + sum(0.5 * fi * sigmaz(i) for i, fi in enumerate(f))
    np.testing.assert_allclose(pauli.dense(mbl.terms(MBL, L, f), L),
                               _port_dense(H), atol=1e-13)


@pytest.mark.parametrize('which', ['floquet', 'pulse', 'mbl'])
def test_port_operator_of_the_terms(port_cpu, which):
    from portbench.core import port
    terms = {'floquet': floquet.terms(FLOQUET, L),
             'pulse': floquet.pulse(FLOQUET, L),
             'mbl': mbl.terms(MBL, L, _fields())}[which]
    np.testing.assert_allclose(_port_dense(port.operator(terms)),
                               pauli.dense(terms, L), atol=1e-13)


@pytest.mark.parametrize('which', ['floquet', 'pulse', 'mbl', 'wide'])
def test_full_reference_matvec(which):
    terms = {'floquet': floquet.terms(FLOQUET, L),
             'pulse': floquet.pulse(FLOQUET, L),
             'mbl': mbl.terms(MBL, L, _fields()),
             # signs on sites the term does not flip, and a wide flip
             'wide': [(0.3 - 0.2j, ((0, 'Y'), (2, 'Z'), (5, 'X'))),
                      (0.3 + 0.2j, ((0, 'Y'), (2, 'Z'), (5, 'X'))),
                      (0.7, tuple((i, 'Y') for i in range(L))),
                      (0.1, ((1, 'Z'),))]}[which]
    D = pauli.dense(terms, L)
    op = full.FullOperator(terms, L, 'cpu')
    rng = np.random.default_rng(1)
    x = rng.normal(size=2 ** L) + 1j * rng.normal(size=2 ** L)
    y = op.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, D @ x, atol=1e-12)


def test_sector_order_is_the_ports(port_cpu):
    from dynamite_tpu_torch.subspaces import SpinConserve
    for n, k in ((8, 4), (9, 3), (10, 5)):
        sub = SpinConserve(n, k)
        want = [int(sub.idx_to_state(i)) for i in range(sub.get_dimension())]
        assert sector.sector_states(n, k, 'cpu').tolist() == want


def test_sector_reference_matvec():
    terms = mbl.terms(MBL, L, _fields())
    states = sector.sector_states(L, L // 2, 'cpu').numpy()
    D = pauli.dense(terms, L)[np.ix_(states, states)]
    op = sector.SectorOperator(terms, L, L // 2, 'cpu')
    assert op.real
    rng = np.random.default_rng(2)
    x = rng.normal(size=len(states)) + 1j * rng.normal(size=len(states))
    np.testing.assert_allclose(op.apply(torch.from_numpy(x)).numpy(), D @ x,
                               atol=1e-12)
    assert op.nnz() == np.count_nonzero(D)


def test_reference_expm_and_lanczos():
    from scipy.linalg import eigh, expm as dense_expm
    terms = floquet.terms(FLOQUET, L)
    D = pauli.dense(terms, L)
    op = full.FullOperator(terms, L, 'cpu')
    x = np.zeros(2 ** L, dtype=complex)
    x[37] = 1
    got = expm.expm_apply(op.apply, torch.from_numpy(x), -1j * 0.12,
                          pauli.one_norm_bound(terms)).numpy()
    np.testing.assert_allclose(got, dense_expm(-0.12j * D) @ x, atol=1e-13)
    w = eigh(D, eigvals_only=True)
    low, high = lanczos.extremal_eigenvalues(op.apply, 2 ** L, 4,
                                             torch.complex128, 'cpu')
    np.testing.assert_allclose(low, w[:4], atol=1e-10)
    np.testing.assert_allclose(high, w[::-1][:4], atol=1e-10)
