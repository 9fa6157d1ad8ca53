"""Term lists as bit masks: the plain reference's reading of a Hamiltonian.

A term list is a list of ``(coefficient, ((site, letter), ...))`` pairs,
``letter`` one of ``'X'``, ``'Y'``, ``'Z'``; a term is the coefficient times
the product of the Pauli matrices on its sites. Site ``i`` is bit ``i`` of
a basis state's index, and bit value 0 is spin up (sigma^z = +1).

A Pauli string ``P`` with flip mask ``x`` (its X and Y sites), sign mask
``z`` (its Y and Z sites) and ``n_y`` Y sites acts on a basis state as

    P |s> = i**n_y * (-1)**popcount(s & z) * |s ^ x>

since sigma^y = i sigma^x sigma^z. Nothing here imports the port.
"""


def masks(term_sites):
    """(x, z, n_y) of one Pauli string ``((site, letter), ...)``."""
    x = z = n_y = 0
    seen = set()
    for site, letter in term_sites:
        if site in seen:
            raise ValueError(f'site {site} appears twice in one term')
        seen.add(site)
        bit = 1 << site
        if letter == 'X':
            x |= bit
        elif letter == 'Y':
            x |= bit
            z |= bit
            n_y += 1
        elif letter == 'Z':
            z |= bit
        else:
            raise ValueError(f'unknown Pauli letter {letter!r}')
    return x, z, n_y


def groups(terms):
    """The terms by flip mask: ``{x: [(c, z), ...]}`` with ``c`` the
    coefficient times ``i**n_y``, so that each contributes
    ``c * (-1)**popcount(s & z)`` to the matrix element <s ^ x | H | s>."""
    out = {}
    for coeff, sites in terms:
        x, z, n_y = masks(sites)
        out.setdefault(x, []).append((complex(coeff) * (1j ** n_y), z))
    return out


def coefficient(group, s):
    """The matrix element factor of one flip-mask group at source state
    ``s`` (an int): sum of c * (-1)**popcount(s & z)."""
    return sum(c * (-1) ** bin(s & z).count('1') for c, z in group)


def one_norm_bound(terms):
    """sum |c| over the terms: a bound on the operator's 2-norm."""
    return sum(abs(complex(c)) for c, _ in terms)


def dense(terms, L):
    """The 2**L x 2**L matrix of a term list, by Kronecker products of the
    Pauli matrices (numpy; for tests at small L)."""
    import numpy as np
    paulis = {'I': np.eye(2), 'X': np.array([[0, 1], [1, 0]]),
              'Y': np.array([[0, -1j], [1j, 0]]),
              'Z': np.array([[1, 0], [0, -1]])}
    H = np.zeros((2 ** L, 2 ** L), dtype=np.complex128)
    for coeff, sites in terms:
        letters = dict(sites)
        M = np.ones((1, 1))
        # the highest site is the leading Kronecker factor (bit L-1)
        for site in range(L - 1, -1, -1):
            M = np.kron(M, paulis[letters.get(site, 'I')])
        H += complex(coeff) * M
    return H
