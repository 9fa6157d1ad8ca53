"""The Hamiltonian and pulse of dynamite's Floquet heating study
(``examples/scripts/floquet/run_floquet.py``) as term lists.

H = Jz sum_{r=1}^{L-1} r**-alpha sum_i 1/4 Z_i Z_{i+r}
  + Jx sum_i 1/4 X_i X_{i+1}
  + sum_i 1/2 (hx X_i + hy Y_i + hz Z_i),
every sum over the open chain (``index_sum``'s default boundary); the
pulse is X on every site (``index_product(sigmax())``). A term is
``(coefficient, ((site, letter), ...))``.
"""


def terms(params, L, fields=None):
    alpha, Jz, Jx = params['alpha'], params['Jz'], params['Jx']
    hx, hy, hz = params['h']
    out = []
    for r in range(1, L):
        c = Jz * 0.25 / r ** alpha
        out += [(c, ((i, 'Z'), (i + r, 'Z'))) for i in range(L - r)]
    out += [(Jx * 0.25, ((i, 'X'), (i + 1, 'X'))) for i in range(L - 1)]
    for i in range(L):
        out += [(0.5 * hx, ((i, 'X'),)), (0.5 * hy, ((i, 'Y'),)),
                (0.5 * hz, ((i, 'Z'),))]
    return out


def pulse(params, L):
    return [(1.0, tuple((i, 'X') for i in range(L)))]
