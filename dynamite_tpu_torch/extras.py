"""
Extra operator constructions: commutators and Majorana (Jordan-Wigner)
operators (reference analog: src/dynamite/extras.py).
"""

from .operators import OpText, sigmax, sigmay, sigmaz, index_product


def commutator(op1, op2):
    """The commutator [O1, O2]."""
    rtn = op1 * op2 - op2 * op1
    rtn._text = OpText(
        f'[{op1}, {op2}]',
        r'\left[ %s, %s \right]' % (op1._text.tex, op2._text.tex),
        f'commutator({op1!r}, {op2!r})', '')
    return rtn


def majorana(idx):
    r"""Majorana fermion operator via the Jordan-Wigner transformation: a
    string of :math:`\sigma_z` up to site idx//2, then :math:`\sigma_x`
    (even idx) or :math:`\sigma_y` (odd idx)."""
    b_idx = idx // 2
    if idx % 2:
        rtn = sigmay(b_idx)
    else:
        rtn = sigmax(b_idx)

    if b_idx > 0:
        rtn = index_product(sigmaz(), size=b_idx) * rtn

    rtn._text = OpText(f'χ[{idx}]', r'\chi_{IDX%d}' % idx,
                       f'majorana({idx})', '')
    return rtn
