"""
Input validation helpers (reference analog: src/dynamite/validate.py).

Masks are 64-bit host-side and row indices are int64 on the device at both
precisions, so the only hard limit is L <= 63.
"""

MAX_L = 63


def _nonneg_int(x):
    try:
        if int(x) != x or x < 0:
            raise ValueError()
    except (TypeError, ValueError):
        raise ValueError(
            f'Value must be a nonnegative integer (got "{x!r}")') from None
    return int(x)


def L(value):
    value = _nonneg_int(value)
    if value > MAX_L:
        raise ValueError(f'Spin chain lengths greater than {MAX_L} '
                         'not supported.')
    return value


def spin_index(value):
    value = _nonneg_int(value)
    if value > MAX_L - 1:
        raise ValueError(f'Spin indices greater than {MAX_L - 1} '
                         'not supported.')
    return value


def subspace(s):
    from ..subspaces import Subspace
    if not isinstance(s, Subspace):
        raise ValueError('subspace can only be set to objects of Subspace type')
    return s


def msc(value):
    from ..ops.msc import as_msc
    return as_msc(value)


def shell(value):
    if not isinstance(value, bool):
        raise ValueError('shell must be a bool (every operator is '
                         'matrix-free; the flag is kept for API parity)')
    return value
