"""
The MSC (mask, sign, coefficient) representation of Pauli-string operators.

An operator is a sum of terms ``c * P`` where ``P`` is a Pauli string encoded
by two bit-masks over the ``L`` spins:

* ``mask`` — bit i set means the string flips spin i (an X or Y there)
* ``sign`` — bit i set means the string reads out spin i's Z eigenvalue

The matrix semantics (the executable spec, mirroring the reference
implementation's ``msc_to_numpy`` in
dynamite's src/dynamite/msc_tools.py:19-92) are::

    row index r  ->  ket = idx_to_state(r)          (left subspace map)
    bra          =   mask ^ ket
    col index    =   state_to_idx(bra)              (right subspace map)
    entry        =   (-1)**parity(sign & bra) * coeff

so sigma_x(i) = {mask: 1<<i, sign: 0,    coeff: 1},
   sigma_y(i) = {mask: 1<<i, sign: 1<<i, coeff: 1j},
   sigma_z(i) = {mask: 0,    sign: 1<<i, coeff: 1}.

All functions here are host-side numpy; the device kernels consume the
grouped form produced by :func:`mask_groups`.
"""

import numpy as np
import scipy.sparse

from ..utils.bitwise import parity, intlog2

# Host-side representation always uses 64-bit masks; the device kernels
# narrow to int32 when L <= 31.
msc_dtype = np.dtype([
    ('masks', np.int64),
    ('signs', np.int64),
    ('coeffs', np.complex128),
])


def msc_from_arrays(masks, signs, coeffs):
    """Assemble an MSC array from three parallel arrays."""
    masks = np.atleast_1d(masks)
    out = np.zeros(len(masks), dtype=msc_dtype)
    out['masks'] = masks
    out['signs'] = signs
    out['coeffs'] = coeffs
    return out


def as_msc(value):
    """Validate/convert ``value`` to an MSC numpy array."""
    return np.array(value, copy=None, dtype=msc_dtype).reshape(-1)


def msc_sum(terms):
    """Operator addition: concatenation of term lists."""
    terms = list(terms)
    if not terms:
        return np.zeros(0, dtype=msc_dtype)
    return np.concatenate([as_msc(t) for t in terms])


def msc_product(factors):
    """Operator product, left to right.

    The Pauli product rule on the bitmask encoding: multiplying an
    accumulated term (m1, s1, c1) on the right by (m2, s2, c2) gives
    (m1^m2, s1^s2, c1*c2*(-1)**parity(m2 & s1)) — the sign arises from
    commuting the incoming X-part past the accumulated Z-part.
    """
    factors = [as_msc(f) for f in factors]
    if not factors:
        return msc_from_arrays([0], [0], [1.0])

    # cartesian product over the terms of each factor
    grids = np.meshgrid(*factors, indexing='ij')
    out = grids[0].reshape(-1).copy()
    for g in grids[1:]:
        g = g.reshape(-1)
        commute_sign = 1 - 2 * parity(g['masks'] & out['signs'])
        out['masks'] ^= g['masks']
        out['signs'] ^= g['signs']
        out['coeffs'] *= commute_sign * g['coeffs']
    return out


def combine_terms(msc):
    """Sort by (mask, sign), merge duplicate terms, drop exact zeros."""
    msc = as_msc(msc)
    if msc.size == 0:
        return msc
    order = np.lexsort((msc['signs'], msc['masks']))
    msc = msc[order]
    keys = msc[['masks', 'signs']]
    boundaries = np.empty(msc.size, dtype=bool)
    boundaries[0] = True
    boundaries[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(boundaries)
    summed = np.add.reduceat(msc['coeffs'], starts)
    out = msc[starts].copy()
    out['coeffs'] = summed
    return out[out['coeffs'] != 0]


def truncate(msc, tol):
    """Drop terms with |coeff| <= tol."""
    if tol < 0:
        raise ValueError('tol cannot be less than zero')
    msc = as_msc(msc)
    return msc[np.abs(msc['coeffs']) > tol]


def shift(msc, shift_by, wrap_idx=None):
    """Translate the operator ``shift_by`` sites up the chain.

    If ``wrap_idx`` is given, bits shifted to position >= wrap_idx wrap
    around to position 0 (periodic boundary).
    """
    if shift_by == 0:
        return msc
    msc = as_msc(msc).copy()
    msc['masks'] <<= shift_by
    msc['signs'] <<= shift_by
    if wrap_idx is not None:
        high = np.int64(-1) << np.int64(wrap_idx)
        for field in ('masks', 'signs'):
            v = msc[field]
            wrapped = (v & high) >> np.int64(wrap_idx)
            msc[field] = (v & ~high) | wrapped
    return msc


def is_hermitian(msc):
    """A term is Hermitian-compatible iff its coefficient is real when
    parity(mask & sign) is even, and pure-imaginary when odd (a Y
    contributes one factor of i to the encoding)."""
    msc = as_msc(msc)
    odd = parity(msc['masks'] & msc['signs']).astype(bool)
    if np.any(msc['coeffs'][odd].real != 0):
        return False
    if np.any(msc['coeffs'][~odd].imag != 0):
        return False
    return True


def max_spin_idx(msc):
    """Largest spin index with support; -1 for the empty operator."""
    msc = as_msc(msc)
    if msc.size == 0:
        return -1
    return int(intlog2(max(int(np.max(msc['masks'])), int(np.max(msc['signs'])))))


def nnz_per_row(msc):
    """Number of nonzeros per matrix row = number of distinct masks."""
    return len(np.unique(as_msc(msc)['masks']))


def mask_groups(msc):
    """Group a *sorted, combined* MSC array by mask.

    Returns (unique_masks, offsets) where terms of unique_masks[g] occupy
    msc[offsets[g]:offsets[g+1]]. This is the wire format consumed by the
    device kernels (reference analog: operators.py:653-669).
    """
    msc = as_msc(msc)
    if np.any(np.diff(msc['masks']) < 0):
        raise ValueError('msc must be sorted by mask (call combine_terms)')
    masks, starts = np.unique(msc['masks'], return_index=True)
    offsets = np.empty(len(masks) + 1, dtype=np.int64)
    offsets[:-1] = starts
    offsets[-1] = msc.size
    return masks, offsets


def msc_to_matrix(msc, dims, idx_to_state=None, state_to_idx=None,
                  sparse=True, block=4096):
    """Reference oracle: materialize the matrix as scipy sparse / numpy dense.

    Vectorized over (row block) x (terms). ``idx_to_state`` maps left-subspace
    indices to product states; ``state_to_idx`` maps states to right-subspace
    indices (-1 when the state is outside the right subspace, dropping the
    entry — the projection semantics).
    """
    msc = as_msc(msc)
    n_rows, n_cols = dims

    if idx_to_state is None:
        idx_to_state = lambda x: x
    if state_to_idx is None:
        state_to_idx = lambda x: x

    data_parts, row_parts, col_parts = [], [], []
    for start in range(0, n_rows, block):
        stop = min(start + block, n_rows)
        rows = np.arange(start, stop, dtype=np.int64)
        kets = np.asarray(idx_to_state(rows), dtype=np.int64)
        # shape (rows, terms)
        bras = kets[:, None] ^ msc['masks'][None, :]
        cols = np.asarray(state_to_idx(bras.reshape(-1)),
                          dtype=np.int64).reshape(bras.shape)
        signs = 1 - 2 * parity(bras & msc['signs'][None, :])
        vals = signs * msc['coeffs'][None, :]
        keep = cols >= 0
        r_idx, t_idx = np.nonzero(keep)
        data_parts.append(vals[r_idx, t_idx])
        row_parts.append(rows[r_idx])
        col_parts.append(cols[r_idx, t_idx])

    data = np.concatenate(data_parts) if data_parts else np.zeros(0, complex)
    rows = np.concatenate(row_parts) if row_parts else np.zeros(0, np.int64)
    cols = np.concatenate(col_parts) if col_parts else np.zeros(0, np.int64)

    mat = scipy.sparse.csr_matrix((data, (rows, cols)), shape=dims)
    if not sparse:
        mat = mat.toarray()
    return mat


### serialization — byte-compatible with the reference format
### (nterms\n int_size\n then big-endian masks, signs, coeffs blobs;
###  reference: msc_tools.py:276-365)

def serialize(msc):
    msc = as_msc(msc)
    header = f'{msc.size}\n64\n'.encode('utf-8')
    be_int = np.dtype(np.int64).newbyteorder('B')
    be_cplx = np.dtype(np.complex128).newbyteorder('B')
    return (header
            + msc['masks'].astype(be_int).tobytes()
            + msc['signs'].astype(be_int).tobytes()
            + msc['coeffs'].astype(be_cplx).tobytes())


def deserialize(data):
    first_nl = data.find(b'\n')
    second_nl = data.find(b'\n', first_nl + 1)
    nterms = int(data[:first_nl])
    int_size = int(data[first_nl + 1:second_nl])
    if int_size not in (32, 64):
        raise ValueError('invalid int size in serialized operator')
    int_t = np.dtype(np.int32 if int_size == 32 else np.int64).newbyteorder('B')
    nbytes = nterms * int_size // 8

    view = memoryview(data)
    pos = second_nl + 1
    masks = np.frombuffer(view[pos:pos + nbytes], dtype=int_t)
    pos += nbytes
    signs = np.frombuffer(view[pos:pos + nbytes], dtype=int_t)
    pos += nbytes
    coeffs = np.frombuffer(
        view[pos:pos + nterms * 16],
        dtype=np.dtype(np.complex128).newbyteorder('B'))

    return msc_from_arrays(masks.astype(np.int64), signs.astype(np.int64),
                           coeffs.astype(np.complex128))


### pretty-printing

_PAULI_CHARS = {(0, 0): '-', (0, 1): 'Z', (1, 0): 'X', (1, 1): 'Y'}


def term_to_string(mask, sign, coeff, L):
    """Render one term as (coeff, pauli-string) with Y factors folded in."""
    chars = []
    c = coeff
    for i in range(L):
        m_bit = (int(mask) >> i) & 1
        s_bit = (int(sign) >> i) & 1
        chars.append(_PAULI_CHARS[(m_bit, s_bit)])
        if m_bit and s_bit:
            c *= -1j
    return c, ''.join(chars)


def format_coeff(c, trunc=False, parens=False):
    if not trunc:
        s = str(c)
        if not parens and s.startswith('('):
            s = s[1:-1]
        return s
    c = complex(c)

    has_both = c.real != 0 and c.imag != 0
    big = not (1e-2 <= abs(c) <= 1e2) and c != 0
    if has_both:
        s = f'{c:.2e}' if big else f'{c:.2f}'
    elif c.imag != 0:
        s = f'{c.imag:.2e}j' if big else f'{c.imag:.3f}j'
    else:
        s = f'{c.real:.2e}' if big else f'{c.real:.3f}'
    if parens and (has_both or 'e' in s):
        s = f'({s})'
    return s


def table(msc, L):
    """ASCII table of the operator's terms."""
    msc = as_msc(msc)
    coeff_strs, pauli_strs = [], []
    for m, s, c in msc:
        c, pstr = term_to_string(m, s, c, L)
        coeff_strs.append(format_coeff(c, trunc=True))
        pauli_strs.append(pstr)

    width = max([7] + [len(s) for s in coeff_strs])
    pad = ' ' * (max(L - 8, 0) // 2)
    header = f' {"coeff.".center(width)} | {pad}operator{pad} \n'
    out = header + '=' * (len(header) - 1) + '\n'
    out += '\n'.join(f' {c.rjust(width)} | {p}'
                     for c, p in zip(coeff_strs, pauli_strs))
    return out
