"""
Reduced density matrices, and their spectra on the device (the JAX
package's ``ops/rdm.py``).

Full and Parity states: the amplitudes are scattered into the full 2^L space
(through the subspace's index map), viewed as a [2]*L tensor, permuted so
the kept spins lead, and reshaped to V of shape (2^k, 2^(L-k)) per plane.
With M = [Vr | Vi], rho_re = Vr Vr^T + Vi Vi^T = M M^T and rho_im =
Vi Vr^T - Vr Vi^T = [Vi | -Vr] M^T: two GEMMs.

SpinConserve states: the RDM is block diagonal in the kept weight g (the
traced weight k - g is shared by bra and ket), and each block is B_g^H B_g
with B_g[rank(traced bits), rank(kept bits)] the amplitudes of that weight
class. The source index of every block entry is found once per (subspace,
keep, device), vectorized (numpy unranking of whole rank arrays, then the
subspace map's ``s2i`` on the device), and cached while the subspace lives
(:func:`spinconserve_index`: 2 * dim int64 on the device per keep, 43 MB
at SpinConserve(24, 12); :func:`index_cache_bytes` counts them,
:func:`clear_index_cache` frees them). A call is one gather of
2 * dim elements, laid out so each block is M = [Br | Bi] of shape (n_t,
2 n_k), and one GEMM M^T M per block. Nothing of size 2^L is built.

The products run in float64 whatever the state's precision: a float32
state's RDM is then its amplitudes' exact partial trace to float64
rounding, and its small eigenvalues (and so the entropy) agree with the
host route's. On an H100 this costs no time: DGEMM on the FP64 tensor
cores runs at SGEMM's rate (TF32 is off).

With a process group up, the rows are gathered to rank 0
(``multihost.gather_rows``), which computes the RDM or its spectrum; the
small result is then broadcast to every rank.

Bit convention: spin i is bit i (LSB) of the state integer; the returned
density matrix is indexed by r = sum_j bit(keep[j]) << j.
"""

import weakref
from math import comb

import numpy as np
import torch

from .. import tracing
from ..parallel import multihost


def _bit_perm(L, keep):
    """The tensor-axis permutation that brings the kept spins to the front
    (most-significant kept bit first): axis a of the [2]*L view corresponds
    to bit (L-1-a) of the state integer."""
    keep = list(map(int, keep))
    traced = [i for i in range(L) if i not in keep]
    return ([L - 1 - b for b in reversed(keep)]
            + [L - 1 - b for b in reversed(traced)])


def _merged_transpose(L, perm):
    """Collapse runs of source axes that stay adjacent under ``perm`` so the
    device transpose operates on the lowest possible rank (contiguous keep
    regions — the common entropy cut — reduce to a rank<=3 transpose).

    Returns (src_dims, merged_perm): reshape the 2^L vector to ``src_dims``,
    transpose with ``merged_perm``.
    """
    # group dest-consecutive source axes that are also source-consecutive
    groups = []  # (src_start, length), in dest order
    for ax in perm:
        if groups and ax == groups[-1][0] + groups[-1][1]:
            groups[-1] = (groups[-1][0], groups[-1][1] + 1)
        else:
            groups.append((ax, 1))
    src_order = sorted(range(len(groups)), key=lambda g: groups[g][0])
    src_dims = [1 << groups[g][1] for g in src_order]
    rank = {g: i for i, g in enumerate(src_order)}
    merged_perm = [rank[g] for g in range(len(groups))]
    return src_dims, merged_perm


def _full_rho(data, subspace, keep):
    """The (2^k, 2^k) complex128 RDM of a Full, Parity or Explicit/Auto
    state's (2, dim) planes, on their device: other spaces scatter into the
    2^L vector through their index map's ``i2s``."""
    from .. import subspaces as sp
    from .index_maps import device_map

    L, k = subspace.L, len(keep)
    data = data.double()
    if isinstance(subspace, sp.Full):
        full = data
    else:
        rows = torch.arange(data.shape[1], dtype=torch.int64,
                            device=data.device)
        full = data.new_zeros((2, 1 << L))
        full[:, device_map(subspace).i2s(rows)] = data
    src_dims, merged_perm = _merged_transpose(L, _bit_perm(L, keep))
    V = full.reshape([2] + src_dims).permute(
        [0] + [a + 1 for a in merged_perm]).reshape(2, 1 << k, -1)
    M = torch.cat([V[0], V[1]], dim=1)
    rho_re = M @ M.T
    rho_im = torch.cat([V[1], -V[0]], dim=1) @ M.T
    return torch.complex(rho_re, rho_im)


# subspace -> {(keep, device): (blocks, index)}; equal subspaces share an
# entry, which is freed with the subspace object that made it
_INDEX = weakref.WeakKeyDictionary()


def spinconserve_index(subspace, keep, device):
    """The weight blocks of the SpinConserve RDM over ``keep``: (blocks,
    index) with blocks a list of (g, n_t, n_k, offset) and index the int64
    tensor on ``device`` of 2 * dim positions into the flattened (2, dim)
    planes. Block g's stretch ``index[offset:offset + 2 n_t n_k]``, viewed
    as (n_t, 2 n_k), holds M = [Br | Bi]: row = rank of the traced bits,
    column = rank of the kept bits (imaginary plane after the real one).
    Built once per (subspace, keep, device) from whole rank arrays, and
    held until the subspace object that first asked for them is freed or
    :func:`clear_index_cache` is called; counted in
    ``rdm.spinconserve_index_builds`` (:mod:`..tracing`)."""
    per = _INDEX.setdefault(subspace, {})
    key = (tuple(keep), torch.device(device))
    if key not in per:
        per[key] = _build_index(subspace, keep, device)
        tracing.count('rdm.spinconserve_index_builds')
    return per[key]


def index_cache_bytes():
    """Device bytes the cached SpinConserve index tables hold."""
    return sum(index.numel() * index.element_size()
               for per in list(_INDEX.values())
               for _blocks, index in per.values())


def clear_index_cache():
    """Free every cached SpinConserve index table."""
    _INDEX.clear()


def _build_index(subspace, keep, device):
    """:func:`spinconserve_index`'s tables, built."""
    from . import sectors
    from .index_maps import device_map

    L, k, dim = subspace.L, subspace.k, subspace.get_dimension()
    keep = list(keep)
    traced = [b for b in range(L) if b not in keep]
    nck = sectors.nchoosek_table(L, k)

    def deposit(nbits, weight, bits):
        """Every nbits-bit string of popcount ``weight`` in rank order,
        with bit p moved to position bits[p]."""
        compact = sectors.unrank_bits(
            np.arange(comb(nbits, weight), dtype=np.int64), weight, nbits,
            nck, k)
        out = np.zeros_like(compact)
        for p, b in enumerate(bits):
            out |= ((compact >> p) & 1) << b
        return out

    smap = device_map(subspace)
    blocks, parts, offset = [], [], 0
    for g in range(min(k, len(keep)) + 1):
        if not 0 <= k - g <= len(traced):
            continue
        t = torch.as_tensor(deposit(len(traced), k - g, traced),
                            device=device)
        r = torch.as_tensor(deposit(len(keep), g, keep), device=device)
        idx, _valid = smap.s2i(t[:, None] | r[None, :])  # all in the space
        parts.append(torch.cat([idx, idx + dim], dim=1).reshape(-1))
        blocks.append((g, len(t), len(r), offset))
        offset += 2 * idx.numel()
    return blocks, torch.cat(parts)


def _spinconserve_rhos(data, subspace, keep):
    """[(g, rho_g)]: the complex (n_k, n_k) weight blocks of a SpinConserve
    state's RDM, on the data's device."""
    blocks, index = spinconserve_index(subspace, keep, data.device)
    gathered = data.reshape(-1)[index].double()
    out = []
    for g, n_t, n_k, offset in blocks:
        M = gathered[offset:offset + 2 * n_t * n_k].view(n_t, 2 * n_k)
        G = M.T @ M   # [[Br'Br, Br'Bi], [Bi'Br, Bi'Bi]]
        rho_re = G[:n_k, :n_k] + G[n_k:, n_k:]
        rho_im = G[n_k:, :n_k] - G[:n_k, n_k:]
        out.append((g, torch.complex(rho_re, rho_im)))
    return out


def rdm_blocks(state, keep):
    """The RDM over ``keep`` (a strictly increasing tuple) as diagonal
    blocks on the device: [(positions, rho_block)], positions the numpy rows
    of the 2^k x 2^k matrix the complex128 block occupies (one block of
    every row for Full/Parity; one per kept weight for SpinConserve). With a
    process group up the rows are gathered to rank 0, and the other ranks
    get None."""
    from .. import subspaces as sp
    from . import sectors

    keep = tuple(map(int, keep))
    data = multihost.gather_rows(state.data, to_all=False, dim=len(state))
    if data is None:
        return None
    sub = state.subspace
    if isinstance(sub, sp.SpinConserve):
        return [(sectors.states_of_popcount(len(keep), g), rho)
                for g, rho in _spinconserve_rhos(data, sub, keep)]
    return [(np.arange(1 << len(keep)), _full_rho(data, sub, keep))]


def rdm_device(state, keep):
    """The RDM as a host complex128 (2^k, 2^k) array, computed on the
    device; only the blocks travel to the host."""
    blocks = rdm_blocks(state, keep)
    rho = None
    if blocks is not None:
        n = 1 << len(keep)
        rho = np.zeros((n, n), dtype=np.complex128)
        for pos, block in blocks:
            rho[np.ix_(pos, pos)] = block.cpu().numpy()
    return multihost.broadcast_from_host0(rho)


def rdm_spectrum(state, keep):
    """The eigenvalues of the RDM (host float64, ascending), computed on the
    device block by block (``torch.linalg.eigvalsh`` in complex128): the
    spectrum of a block-diagonal matrix is the union of its blocks'."""
    blocks = rdm_blocks(state, keep)
    w = None
    if blocks is not None:
        w = torch.cat([torch.linalg.eigvalsh(block) for _pos, block in blocks])
        w = np.sort(w.cpu().numpy())
    return multihost.broadcast_from_host0(w)


def rdm_host(state, keep):
    """Compute the RDM on the host from a gathered state vector."""
    from .. import subspaces as sp

    L = state.L
    keep = np.asarray(keep, dtype=np.int64)
    amps = state.to_numpy()

    if isinstance(state.subspace, sp.Full):
        full = amps
    else:
        full = np.zeros(1 << L, dtype=np.complex128)
        dim = len(amps)
        block = 1 << 16
        for start in range(0, dim, block):
            stop = min(dim, start + block)
            states = state.subspace.idx_to_state(np.arange(start, stop))
            full[states] = amps[start:stop]

    return rdm_from_full_vector(full, keep, L)


def rdm_from_full_vector(full, keep, L):
    """rho = Tr_traced |psi><psi| for a full-space vector."""
    keep = list(map(int, keep))
    traced = [i for i in range(L) if i not in keep]
    k = len(keep)

    # tensor axis a corresponds to bit (L-1-a); put kept bits leading,
    # most-significant kept bit first
    tensor = full.reshape([2] * L)
    perm = ([L - 1 - b for b in reversed(keep)]
            + [L - 1 - b for b in reversed(traced)])
    V = np.transpose(tensor, perm).reshape(1 << k, 1 << (L - k))
    return V @ V.conj().T
