"""
API-parity shim: the reference exposes MSC manipulation as
``dynamite.msc_tools``; here the implementation lives in
:mod:`dynamite_tpu_torch.ops.msc` and is re-exported under the familiar names.
"""

from .ops.msc import (
    msc_dtype,
    msc_from_arrays,
    as_msc,
    msc_sum,
    msc_product,
    combine_terms,
    combine_terms as combine_and_sort,  # reference name
    truncate,
    shift,
    is_hermitian,
    max_spin_idx,
    nnz_per_row,
    nnz_per_row as nnz,  # reference name
    mask_groups,
    msc_to_matrix,
    msc_to_matrix as msc_to_numpy,  # reference name
    serialize,
    deserialize,
    table,
)

# the host-side integer dtype used for masks/signs
import numpy as np
dnm_int_t = np.int64
