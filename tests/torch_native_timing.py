"""
Host seconds of SpinConserve's two index-map routes on the port: the numpy
layout (``dynamite_tpu_torch/ops/sectors.py``) and the C++ library
(``dynamite_tpu_torch/_native.py``, ``csrc/host_sectors.cpp``), over
batches of 1 to 65,536 random entries. Not collected by pytest.

    python tests/torch_native_timing.py [L ...]     # default: 12 20

Prints one line per (L, entries): the best of 5 repeats of 20 calls, in
microseconds a call, for state -> index and index -> state.
"""

import os
import sys
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dynamite_tpu_torch import _native, subspaces  # noqa: E402
from dynamite_tpu_torch.ops import sectors  # noqa: E402


def _us(fn):
    return min(timeit.repeat(fn, number=20, repeat=5)) / 20 * 1e6


def main(sizes):
    for L in sizes:
        sub = subspaces.SpinConserve(L, L // 2)
        lay = sub.sector_layout
        dim = sub.get_dimension()
        for n in (1, 16, 256, 1024, 8192, 65536):
            if n > dim:
                continue
            idx = np.random.default_rng(0).integers(0, dim, n)
            st = sectors.idx_to_state(lay, idx)
            times = (
                _us(lambda: sectors.state_to_idx(lay, st)),
                _us(lambda: _native.spinconserve_s2i(
                    st, L, sub.k, sub._nchoosek, lay.La, lay.off_tk,
                    lay.na_tk)),
                _us(lambda: sectors.idx_to_state(lay, idx)),
                _us(lambda: _native.spinconserve_i2s(
                    idx, L, sub.k, sub._nchoosek, lay.La, lay.off, lay.t,
                    lay.kr, lay.ka, lay.na)))
            print(f'L={L} entries={n}: s2i numpy {times[0]:.1f} C++ '
                  f'{times[1]:.1f} us, i2s numpy {times[2]:.1f} C++ '
                  f'{times[3]:.1f} us')


if __name__ == '__main__':
    main([int(a) for a in sys.argv[1:]] or [12, 20])
