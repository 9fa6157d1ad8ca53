// Breadth-first discovery of the symmetry sector that holds a seed state,
// on the host: the port's copy of the JAX package's bfs_sector
// (dynamite_tpu/_native/native.cpp). BFS is sequential frontier expansion
// over a hash set, so it stays in C++ on the CPU, as the reference keeps
// its compute_rcm BFS in Cython (bsubspace.pyx:212-261).
//
// Plain C interface, loaded with ctypes by dynamite_tpu_torch/_native.py,
// which builds this file with g++ -O3 -shared -fPIC at first use.

#include <cstddef>
#include <cstdint>
#include <unordered_set>

extern "C" {

// An edge state -> state ^ mask exists when the mask group's total
// coefficient sum_t (-1)^parity(state & sign_t) * coeff_t is nonzero.
// States are written in queue (discovery) order. Returns the number of
// states found, or -1 once out_capacity is exceeded (the caller retries
// with more room).
//
// group_masks: ngroups masks; group_offsets: ngroups + 1 offsets into the
// per-term arrays signs, coeffs_re, coeffs_im.
int64_t bfs_sector(
    const int64_t* group_masks,
    const int64_t* group_offsets,
    int64_t ngroups,
    const int64_t* signs,
    const double* coeffs_re,
    const double* coeffs_im,
    int64_t seed,
    int64_t* out_states,
    int64_t out_capacity)
{
    if (out_capacity < 1) return -1;
    std::unordered_set<int64_t> seen;
    seen.reserve((std::size_t)out_capacity * 2);
    out_states[0] = seed;
    seen.insert(seed);
    int64_t n_found = 1;

    for (int64_t qi = 0; qi < n_found; ++qi) {
        const uint64_t state = (uint64_t)out_states[qi];
        for (int64_t g = 0; g < ngroups; ++g) {
            double tot_re = 0.0, tot_im = 0.0;
            for (int64_t t = group_offsets[g]; t < group_offsets[g + 1];
                 ++t) {
                const double sgn =
                    __builtin_parityll(state & (uint64_t)signs[t]) ? -1.0
                                                                   : 1.0;
                tot_re += sgn * coeffs_re[t];
                tot_im += sgn * coeffs_im[t];
            }
            if (tot_re == 0.0 && tot_im == 0.0) continue;
            const int64_t edge = (int64_t)(state ^ (uint64_t)group_masks[g]);
            if (seen.insert(edge).second) {
                if (n_found >= out_capacity) return -1;
                out_states[n_found++] = edge;
            }
        }
    }
    return n_found;
}

}  // extern "C"
