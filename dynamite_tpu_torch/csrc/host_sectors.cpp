// Host-side batch maps of the SpinConserve basis and a batch parity: the
// port's copy of the JAX package's spinconserve_s2i, spinconserve_i2s and
// parity_and (dynamite_tpu/_native/native.cpp). The layout is the
// sector-major order of ops/sectors.py: states sorted by (top bit t,
// popcount kr of the rest bits [La, L-1), rank of the rest, rank of the low
// bits [0, La)), each rank the value-order combinatorial rank among strings
// of the same popcount.
//
// Plain C interface, loaded with ctypes by dynamite_tpu_torch/_native.py,
// which builds this file with g++ -O3 -shared -fPIC at first use and checks
// every table's length before a call.

#include <cstdint>

namespace {

// Value-order rank of a bitstring among those of its popcount; nchoosek is
// the (k + 1) x (L + 1) table C(n, kk) at [kk * ld + n].
inline int64_t rank_half(uint64_t s, const int64_t* nchoosek, int64_t ld)
{
    int64_t idx = 0, kk = 0;
    while (s) {
        const int nbit = __builtin_ctzll(s);
        ++kk;
        if (kk <= nbit) idx += nchoosek[kk * ld + nbit];
        s &= s - 1;
    }
    return idx;
}

// Inverse of rank_half: the nbits-bit string of popcount kk with rank idx
// (0 <= idx < C(nbits, kk), which the caller guarantees).
inline uint64_t unrank_half(int64_t idx, int64_t kk, int64_t nbits,
                            const int64_t* nchoosek, int64_t ld)
{
    uint64_t state = 0;
    for (int64_t nbit = nbits; nbit > 0; --nbit) {
        state <<= 1;
        const int64_t current =
            (kk > nbit - 1) ? 0 : nchoosek[kk * ld + (nbit - 1)];
        if (idx >= current) {
            idx -= current;
            --kk;
            state |= 1;
        }
    }
    return state;
}

}  // namespace

extern "C" {

// State -> index for SpinConserve(L, k). off_tk / na_tk are the sector
// offset and row length by slot t * (Lr + 1) + kr, Lr = L - La - 1. A state
// outside [0, 2^L) or of another popcount than k maps to -1.
void spinconserve_s2i(
    const int64_t* states, int64_t n,
    int64_t L, int64_t k,
    const int64_t* nchoosek,
    int64_t La,
    const int64_t* off_tk,
    const int64_t* na_tk,
    int64_t* out_idxs)
{
    const int64_t ld = L + 1;
    const int64_t Lr = L - La - 1;
    const uint64_t amask = (1ull << La) - 1;
    const uint64_t rmask = (1ull << Lr) - 1;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t s = (uint64_t)states[i];
        if ((s >> L) != 0 || __builtin_popcountll(s) != k) {
            out_idxs[i] = -1;
            continue;
        }
        const int64_t t = (int64_t)((s >> (L - 1)) & 1);
        const uint64_t hr = (s >> La) & rmask;
        const int64_t slot = t * (Lr + 1) + __builtin_popcountll(hr);
        out_idxs[i] = off_tk[slot]
            + rank_half(hr, nchoosek, ld) * na_tk[slot]
            + rank_half(s & amask, nchoosek, ld);
    }
}

// Index -> state for SpinConserve(L, k), every index in [0, C(L, k)).
// sec_* are the sectors' offset, top bit, rest popcount, low popcount and
// row length, in index order.
void spinconserve_i2s(
    const int64_t* idxs, int64_t n,
    int64_t L, int64_t k,
    const int64_t* nchoosek,
    int64_t La,
    const int64_t* sec_off,
    const int64_t* sec_t,
    const int64_t* sec_kr,
    const int64_t* sec_ka,
    const int64_t* sec_na,
    int64_t n_sectors,
    int64_t* out_states)
{
    const int64_t ld = L + 1;
    const int64_t Lr = L - La - 1;
    (void)k;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t idx = idxs[i];
        // the last sector that starts at or before idx
        int64_t lo = 0, hi = n_sectors - 1;
        while (lo < hi) {
            const int64_t mid = (lo + hi + 1) >> 1;
            if (sec_off[mid] <= idx) lo = mid; else hi = mid - 1;
        }
        const int64_t rem = idx - sec_off[lo];
        const int64_t rb = rem / sec_na[lo];
        const int64_t ra = rem - rb * sec_na[lo];
        const uint64_t hr = unrank_half(rb, sec_kr[lo], Lr, nchoosek, ld);
        const uint64_t sa = unrank_half(ra, sec_ka[lo], La, nchoosek, ld);
        out_states[i] = (int64_t)(((uint64_t)sec_t[lo] << (L - 1))
                                  | (hr << La) | sa);
    }
}

// out[i] = parity(x[i] & sign).
void parity_and(const int64_t* x, int64_t n, int64_t sign, uint8_t* out)
{
    for (int64_t i = 0; i < n; ++i)
        out[i] = (uint8_t)__builtin_parityll((uint64_t)x[i] & (uint64_t)sign);
}

}  // extern "C"
