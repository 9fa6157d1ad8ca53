// The ELL matvec of the general subspace engine, for Hopper (sm_90a):
//
//     y[:, r] = sum_j (fr[e] + i fi[e]) * x[:, cols[e]],  e = e(r, j)
//
// over (2, dim) re/im planes in float32 or float64, with sliced ELL tables
// (SELL-32) built on the device by dynamite_tpu_torch/ops/ell.py
// (build_packed: build_tables' rows, packed by pack_tables): slice s holds
// the lanes_s rows from 32s (32, the last slice the rows left) in width_s =
// (slice_ptr[s + 1] - slice_ptr[s]) / lanes_s steps, entry j of row 32s + l
// at slice_ptr[s] + lanes_s j + l, each row's nonzero entries in ascending
// mask-group order, shorter rows padded with column 0 and coefficient 0.
//
// Replaces: dynamite_tpu/ops/ell.py:252 make_apply, the XLA lax.scan of
// x[:, cols] gathers and einsums that the JAX package reaches from
// OperatorKernel._try_ell_local (dynamite_tpu/ops/apply.py:459). It is not
// a Pallas kernel; it gets a kernel here because a chain of torch ops would
// be bound by launches on the card, as the sector engine is.
//
// Bound: bytes, counted on nonzeros, whatever the format: an index and one
// coefficient (two with fi) per nonzero, x read once and y written once,
// at 3.35 TB/s. For localized(24) on Auto(24) (35,154,028 nonzeros,
// 2,704,156 rows, real coefficients) that is 0.0969 ms in float32 and
// 0.1518 ms in float64. The arithmetic is 4 (8 with fi) flops a nonzero.
//
// What the design does about it:
// 1. No padding streamed: the (G, rows) tables of that operator hold 46%
//    zeros (partners outside the subspace); the slices keep each row's
//    nonzeros and pad only to their widest row (1.17x nnz there). One warp
//    takes a slice, one lane a row, in a grid-stride loop over slices; the
//    loop over a slice's width is uniform across the warp (but for the
//    last slice's missing rows), each step reads 128 B (float32) of each
//    table, coalesced, and y is written once.
// 2. The tables stream past L2: they are read with the evict-first,
//    streaming hint (__ldcs), and x through the read-only path with an
//    L2 evict-last policy (createpolicy, ld.global.nc.L2::cache_hint), so
//    the 330-650 MB of tables do not wash out the 21.6 / 43 MB vector that
//    every entry gathers from. No device-global L2 setting and no stream
//    attribute is touched.
// 3. Memory-level parallelism: a lane starts the table loads of kUnroll
//    entries, then their gathers of x, then the sums, in ascending order
//    into one accumulator (the order of the plain version). kUnroll = 4
//    and a register cap (kMinBlocks: 6 blocks an SM in float32, 3 in
//    float64) keep 48 (24) warps an SM in flight; chip_smoke.py's ptxas
//    lines give the registers.
//
// x stays in its two planes, two gathers an entry: an interleaved (re, im)
// copy made by a pre-pass gathers one pair instead, but was slower on every
// case measured, as was the same kernel without the cache hints (PERF.md,
// section 6).
//
// Dropping the zero entries changes only how a non-finite x[0] reaches the
// rows that the (G, rows) tables padded: for finite x, fma(0, v, y) == y,
// so the result equals the padded tables' sum up to the sign of zero.
//
// Plain C interface, loaded with ctypes (dynamite_tpu_torch/ops/ell.py);
// built with nvcc -gencode arch=compute_90a,code=sm_90a -shared.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;      // rows per slice: one warp, a lane a row
constexpr int kThreads = 256;   // eight warps a block
constexpr int kUnroll = 4;      // entries a lane has in flight

// resident blocks an SM that the register cap aims at
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 3;

__device__ __forceinline__ uint64_t evict_last_policy()
{
    uint64_t policy;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
    return policy;
}

// x: read-only path, L2 evict-last
__device__ __forceinline__ float load_x(const float* p, uint64_t policy)
{
    float v;
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v) : "l"(p), "l"(policy));
    return v;
}

__device__ __forceinline__ double load_x(const double* p, uint64_t policy)
{
    double v;
    asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
        : "=d"(v) : "l"(p), "l"(policy));
    return v;
}

// tables: streamed (evict-first)
__device__ __forceinline__ float load_t(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double load_t(const double* p)
{
    return __ldcs(p);
}
__device__ __forceinline__ int32_t load_t(const int32_t* p)
{
    return __ldcs(p);
}
__device__ __forceinline__ int64_t load_t(const int64_t* p)
{
    return __ldcs(reinterpret_cast<const long long*>(p));
}

template <typename T, typename I, bool kImag>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
ell_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const long long* __restrict__ slice_ptr,
                 const I* __restrict__ cols, const T* __restrict__ fr,
                 const T* __restrict__ fi, int64_t rows, int64_t n_slices,
                 int64_t dim_right)
{
    const int lane = threadIdx.x % kSlice;
    const int64_t warps = (int64_t)gridDim.x * (kThreads / kSlice);
    const uint64_t policy = evict_last_policy();
    const T* __restrict__ xr = x;
    const T* __restrict__ xi = x + dim_right;
    for (int64_t s = (int64_t)blockIdx.x * (kThreads / kSlice)
                     + threadIdx.x / kSlice;
         s < n_slices; s += warps) {
        const int64_t begin = __ldg(slice_ptr + s);
        const int64_t left = rows - s * kSlice;
        const int lanes = left < kSlice ? (int)left : kSlice;
        if (lane >= lanes) continue;  // the last slice's missing rows
        const int width = (int)((__ldg(slice_ptr + s + 1) - begin) / lanes);
        const int64_t base = begin + lane;
        T yr = 0, yi = 0;
        for (int j = 0; j < width; j += kUnroll) {
            I c[kUnroll];
            T a[kUnroll], b[kUnroll], vr[kUnroll], vi[kUnroll];
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                if (j + k < width) {
                    const int64_t e = base + (int64_t)(j + k) * lanes;
                    c[k] = load_t(cols + e);
                    a[k] = load_t(fr + e);
                    if constexpr (kImag) b[k] = load_t(fi + e);
                }
            }
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                if (j + k < width) {
                    vr[k] = load_x(xr + c[k], policy);
                    vi[k] = load_x(xi + c[k], policy);
                }
            }
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                if (j + k < width) {
                    yr = fma(a[k], vr[k], yr);
                    yi = fma(a[k], vi[k], yi);
                    if constexpr (kImag) {
                        yr = fma(-b[k], vi[k], yr);
                        yi = fma(b[k], vr[k], yi);
                    }
                }
            }
        }
        const int64_t r = s * kSlice + lane;
        y[r] = yr;
        y[rows + r] = yi;
    }
}

template <typename T, typename I, bool kImag>
int launch(const void* x, void* y, const void* slice_ptr, const void* cols,
           const void* fr, const void* fi, int64_t rows, int64_t n_slices,
           int64_t dim_right, cudaStream_t stream)
{
    int device = 0, sms = 0;
    int err = (int)cudaGetDevice(&device);
    if (err != 0) return err;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
    if (err != 0) return err;
    // resident blocks an SM, once per instantiation: the grid fills the
    // card once and strides over the slices
    static int per_sm = 0;
    if (per_sm == 0) {
        err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ell_apply_kernel<T, I, kImag>, kThreads, 0);
        if (err != 0) return err;
    }
    const int64_t need = (n_slices + kThreads / kSlice - 1)
                         / (kThreads / kSlice);
    const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    ell_apply_kernel<T, I, kImag>
        <<<(unsigned)(need < cap ? need : cap), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const long long*>(slice_ptr),
        static_cast<const I*>(cols), static_cast<const T*>(fr),
        static_cast<const T*>(fi), rows, n_slices, dim_right);
    return (int)cudaGetLastError();
}

template <typename T, typename I>
int dispatch_imag(int has_fi, const void* x, void* y, const void* slice_ptr,
                  const void* cols, const void* fr, const void* fi,
                  int64_t rows, int64_t n_slices, int64_t dim_right,
                  cudaStream_t stream)
{
    return has_fi
        ? launch<T, I, true>(x, y, slice_ptr, cols, fr, fi, rows, n_slices,
                             dim_right, stream)
        : launch<T, I, false>(x, y, slice_ptr, cols, fr, fi, rows, n_slices,
                              dim_right, stream);
}

}  // namespace

extern "C" {

// is_f64: float64 planes and tables (else float32); idx64: int64 columns
// (else int32); has_fi: read the imaginary table. Returns the CUDA error
// code of the launch (0 on success).
int ell_apply_launch(int is_f64, int idx64, int has_fi, const void* x,
                     void* y, const void* slice_ptr, const void* cols,
                     const void* fr, const void* fi, int64_t rows,
                     int64_t n_slices, int64_t dim_right, void* stream)
{
    if (rows <= 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* f = is_f64
        ? (idx64 ? dispatch_imag<double, int64_t>
                 : dispatch_imag<double, int32_t>)
        : (idx64 ? dispatch_imag<float, int64_t>
                 : dispatch_imag<float, int32_t>);
    return f(has_fi, x, y, slice_ptr, cols, fr, fi, rows, n_slices,
             dim_right, st);
}

const char* ell_apply_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
