// The ELL matvec of the general subspace engine, for Hopper (sm_90a):
//
//     y[:, r] = sum_g (fr[g, r] + i fi[g, r]) * x[:, cols[g, r]]
//
// over (2, dim) re/im planes in float32 or float64, with (G, rows) tables
// built on the device by dynamite_tpu_torch/ops/ell.py::build_tables.
//
// Replaces: dynamite_tpu/ops/ell.py:252 make_apply, the XLA lax.scan of
// x[:, cols] gathers and einsums that the JAX package reaches from
// OperatorKernel._try_ell_local (dynamite_tpu/ops/apply.py:459). It is not
// a Pallas kernel; it gets a kernel here because a chain of torch ops would
// be bound by launches on the card, as the sector engine is.
//
// Bound: bytes. Each apply streams the tables once (an index and one or two
// coefficients per row and group), reads x and writes y, at 3.35 TB/s; the
// arithmetic is 4 (8 with fi) flops per table entry. For localized(24) on
// Auto(24) (24 groups, 2,704,156 rows, real coefficients) that is 519 MB of
// tables and 43 MB of x and y in float32, about 0.17 ms.
//
// Design, simple first: one thread per row, a grid-stride loop over rows;
// each thread walks the G groups in order, reading cols, fr (and fi)
// coalesced across the warp from the (G, rows) layout, gathers both planes
// of x[col], sums in registers in the working type and writes y once.
// Nothing is atomic and the order of the sum over g is fixed. A template
// flag drops every fi read for real operators.
//
// Plain C interface, loaded with ctypes (dynamite_tpu_torch/ops/ell.py);
// built with nvcc -gencode arch=compute_90a,code=sm_90a -shared.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

template <typename T, typename I, bool kImag>
__global__ void __launch_bounds__(kThreads)
ell_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const I* __restrict__ cols, const T* __restrict__ fr,
                 const T* __restrict__ fi, int64_t rows, int64_t dim_right,
                 int groups)
{
    const T* __restrict__ xr = x;
    const T* __restrict__ xi = x + dim_right;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < rows;
         r += stride) {
        T yr = 0, yi = 0;
#pragma unroll 4
        for (int g = 0; g < groups; ++g) {
            const int64_t e = (int64_t)g * rows + r;
            const int64_t c = (int64_t)cols[e];
            const T a = fr[e];
            const T vr = xr[c];
            const T vi = xi[c];
            yr = fma(a, vr, yr);
            yi = fma(a, vi, yi);
            if (kImag) {
                const T b = fi[e];
                yr = fma(-b, vi, yr);
                yi = fma(b, vr, yi);
            }
        }
        y[r] = yr;
        y[rows + r] = yi;
    }
}

template <typename T, typename I, bool kImag>
int launch(const void* x, void* y, const void* cols, const void* fr,
           const void* fi, int64_t rows, int64_t dim_right, int groups,
           cudaStream_t stream)
{
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    const int64_t need = (rows + kThreads - 1) / kThreads;
    const int64_t cap = (int64_t)sms * kBlocksPerSm;
    const unsigned blocks = (unsigned)(need < cap ? need : cap);
    ell_apply_kernel<T, I, kImag><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<const I*>(cols), static_cast<const T*>(fr),
        static_cast<const T*>(fi), rows, dim_right, groups);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int idx64, int has_fi, const void* x, void* y, const void* cols,
             const void* fr, const void* fi, int64_t rows, int64_t dim_right,
             int groups, cudaStream_t stream)
{
    if (idx64) {
        return has_fi ? launch<T, int64_t, true>(x, y, cols, fr, fi, rows,
                                                 dim_right, groups, stream)
                      : launch<T, int64_t, false>(x, y, cols, fr, fi, rows,
                                                  dim_right, groups, stream);
    }
    return has_fi ? launch<T, int32_t, true>(x, y, cols, fr, fi, rows,
                                             dim_right, groups, stream)
                  : launch<T, int32_t, false>(x, y, cols, fr, fi, rows,
                                              dim_right, groups, stream);
}

}  // namespace

extern "C" {

// is_f64: float64 planes and tables (else float32); idx64: int64 columns
// (else int32); has_fi: read the imaginary table. Returns the CUDA error
// code of the launch (0 on success).
int ell_apply_launch(int is_f64, int idx64, int has_fi, const void* x,
                     void* y, const void* cols, const void* fr,
                     const void* fi, int64_t rows, int64_t dim_right,
                     int groups, void* stream)
{
    if (rows <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_f64)
        return dispatch<double>(idx64, has_fi, x, y, cols, fr, fi, rows,
                                dim_right, groups, s);
    return dispatch<float>(idx64, has_fi, x, y, cols, fr, fi, rows,
                           dim_right, groups, s);
}

const char* ell_apply_error_string(int err)
{
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
