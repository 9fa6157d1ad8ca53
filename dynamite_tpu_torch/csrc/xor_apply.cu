// The XOR-mode Pauli-string matvec y = H x for Full/Parity subspace pairs,
// hand-written for Hopper (sm_90a), in float and double.
//
// Replaces: dynamite_tpu/ops/pallas_apply.py::_build_call (the Pallas TPU
// kernel, reached through build_pallas_apply), including its precomputed
// diagonal stream (compute_diagonal).
//
// What it computes, for every row k of the (2, dim) re/im planes:
//
//   y[k] = sum over mask groups g of f_g(k) * x[k ^ m_g]
//   f_g(k) = sum over the group's terms t of c_t * (-1)^parity(k & s_t)
//
// m_g is the permutation mask in index space and (s_t, c_t) the effective
// sign mask and coefficient of each term (the host plan in xor_apply.py
// folds the Parity sector's sign structure into them). The mask-0 group is
// the diagonal and is handled in the same pass, so no diagonal stream is
// read.
//
// Design: one thread per output row, 64-bit row index. The CSR group/term
// tables are staged in shared memory once per block. The Walsh sign is one
// __popc on the xor of the two 32-bit halves of k & s_t (the TPU kernel had
// no scalar popcount and factored the sign into host +-1 tables instead).
// Reads stay coalesced: k ^ m_g permutes within aligned segments, so a warp
// reads whole sectors of the source plane.
//
// What bounds it: device-memory bytes. This simple form reads both planes
// of x once per group and writes y once, about
// (groups + 1) x 2 planes x sizeof(T) x dim bytes per apply; low-bit masks
// hit the same cache lines and L2 absorbs part of it. Reusing one source
// tile across groups is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
xor_apply_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t dim,
                 int n_groups, int n_terms,
                 const int64_t* __restrict__ group_mask,
                 const int32_t* __restrict__ group_start,
                 const int64_t* __restrict__ term_s,
                 const T* __restrict__ term_cr,
                 const T* __restrict__ term_ci) {
  // layout: masks (G int64), signs (T int64), cr (T), ci (T), starts
  // (G+1 int32) -- widest types first, so every array stays aligned
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_mask = reinterpret_cast<int64_t*>(smem);
  int64_t* s_sign = s_mask + n_groups;
  T* s_cr = reinterpret_cast<T*>(s_sign + n_terms);
  T* s_ci = s_cr + n_terms;
  int32_t* s_start = reinterpret_cast<int32_t*>(s_ci + n_terms);

  for (int i = threadIdx.x; i < n_groups; i += blockDim.x) {
    s_mask[i] = group_mask[i];
  }
  for (int i = threadIdx.x; i <= n_groups; i += blockDim.x) {
    s_start[i] = group_start[i];
  }
  for (int i = threadIdx.x; i < n_terms; i += blockDim.x) {
    s_sign[i] = term_s[i];
    s_cr[i] = term_cr[i];
    s_ci[i] = term_ci[i];
  }
  __syncthreads();

  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= dim) return;

  T acc_r = T(0);
  T acc_i = T(0);
  for (int g = 0; g < n_groups; ++g) {
    T fr = T(0);
    T fi = T(0);
    const int t_end = s_start[g + 1];
    for (int t = s_start[g]; t < t_end; ++t) {
      const uint64_t ks = static_cast<uint64_t>(k & s_sign[t]);
      const unsigned int folded = static_cast<unsigned int>(ks) ^
                                  static_cast<unsigned int>(ks >> 32);
      if (__popc(folded) & 1) {
        fr -= s_cr[t];
        fi -= s_ci[t];
      } else {
        fr += s_cr[t];
        fi += s_ci[t];
      }
    }
    const int64_t src = k ^ s_mask[g];
    const T xr = x[src];
    const T xi = x[dim + src];
    acc_r += fr * xr - fi * xi;
    acc_i += fr * xi + fi * xr;
  }
  y[k] = acc_r;
  y[dim + k] = acc_i;
}

template <typename T>
int launch(const T* x, T* y, long long dim, int n_groups, int n_terms,
           const long long* group_mask, const int* group_start,
           const long long* term_s, const T* term_cr, const T* term_ci,
           void* stream) {
  const size_t smem = sizeof(int64_t) * (n_groups + n_terms) +
                      2 * sizeof(T) * n_terms +
                      sizeof(int32_t) * (n_groups + 1);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        xor_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (dim + kThreads - 1) / kThreads;
  xor_apply_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<int64_t>(dim), n_groups, n_terms,
      reinterpret_cast<const int64_t*>(group_mask),
      reinterpret_cast<const int32_t*>(group_start),
      reinterpret_cast<const int64_t*>(term_s), term_cr, term_ci);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronize, and returns cudaGetLastError().
int xor_apply_f32(const float* x, float* y, long long dim, int n_groups,
                  int n_terms, const long long* group_mask,
                  const int* group_start, const long long* term_s,
                  const float* term_cr, const float* term_ci, void* stream) {
  return launch<float>(x, y, dim, n_groups, n_terms, group_mask, group_start,
                       term_s, term_cr, term_ci, stream);
}

int xor_apply_f64(const double* x, double* y, long long dim, int n_groups,
                  int n_terms, const long long* group_mask,
                  const int* group_start, const long long* term_s,
                  const double* term_cr, const double* term_ci,
                  void* stream) {
  return launch<double>(x, y, dim, n_groups, n_terms, group_mask,
                        group_start, term_s, term_cr, term_ci, stream);
}

const char* xor_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
