// The XOR-mode Pauli-string matvec y = H x for Full/Parity subspace pairs,
// hand-written for Hopper (sm_90a), in float and double, on one device or
// on one rank's block of rows.
//
// Replaces: dynamite_tpu/ops/pallas_apply.py::_build_call (the Pallas TPU
// kernel), on both of its routes: build_pallas_apply (one device, with its
// precomputed diagonal stream from compute_diagonal) and
// build_pallas_sharded_parts (each device's local block inside shard_map,
// one source operand per device mask and a runtime +-1 vector of device
// sign parities).
//
// What it computes, for every row j of a block of local_dim rows starting
// at global row row0, over (2, local_dim) re/im planes:
//
//   k    = row0 + j
//   y[j] = sum over mask groups g of f_g(k) * src[src_idx[g]][j ^ m_lo[g]]
//   f_g(k) = sum over the group's terms t of c_t * (-1)^parity(k & s_t)
//
// The host splits each group's permutation mask m' into m_hi = m' >>
// local_bits, which picks the source block (the partner rank's rows, row0 ^
// m_hi << local_bits), and m_lo, which permutes inside it; (s_t, c_t) are
// the effective sign masks and coefficients (xor_apply.py folds the Parity
// sector's sign structure into them). The sign is taken on the global row
// k, so the TPU kernel's device-sign vector is not needed. One device is
// the case of one source, row0 = 0 and m_lo = m'. The mask-0 group is the
// diagonal and is handled in the same pass, so no diagonal stream is read.
//
// Design: one thread per output row, 64-bit row index. The CSR group/term
// tables, and each group's source pointer, are staged in shared memory once
// per block; the source pointers come by value in a struct (at most
// kMaxSources), so no device array of pointers exists. The Walsh sign is
// one __popc on the xor of the two 32-bit halves of k & s_t (the TPU kernel
// had no scalar popcount and factored the sign into host +-1 tables
// instead). Reads stay coalesced: j ^ m_lo permutes within aligned
// segments, so a warp reads whole sectors of the source plane.
//
// What bounds it: the per-row term loop (integer and, popc, branch, two
// adds per term), not device-memory bytes -- float64 runs about as fast as
// float32 at L=24 (PERF.md). Sharing the sign work across rows is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSources = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
struct Sources {
  const T* ptr[kMaxSources];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
xor_apply_kernel(Sources<T> srcs, T* __restrict__ y, int64_t local_dim,
                 int64_t row0, int n_groups, int n_terms,
                 const int64_t* __restrict__ group_mask,
                 const int32_t* __restrict__ group_src,
                 const int32_t* __restrict__ group_start,
                 const int64_t* __restrict__ term_s,
                 const T* __restrict__ term_cr,
                 const T* __restrict__ term_ci) {
  // layout: m_lo (G int64), source pointers (G), signs (T int64), cr (T),
  // ci (T), starts (G+1 int32) -- widest types first, so every array stays
  // aligned
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_mask = reinterpret_cast<int64_t*>(smem);
  const T** s_src = reinterpret_cast<const T**>(s_mask + n_groups);
  int64_t* s_sign = reinterpret_cast<int64_t*>(s_src + n_groups);
  T* s_cr = reinterpret_cast<T*>(s_sign + n_terms);
  T* s_ci = s_cr + n_terms;
  int32_t* s_start = reinterpret_cast<int32_t*>(s_ci + n_terms);

  for (int i = threadIdx.x; i < n_groups; i += blockDim.x) {
    s_mask[i] = group_mask[i];
    s_src[i] = srcs.ptr[group_src[i]];
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

  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= local_dim) return;
  const int64_t k = row0 + j;

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
    const T* src = s_src[g];
    const int64_t col = j ^ s_mask[g];
    const T xr = __ldg(src + col);
    const T xi = __ldg(src + local_dim + col);
    acc_r += fr * xr - fi * xi;
    acc_i += fr * xi + fi * xr;
  }
  y[j] = acc_r;
  y[local_dim + j] = acc_i;
}

template <typename T>
int launch(const void* const* src_ptrs, int n_srcs, T* y,
           long long local_dim, long long row0, int n_groups, int n_terms,
           const long long* group_mask, const int* group_src,
           const int* group_start, const long long* term_s,
           const T* term_cr, const T* term_ci, void* stream) {
  if (n_srcs < 0 || n_srcs > kMaxSources || local_dim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Sources<T> srcs{};
  for (int i = 0; i < n_srcs; ++i) {
    srcs.ptr[i] = static_cast<const T*>(src_ptrs[i]);
  }
  const size_t smem = sizeof(int64_t) * (2 * n_groups + n_terms) +
                      2 * sizeof(T) * n_terms +
                      sizeof(int32_t) * (n_groups + 1);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        xor_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (local_dim + kThreads - 1) / kThreads;
  xor_apply_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      srcs, y, static_cast<int64_t>(local_dim), static_cast<int64_t>(row0),
      n_groups, n_terms, reinterpret_cast<const int64_t*>(group_mask),
      reinterpret_cast<const int32_t*>(group_src),
      reinterpret_cast<const int32_t*>(group_start),
      reinterpret_cast<const int64_t*>(term_s), term_cr, term_ci);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry points (loaded with ctypes). src_ptrs is a host array of
// n_srcs device pointers, each to a (2, local_dim) block. Each launches on
// the given stream, does not synchronize, and returns cudaGetLastError().
int xor_apply_f32(const void* const* src_ptrs, int n_srcs, float* y,
                  long long local_dim, long long row0, int n_groups,
                  int n_terms, const long long* group_mask,
                  const int* group_src, const int* group_start,
                  const long long* term_s, const float* term_cr,
                  const float* term_ci, void* stream) {
  return launch<float>(src_ptrs, n_srcs, y, local_dim, row0, n_groups,
                       n_terms, group_mask, group_src, group_start, term_s,
                       term_cr, term_ci, stream);
}

int xor_apply_f64(const void* const* src_ptrs, int n_srcs, double* y,
                  long long local_dim, long long row0, int n_groups,
                  int n_terms, const long long* group_mask,
                  const int* group_src, const int* group_start,
                  const long long* term_s, const double* term_cr,
                  const double* term_ci, void* stream) {
  return launch<double>(src_ptrs, n_srcs, y, local_dim, row0, n_groups,
                        n_terms, group_mask, group_src, group_start, term_s,
                        term_cr, term_ci, stream);
}

const char* xor_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
