// The XOR-mode Pauli-string matvec y = H x for Full/Parity subspace pairs,
// hand-written for Hopper (sm_90a), in float and double, on one device or
// on one rank's block of rows; and the kernel that builds its diagonal
// stream.
//
// Replaces: dynamite_tpu/ops/pallas_apply.py::_build_call (the Pallas TPU
// kernel), on both of its routes: build_pallas_apply (one device) and
// build_pallas_sharded_parts (each device's local block inside shard_map,
// one source operand per device mask and a runtime +-1 vector of device
// sign parities); and its diagonal stream, compute_diagonal (plain JAX).
//
// What it computes, for every row j of a block of local_dim rows starting
// at global row row0, over (2, local_dim) re/im planes:
//
//   k    = row0 + j
//   y[j] = d(k) x[j] + sum over mask groups g of f_g(k) src[src_g][j ^ m_lo_g]
//   f_g(k) = sum over the group's terms t of c_t (-1)^parity(k & s_t)
//
// d is the precomputed diagonal stream (the mask-0 group, once it has at
// least 4 terms; else mask 0 is an ordinary group and d is absent). m_lo is
// the part of a group's mask inside the block; the part above it picks the
// source block (the partner rank's rows).
//
// What bounds it. The kernel does a few flops per byte moved, far below the
// ridge of any unit, and its product is a gather with a per-row factor, not
// a matrix product, so tensor cores do not apply. The earlier design (one
// thread per row, every term of every group in the row loop: a 64-bit and,
// a fold, a popc, a branch and two adds each) spent ~1.3k instructions per
// row and ran at 5% of the bytes' bound (x read once, y written once). This
// one keeps out of the row loop what the TPU kernel kept out of its tiles
// (below). What bounds it then is the memory pipeline: every group gathers
// both planes of its partner rows once more (16 bytes a row in double),
// from L1 or L2 whether the partner lies in the tile or not, and the groups
// whose mask reaches the top bits of a vector larger than L2 read x again
// from device memory. `chip_smoke.py --group-costs` times one group by
// where its partners lie. The design:
//
// 1. The diagonal stream. d is built once per (operator, dtype, device,
//    layout) by xor_diagonal_kernel (below) and read beside x: one plane,
//    two only when a diagonal coefficient is complex.
// 2. Per-tile sign factoring. A block of threads covers an aligned tile of
//    2^tile_bits rows. The host splits every sign mask s into s_hi (bits >=
//    tile_bits) and s_lo and merges a group's terms that share s_lo into
//    slots. At the start of a tile its threads compute each slot's
//    coefficient C = sum_t c_t (-1)^parity(k_hi & s_hi_t) in shared memory,
//    from the tile's global high bits (so the rank bits of the sharded route
//    fall out of k_hi): one 64-bit popc per term per tile. The row loop runs
//    over slots with one 32-bit popc of (row offset in the tile) & s_lo.
// 3. R rows per thread (4 in float, 2 in double): each plane is one 16-byte
//    load per group. m_lo & (R - 1) permutes inside the vector; it is uniform
//    over the launch, so a switch picks a register renaming with no
//    divergence. The signs of the R rows differ only by the sign over the
//    bits of s_lo below R: the host sorts a group's slots into R classes by
//    s_lo & (R - 1), the loop sums each class once, and an R-point
//    Walsh-Hadamard butterfly (skipped for groups with one class) gives the
//    R row factors.
// 4. Groups whose coefficients are all real skip the imaginary factor (a
//    uniform branch on a host flag).
// 5. A tile skips a group whose slot coefficients are all 0 there: its
//    terms cancel over the tile's rows, as XX + YY on two sites above the
//    tile do in half the tiles. That saves half the partner reads of the
//    Heisenberg-type groups from other tiles, which come from L2 or, for
//    the top bits, from device memory.
//
// Reads stay coalesced: j ^ m_lo maps an aligned segment of a warp's rows
// onto another aligned segment. Every input comes by value in one XorArgs
// struct (at most kMaxSources source pointers), so no device array of
// pointers exists. The tables each tile needs are staged in shared memory;
// the terms, read once per tile to build the slot coefficients, come through
// the read-only cache.
//
// The diagonal stream, d(k) = sum over the mask-0 terms t of
// c_t (-1)^parity(k & s_t), replaces compute_diagonal
// (dynamite_tpu/ops/pallas_apply.py, plain JAX: one pass over the rows per
// term). Split a row of an aligned tile of 2^kDiagTileBits rows into its
// tile's high bits k_hi and its offset q in the tile. Then
//
//   d(k_hi + q) = sum_u g[u] (-1)^parity(q & u),
//   g[u] = sum over the terms with s_lo = u of c_t (-1)^parity(k_hi & s_hi),
//
// so the tile's diagonal is the Walsh-Hadamard transform of g. A block
// builds g for its tile (the terms' signs taken by all threads, one term
// each; each slot -- a distinct s_lo -- then summed in term order by the
// one thread that owns it: no atomics, the same order every run) and
// transforms it: log2(tile) adds a row, whatever the number of terms, plus
// the terms once per tile. What bounds it then is the bytes it writes. The
// transform runs in registers (16 entries a thread), by warp shuffles and
// through one shared-memory pass; each thread then stores its rows with
// 16-byte stores. A block smaller than a tile (a rank's block of fewer
// rows) transforms the aligned tile that holds it and stores its own rows,
// so the stream does not depend on the layout.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSources = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kComplex = 1;  // group flag: a coefficient has an imaginary part
constexpr int kMixed = 2;    // group flag: slots in more than sign class 0
// vectors of R rows per thread in a pass (see xor_apply_kernel; VECS in
// ops/xor_apply.py): 2 in float and in double
constexpr int kVecs = 2;
// the diagonal kernel's tile (DIAG_TILE_BITS in ops/xor_apply.py), threads
// and entries of the tile per thread
constexpr int kDiagTileBits = 12;
constexpr int kDiagThreads = 256;
constexpr int kDiagEntries = (1 << kDiagTileBits) / kDiagThreads;
// terms whose signs a block takes at a time (see xor_diagonal_kernel)
constexpr int kDiagChunk = 2048;

}  // namespace

extern "C" {

// Mirrored by ops/xor_apply.py::_XorArgs (ctypes); keep the two in step.
struct XorArgs {
  const void* src[kMaxSources];  // source blocks, each (2, local_dim)
  int32_t n_srcs;
  int32_t diag_src;     // index into src of the own block (m_hi = 0)
  void* y;              // output: (2, local_dim), or the diagonal's planes
  const void* diag;     // (diag_planes, local_dim), or null
  int32_t diag_planes;  // 0, 1 or 2
  int32_t tile_bits;
  int64_t local_dim;
  int64_t row0;
  int32_t rows_per_thread;
  int32_t n_groups;
  int32_t n_slots;
  int32_t pad;
  const int64_t* group_mlo;        // [G] the mask inside the block
  const int32_t* group_src;        // [G] index into src
  const int32_t* group_flags;      // [G] kComplex | kMixed
  const int32_t* class_start;      // [G*R + 1] slot ranges, per group and class
  const int32_t* slot_slo;         // [S] the sign mask below tile_bits
  const int32_t* slot_term_start;  // [S + 1] term ranges, per slot
  const int64_t* term_shi;         // [T] the sign mask from tile_bits up
  const void* term_cr;             // [T] coefficients, working type
  const void* term_ci;             // [T]
};

}  // extern "C"

namespace {

template <typename T, int R>
struct VecOf;
template <> struct VecOf<float, 1> { using type = float; };
template <> struct VecOf<float, 2> { using type = float2; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<double, 1> { using type = double; };
template <> struct VecOf<double, 2> { using type = double2; };

template <typename T, int R>
__device__ __forceinline__ void unpack(const typename VecOf<T, R>::type& w,
                                       T (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = w;
  } else if constexpr (R == 2) {
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
}

// R consecutive values from an R-aligned address, in one read-only load
template <typename T, int R>
__device__ __forceinline__ void load(const T* p, T (&v)[R]) {
  using V = typename VecOf<T, R>::type;
  unpack<T, R>(__ldg(reinterpret_cast<const V*>(p)), v);
}

// the same from shared memory
template <typename T, int R>
__device__ __forceinline__ void load_shared(const T* p, T (&v)[R]) {
  using V = typename VecOf<T, R>::type;
  unpack<T, R>(*reinterpret_cast<const V*>(p), v);
}

// R consecutive values to an R-aligned address, in one evict-first store
template <typename T, int R>
__device__ __forceinline__ void store(T* p, const T (&v)[R]) {
  using V = typename VecOf<T, R>::type;
  V w;
  if constexpr (R == 1) {
    w = v[0];
  } else if constexpr (R == 2) {
    w.x = v[0]; w.y = v[1];
  } else {
    w.x = v[0]; w.y = v[1]; w.z = v[2]; w.w = v[3];
  }
  __stcs(reinterpret_cast<V*>(p), w);
}

// f[r] = sum_p F[p] (-1)^parity(r & p), in place
template <typename T, int R>
__device__ __forceinline__ void walsh(T (&f)[R]) {
#pragma unroll
  for (int h = 1; h < R; h <<= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!(i & h)) {
        const T a = f[i];
        const T b = f[i + h];
        f[i] = a + b;
        f[i + h] = a - b;
      }
    }
  }
}

// Shared-memory tables of one tile, each entry one or two 16-byte loads:
// per group its source pointer and m_lo, then its flags and class ranges;
// per slot its coefficient and s_lo.
template <typename T>
struct alignas(16) GroupSource {
  const T* src;
  int64_t mlo;
};

template <int R>
struct alignas(16) GroupSlots {
  int32_t flags;
  int32_t start[R + 1];  // slots of class p: [start[p], start[p + 1])
};

template <typename T>
struct alignas(16) Slot {
  T cr;
  uint32_t slo;
  T ci;
};

template <typename T, int R>
struct Tile {
  GroupSource<T>* src;
  GroupSlots<R>* groups;
  Slot<T>* slots;

  __device__ Tile(unsigned char* smem, int G) {
    src = reinterpret_cast<GroupSource<T>*>(smem);
    groups = reinterpret_cast<GroupSlots<R>*>(src + G);
    slots = reinterpret_cast<Slot<T>*>(groups + G);
  }

  static size_t bytes(int G, int S) {
    return (sizeof(GroupSource<T>) + sizeof(GroupSlots<R>)) * G +
           sizeof(Slot<T>) * S;
  }
};

// Stage the tables and build the slot coefficients of the tile whose rows
// have global high bits k_hi; ends with a barrier.
template <typename T, int R>
__device__ void stage(const XorArgs& a, const Tile<T, R>& t, int G,
                      uint64_t k_hi) {
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    t.src[i].src = static_cast<const T*>(a.src[a.group_src[i]]);
    t.src[i].mlo = a.group_mlo[i];
    t.groups[i].flags = a.group_flags[i];
#pragma unroll
    for (int p = 0; p <= R; ++p) {
      t.groups[i].start[p] = a.class_start[i * R + p];
    }
  }
  const T* term_cr = static_cast<const T*>(a.term_cr);
  const T* term_ci = static_cast<const T*>(a.term_ci);
  for (int s = threadIdx.x; s < a.n_slots; s += blockDim.x) {
    T cr = T(0);
    T ci = T(0);
    const int end = __ldg(a.slot_term_start + s + 1);
    for (int i = __ldg(a.slot_term_start + s); i < end; ++i) {
      const uint64_t masked =
          k_hi & static_cast<uint64_t>(__ldg(a.term_shi + i));
      const T c_r = __ldg(term_cr + i);
      const T c_i = __ldg(term_ci + i);
      const bool odd = __popcll(masked) & 1;
      cr += odd ? -c_r : c_r;
      ci += odd ? -c_i : c_i;
    }
    t.slots[s].cr = cr;
    t.slots[s].ci = ci;
    t.slots[s].slo = static_cast<uint32_t>(a.slot_slo[s]);
  }
  __syncthreads();
  // a group whose terms cancel over the whole tile (XX + YY on two sites
  // above the tile, half the tiles) adds nothing: its source pointer
  // becomes null, and the tile skips its loads
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    bool idle = true;
    for (int s = t.groups[i].start[0]; s < t.groups[i].start[R]; ++s) {
      idle = idle && t.slots[s].cr == T(0) && t.slots[s].ci == T(0);
    }
    if (idle) t.src[i].src = nullptr;
  }
  __syncthreads();
}

// The row factors of group g for V vectors of R rows (rows q[v] .. q[v] +
// R - 1 of the tile, q[v] aligned to R): real parts in fr, imaginary parts
// in fi when the group is complex. Each slot is loaded once for the V
// vectors.
template <typename T, int R, int V>
__device__ __forceinline__ void group_factors(const Tile<T, R>& t, int g,
                                              const uint32_t (&q)[V],
                                              T (&fr)[V][R], T (&fi)[V][R]) {
  const GroupSlots<R> info = t.groups[g];
  const bool cplx = info.flags & kComplex;
  const bool mixed = info.flags & kMixed;
#pragma unroll
  for (int p = 0; p < R; ++p) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      fr[v][p] = T(0);
      fi[v][p] = T(0);
    }
    if (p > 0 && !mixed) continue;
    for (int s = info.start[p]; s < info.start[p + 1]; ++s) {
      const T c_r = t.slots[s].cr;
      const uint32_t slo = t.slots[s].slo;
      const T c_i = cplx ? t.slots[s].ci : T(0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool odd = __popc(q[v] & slo) & 1;
        fr[v][p] += odd ? -c_r : c_r;
        if (cplx) fi[v][p] += odd ? -c_i : c_i;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (mixed) {
      walsh<T, R>(fr[v]);
      if (cplx) walsh<T, R>(fi[v]);
    } else {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        fr[v][r] = fr[v][0];
        fi[v][r] = fi[v][0];
      }
    }
  }
}

// acc += f * x[r ^ P] over the R rows
template <typename T, int R, int P>
__device__ __forceinline__ void accumulate(T (&ar)[R], T (&ai)[R],
                                           const T (&fr)[R], const T (&fi)[R],
                                           const T (&xr)[R], const T (&xi)[R],
                                           bool cplx) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ar[r] += fr[r] * xr[r ^ P];
    ai[r] += fr[r] * xi[r ^ P];
  }
  if (cplx) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ar[r] -= fi[r] * xi[r ^ P];
      ai[r] += fi[r] * xr[r ^ P];
    }
  }
}

// Each thread takes V vectors of R rows, blockDim.x * R rows apart, so that
// every table entry a thread loads serves V * R rows.
template <typename T, int R, int V>
__global__ void __launch_bounds__(kThreads)
xor_apply_kernel(const XorArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.n_groups;
  const Tile<T, R> t(smem, G);
  const int64_t base = static_cast<int64_t>(blockIdx.x) << a.tile_bits;
  stage<T, R>(a, t, G, static_cast<uint64_t>(a.row0 + base));

  const int64_t n = a.local_dim;
  const uint32_t tile = 1u << a.tile_bits;
  const uint32_t stride = blockDim.x * R;
  for (uint32_t pass = 0; pass < tile; pass += stride * V) {
    // vectors of this pass inside the tile: the same for every thread
    const int nv = min(V, static_cast<int>((tile - pass) / stride));
    uint32_t q[V];
    int64_t j0[V];
    T ar[V][R], ai[V][R];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      q[v] = pass + v * stride + threadIdx.x * R;
      j0[v] = base + q[v];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ar[v][r] = T(0);
        ai[v][r] = T(0);
      }
    }
    if (a.diag_planes) {
      const T* x = static_cast<const T*>(a.src[a.diag_src]);
      const T* d = static_cast<const T*>(a.diag);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v >= nv) break;
        T xr[R], xi[R], dr[R];
        load<T, R>(x + j0[v], xr);
        load<T, R>(x + n + j0[v], xi);
        load<T, R>(d + j0[v], dr);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ar[v][r] = dr[r] * xr[r];
          ai[v][r] = dr[r] * xi[r];
        }
        if (a.diag_planes == 2) {
          T di[R];
          load<T, R>(d + n + j0[v], di);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            ar[v][r] -= di[r] * xi[r];
            ai[v][r] += di[r] * xr[r];
          }
        }
      }
    }

    for (int g = 0; g < G; ++g) {
      const GroupSource<T> gs = t.src[g];
      if (!gs.src) continue;  // idle in this tile: uniform over the block
      T xr[V][R], xi[V][R];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v < nv) {
          const int64_t col = j0[v] ^ (gs.mlo & ~static_cast<int64_t>(R - 1));
          load<T, R>(gs.src + col, xr[v]);
          load<T, R>(gs.src + n + col, xi[v]);
        }
      }
      T fr[V][R], fi[V][R];
      group_factors<T, R, V>(t, g, q, fr, fi);
      const bool cplx = t.groups[g].flags & kComplex;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (v >= nv) break;
        switch (static_cast<int>(gs.mlo & (R - 1))) {
          case 0:
            accumulate<T, R, 0>(ar[v], ai[v], fr[v], fi[v], xr[v], xi[v], cplx);
            break;
          case 1:
            if constexpr (R > 1)
              accumulate<T, R, 1>(ar[v], ai[v], fr[v], fi[v], xr[v], xi[v],
                                  cplx);
            break;
          case 2:
            if constexpr (R > 2)
              accumulate<T, R, 2>(ar[v], ai[v], fr[v], fi[v], xr[v], xi[v],
                                  cplx);
            break;
          default:
            if constexpr (R > 3)
              accumulate<T, R, 3>(ar[v], ai[v], fr[v], fi[v], xr[v], xi[v],
                                  cplx);
            break;
        }
      }
    }
    T* y = static_cast<T*>(a.y);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v >= nv) break;
      store<T, R>(y + j0[v], ar[v]);
      store<T, R>(y + n + j0[v], ai[v]);
    }
  }
}

template <typename T, int R>
int launch_as(const XorArgs& a, cudaStream_t stream) {
  const size_t smem = Tile<T, R>::bytes(a.n_groups, a.n_slots);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(xor_apply_kernel<T, R, kVecs>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = static_cast<int>(
      std::min<int64_t>(kThreads, (int64_t(1) << a.tile_bits) / R));
  const long long blocks = a.local_dim >> a.tile_bits;
  xor_apply_kernel<T, R, kVecs>
      <<<static_cast<unsigned int>(blocks), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const XorArgs* a, void* stream) {
  const int R = a->rows_per_thread;
  const int64_t tile = int64_t(1) << a->tile_bits;
  if (a->n_srcs < 0 || a->n_srcs > kMaxSources || a->local_dim < 1 ||
      a->tile_bits < 0 || a->tile_bits > 30 || a->local_dim % tile ||
      tile % R || a->n_groups < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return launch_as<T, 1>(*a, s);
    case 2: return launch_as<T, 2>(*a, s);
    case 4:
      if constexpr (sizeof(T) == 4) return launch_as<T, 4>(*a, s);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The diagonal stream of the aligned tile of 2^kDiagTileBits rows that
// holds block blockIdx.x (see the note at the top), P planes (the real and,
// with complex coefficients, the imaginary part), stored where the tile's
// rows lie in [row0, row0 + local_dim). With V = 16 / sizeof(T) = 2^kV
// rows in a 16-byte vector, the tile's row offset q has 12 bits:
//
//   layout A (the first 4 stages): q bits kA..kA + 3 (kA = kV + 4) are
//     the thread's 16 entries, the thread index the other 8 bits, its lane
//     the lowest 5 (consecutive words: no bank conflicts);
//   layout B (the last 8 stages and the store): q bits 0..kV-1 are the
//     rows of a vector, kV..kV+4 the lane, kV+5..kV+7 the warp, the rest
//     the thread's vectors; the registers take q bits 0..kV-1 and
//     kV+8..11, the shuffles the lane bits kV..kV+3, and layout A took
//     kV+4 (the lane's top bit) and the warp's three.
//
// A stage adds and subtracts the pair of entries whose q differs in one
// bit; the stages commute, so each bit is taken once where it is local.
template <typename T, int P>
__global__ void __launch_bounds__(kDiagThreads, sizeof(T) == 4 ? 6 : 1)
xor_diagonal_kernel(const XorArgs a) {
  constexpr int kTile = 1 << kDiagTileBits;
  constexpr int V = 16 / sizeof(T);
  constexpr int kV = V == 4 ? 2 : 1;
  constexpr int kA = kV + 4;
  constexpr int kE = kDiagEntries;
  static_assert(kE == 16 && kDiagThreads == 256 && kDiagTileBits == 12,
                "the layouts below assume 16 entries of 256 threads");
  extern __shared__ __align__(16) unsigned char smem[];
  T* g = reinterpret_cast<T*>(smem);  // [P][kTile], then v
  const uint32_t tid = threadIdx.x;
  const int64_t base =
      (a.row0 + (static_cast<int64_t>(blockIdx.x) << kDiagTileBits)) &
      ~static_cast<int64_t>(kTile - 1);
  const uint64_t k_hi = static_cast<uint64_t>(base);

  // (a) g. All threads take the terms' signs, term i by thread i mod 256:
  // c_t (-1)^parity(k_hi & s_hi) into the shared buffer v, kDiagChunk terms
  // at a time. Then the owner of slot j (thread j mod 256) adds the slot's
  // terms in their order to g[s_lo of slot j]; every other entry stays 0.
  T* v = g + P * kTile;  // [P][kDiagChunk]
  for (int i = tid; i < P * kTile / V; i += kDiagThreads) {
    reinterpret_cast<int4*>(g)[i] = make_int4(0, 0, 0, 0);
  }
  const T* term_cr = static_cast<const T*>(a.term_cr);
  const T* term_ci = static_cast<const T*>(a.term_ci);
  const int n_terms = __ldg(a.slot_term_start + a.n_slots);
  for (int c0 = 0; c0 < n_terms; c0 += kDiagChunk) {
    const int c1 = min(n_terms, c0 + kDiagChunk);
#pragma unroll 4
    for (int i = c0 + static_cast<int>(tid); i < c1; i += kDiagThreads) {
      const bool odd =
          __popcll(k_hi & static_cast<uint64_t>(__ldg(a.term_shi + i))) & 1;
      const T c_r = __ldg(term_cr + i);
      v[i - c0] = odd ? -c_r : c_r;
      if constexpr (P == 2) {
        const T c_i = __ldg(term_ci + i);
        v[kDiagChunk + i - c0] = odd ? -c_i : c_i;
      }
    }
    __syncthreads();
    for (int j = tid; j < a.n_slots; j += kDiagThreads) {
      const int begin = max(__ldg(a.slot_term_start + j), c0);
      const int end = min(__ldg(a.slot_term_start + j + 1), c1);
      if (begin >= end) continue;
      const uint32_t u = static_cast<uint32_t>(__ldg(a.slot_slo + j));
#pragma unroll
      for (int p = 0; p < P; ++p) {
        T sum = g[p * kTile + u];
        for (int i = begin; i < end; ++i) sum += v[p * kDiagChunk + i - c0];
        g[p * kTile + u] = sum;
      }
    }
    __syncthreads();  // v is overwritten next, g read next
  }
  // (b) layout A: entry e of the thread is q = qa | e << kA; the stages on
  // q bits kA..kA + 3 in registers, then to layout B through shared memory
  const uint32_t qa = (tid & ((1u << kA) - 1)) | ((tid >> kA) << (kA + 4));
  T f[P][kE];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      f[p][e] = g[p * kTile + (qa | (static_cast<uint32_t>(e) << kA))];
    }
    walsh<T, kE>(f[p]);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      g[p * kTile + (qa | (static_cast<uint32_t>(e) << kA))] = f[p][e];
    }
  }
  __syncthreads();
  const uint32_t lane = tid & 31;
  const uint32_t qb = ((tid >> 5) << (kV + 5)) | (lane << kV);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // entry e = w * V + r of the thread is q = qb | w << (kV + 8) | r
#pragma unroll
    for (int w = 0; w < kE / V; ++w) {
      T r[V];
      load_shared<T, V>(
          g + p * kTile + (qb | (static_cast<uint32_t>(w) << (kV + 8))), r);
#pragma unroll
      for (int i = 0; i < V; ++i) f[p][w * V + i] = r[i];
    }
    walsh<T, kE>(f[p]);  // q bits 0..kV-1 and kV+8..11
#pragma unroll
    for (int h = 1; h < 16; h <<= 1) {  // q bits kV..kV+3: lane bits 0..3
      // the lower lane of a pair takes a + b, the upper a - b: other + f
      // or other - f, one exact fused step
      const T sign = (lane & h) ? T(-1) : T(1);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const T other = __shfl_xor_sync(0xffffffffu, f[p][e], h);
        f[p][e] = fma(sign, f[p][e], other);
      }
    }
  }

  // (c) the rows of [row0, row0 + local_dim) among the tile's
  T* d = static_cast<T*>(a.y);
#pragma unroll
  for (int w = 0; w < kE / V; ++w) {
    const int64_t j =
        base + (qb | (static_cast<uint32_t>(w) << (kV + 8))) - a.row0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      T* out = d + p * a.local_dim;
      T r[V];
#pragma unroll
      for (int i = 0; i < V; ++i) r[i] = f[p][w * V + i];
      if (a.local_dim >= V) {
        if (j >= 0 && j < a.local_dim) store<T, V>(out + j, r);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (j + i >= 0 && j + i < a.local_dim) out[j + i] = r[i];
        }
      }
    }
  }
}

template <typename T, int P>
int launch_diagonal_as(const XorArgs& a, cudaStream_t stream) {
  const size_t smem = P * ((size_t(1) << kDiagTileBits) + kDiagChunk) *
                      sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(xor_diagonal_kernel<T, P>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      std::max<int64_t>(1, a.local_dim >> kDiagTileBits);
  xor_diagonal_kernel<T, P><<<static_cast<unsigned int>(blocks),
                              kDiagThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_diagonal(const XorArgs* a, void* stream) {
  const int64_t n = a->local_dim;
  if (n < 1 || (n & (n - 1)) || a->row0 < 0 || a->row0 % n ||
      a->tile_bits != kDiagTileBits || (n >> kDiagTileBits) >= (1LL << 31) ||
      a->n_slots < 1 || a->n_slots > (1 << kDiagTileBits) ||
      !a->slot_slo || !a->slot_term_start || !a->y) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->diag_planes) {
    case 1: return launch_diagonal_as<T, 1>(*a, s);
    case 2: return launch_diagonal_as<T, 2>(*a, s);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronize, and returns cudaGetLastError().
int xor_apply_f32(const XorArgs* a, void* stream) {
  return launch<float>(a, stream);
}

int xor_apply_f64(const XorArgs* a, void* stream) {
  return launch<double>(a, stream);
}

int xor_diagonal_f32(const XorArgs* a, void* stream) {
  return launch_diagonal<float>(a, stream);
}

int xor_diagonal_f64(const XorArgs* a, void* stream) {
  return launch_diagonal<double>(a, stream);
}

const char* xor_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
