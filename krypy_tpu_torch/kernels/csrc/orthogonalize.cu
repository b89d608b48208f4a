// Hand-written Hopper (sm_90a) kernels for the classical Gram-Schmidt
// orthogonalization of the GMRES basis: the three prefix-sweep kernels
// that ortho="cgs2_fused" composes, K4 -> K5 -> K6, and the two-phase
// projection K7 (cgs_project) behind ortho="cgs_pallas"/"cgs2_pallas",
// which may subtract along a second (dual) basis.
//
// Layout: V is a row-major (m, N) basis; only its leading `rows` rows
// (the active Krylov prefix, a run-time argument) are read, straight out
// of the full buffer with no copy.  w, w1 and the outputs are (N,);
// c, mask and the coefficient outputs are (m,).  N need not be a
// multiple of anything: every column loop masks its ragged end.
//
// Sums are taken in the working type T (float or double), as the Pallas
// kernels accumulate in the dtype of the operands.
//
// Cross-block reductions (K4, K5) take a second, fixed-order pass over
// per-block partials instead of float atomics.  K4 sums each block's
// contiguous column range in registers, then once per chunk of rows
// reduces its warps with a fixed shuffle tree and adds the warps' totals
// in warp order; K5 reduces each warp per column tile (lane 0 carrying
// the warp's running total) and adds the warps' totals in warp order.
// The second pass adds the blocks' partials in a fixed tree.  The launch
// configuration depends only on N, rows and the dtype, so a repeated
// call gives the same bits.
//
// Each C entry point launches on the given stream, does not synchronise,
// allocates nothing (the caller passes the partials' scratch), and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads of the fixed-order second pass; one block per coefficient
constexpr int kReduceThreads = 256;
// K4: threads per block (at most), and rows loaded together per column
// group (16-byte loads in flight per thread)
constexpr int kProjectThreads = 256;
constexpr int kProjectBatch = 8;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // lane 0 holds the sum
}

// The block's warp totals [nwarps][rows] summed in warp order into
// partial[blockIdx.x][r].
template <typename T>
__device__ __forceinline__ void write_block_partials(const T* wacc,
                                                     T* __restrict__ partial,
                                                     int rows, int nwarps) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    T s = T(0);
    for (int i = 0; i < nwarps; ++i) s += wacc[i * rows + r];
    partial[(int64_t)blockIdx.x * rows + r] = s;
  }
}

// A 16-byte group of columns: 4 float32 or 2 float64 values.
template <typename T>
struct Group;
template <>
struct Group<float> {
  using vec = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& x, float (&v)[4]) {
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};
template <>
struct Group<double> {
  using vec = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& x, double (&v)[2]) {
    v[0] = x.x, v[1] = x.y;
  }
};

// The group of columns at p: one 16-byte load where `vec` (p aligned and
// the whole group inside N), else `valid` scalar loads and zeros past
// them.  STREAM loads evict-first (the basis, read once); the others go
// through the read-only path (w, re-read by every chunk of rows).
template <typename T, bool STREAM>
__device__ __forceinline__ void load_group(const T* __restrict__ p, bool vec,
                                           int valid,
                                           T (&v)[Group<T>::n]) {
  using G = Group<T>;
  if (vec) {
    const auto* q = reinterpret_cast<const typename G::vec*>(p);
    G::unpack(STREAM ? __ldcs(q) : __ldg(q), v);
  } else {
#pragma unroll
    for (int k = 0; k < G::n; ++k) {
      v[k] = k < valid ? (STREAM ? __ldcs(p + k) : __ldg(p + k)) : T(0);
    }
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K7's alignment-free 16-byte access.  Row p (a basis row, or w) starts o
// elements past the 16-byte boundary at or below it; its group g (columns
// g*VW .. g*VW + VW-1) then lies in the aligned groups A_g and A_{g+1} of
// the row's aligned superset pa = p - o: elements o .. VW-1 of A_g and
// 0 .. o-1 of A_{g+1}.  The 32 lanes of a warp load A_{g0} .. A_{g0+31},
// one 16-byte load each; lane l < 31 produces group g0 + l, taking
// A_{g+1} from lane l+1 by shuffle, and lane 31 only loads (its group is
// the next step's), so a warp steps kStepGroups = 31 groups at a time.
// A group is loaded only where it holds an element of the row, so an
// aligned 16-byte load never leaves the tensor's pages.  o is the same
// across the warp.
constexpr int kStepGroups = 31;

template <typename T>
__device__ __forceinline__ int offset16(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

template <typename T>
__device__ __forceinline__ typename Group<T>::vec shfl_down1(
    typename Group<T>::vec v);
template <>
__device__ __forceinline__ float4 shfl_down1<float>(float4 v) {
  v.x = __shfl_down_sync(0xffffffffu, v.x, 1);
  v.y = __shfl_down_sync(0xffffffffu, v.y, 1);
  v.z = __shfl_down_sync(0xffffffffu, v.z, 1);
  v.w = __shfl_down_sync(0xffffffffu, v.w, 1);
  return v;
}
template <>
__device__ __forceinline__ double2 shfl_down1<double>(double2 v) {
  v.x = __shfl_down_sync(0xffffffffu, v.x, 1);
  v.y = __shfl_down_sync(0xffffffffu, v.y, 1);
  return v;
}

// Elements o .. o+VW-1 of the 2 VW values (a, b), by selects (no branch,
// so that the compiler can overlap one batch's loads with the last's
// arithmetic).
__device__ __forceinline__ void take(const float4& a, const float4& b, int o,
                                     float (&v)[4]) {
  const bool o1 = o == 1, o2 = o == 2, o3 = o == 3;
  v[0] = o3 ? a.w : o2 ? a.z : o1 ? a.y : a.x;
  v[1] = o3 ? b.x : o2 ? a.w : o1 ? a.z : a.y;
  v[2] = o3 ? b.y : o2 ? b.x : o1 ? a.w : a.z;
  v[3] = o3 ? b.z : o2 ? b.y : o1 ? b.x : a.w;
}
__device__ __forceinline__ void take(const double2& a, const double2& b,
                                     int o, double (&v)[2]) {
  v[0] = o == 0 ? a.x : a.y;
  v[1] = o == 0 ? a.y : b.x;
}

// A_g of row p (offset o), or zeros where it holds no element of the row.
template <typename T, bool STREAM>
__device__ __forceinline__ typename Group<T>::vec load_aligned(
    const T* __restrict__ p, int o, int64_t g, int64_t N) {
  using V = typename Group<T>::vec;
  const V* pa = reinterpret_cast<const V*>(p - o) + g;
  V v{};
  if (g * Group<T>::n - o < N) v = STREAM ? __ldcs(pa) : __ldg(pa);
  return v;
}

// The row's values at columns g*VW .. g*VW + VW-1 from this lane's A_g
// and the next lane's, zero past the `valid` columns inside N (every lane
// of the warp calls it: the shuffle).
template <typename T>
__device__ __forceinline__ void settle_group(typename Group<T>::vec own,
                                             int o, int valid,
                                             T (&v)[Group<T>::n]) {
  take(own, shfl_down1<T>(own), o, v);
#pragma unroll
  for (int k = 0; k < Group<T>::n; ++k) v[k] = k < valid ? v[k] : T(0);
}

// K4, first pass, and phase 0 of K7.  Replaces
// krypy_tpu/kernels/orthogonalize.py:project_prefix
// (_project_prefix_kernel): the per-block partials of
//   c_r = sum_n V[r, n] w[n],  r < rows,
// written to partial[r * gridDim.x + blockIdx.x] (row by row: with the
// block-by-block index the float32 16-row instantiation spilled at its
// 128-register cap and K4 took ~1% longer on the H100).
//
// Bound: device memory.  It reads the V prefix once (rows * N elements)
// and w once, and does 2 flops per V element, so only the bytes count.
// Design:
// * Block b owns one contiguous range of 16-byte column groups, the
//   grid's equal share of N (the wrapper fixes the grid from N and the
//   dtype alone, never from the SM count): its slice of w stays in the
//   caches while the block walks the prefix.
// * The block walks `rows` in chunks of CHUNK rows (8 or 16: the wrapper
//   takes 8 for prefixes of up to 8 rows, whose fewer registers let more
//   blocks share an SM; that measured faster there on the H100, most for
//   float64 and one row, and no slower at 8 rows).  Each thread keeps CHUNK
//   running sums in registers over its groups of the range, loading
//   kProjectBatch rows of a group together (16-byte loads in flight);
//   a ragged last chunk is masked by the compile-time-unrolled row
//   guards.  Then ONE warp-shuffle tree per row and one shared-memory
//   sum over the warps per chunk: each (row, block) partial is final
//   after its chunk.  Each chunk reads the block's slice of w again (the
//   basis loads evict first, so it can stay in the L2).  Chunks of 32
//   rows, which read w once for the main path's 26, took 128 registers a
//   thread and measured slower on the H100.
// * 16-byte loads (float4 / double2) where a row's group is aligned.
//   Row r starts at r * N elements, so for float32 with N % 4 != 0 (odd
//   N for float64) some rows are not: those rows, and the group that
//   holds the ragged end of N, take scalar loads of the same columns
//   (a warp-uniform choice per row; the same bytes move).
template <typename T, int CHUNK>
__device__ __forceinline__ void project_partials(const T* __restrict__ V,
                                                 const T* __restrict__ w,
                                                 T* __restrict__ partial,
                                                 int64_t N, int rows) {
  constexpr int VW = Group<T>::n;
  static_assert(CHUNK % kProjectBatch == 0 && CHUNK <= 32, "row chunk");
  __shared__ T red[kProjectThreads / 32][CHUNK];  // one chunk's warp totals
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t ngroups = (N + VW - 1) / VW;
  const int64_t span = (ngroups + gridDim.x - 1) / gridDim.x;
  const int64_t g_lo = (int64_t)blockIdx.x * span;
  const int64_t g_hi = min(ngroups, g_lo + span);
  const bool w_vec = aligned16(w);

  for (int r0 = 0; r0 < rows; r0 += CHUNK) {
    const int nr = min(CHUNK, rows - r0);
    const T* base = V + (int64_t)r0 * N;
    uint32_t row_vec = 0;  // bit j: row r0 + j starts 16-byte aligned
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < nr && aligned16(base + (int64_t)j * N)) row_vec |= 1u << j;
    }
    T acc[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) acc[j] = T(0);

    for (int64_t g = g_lo + tid; g < g_hi; g += blockDim.x) {
      const int64_t n = g * VW;
      const int valid = (int)min((int64_t)VW, N - n);
      const bool full = valid == VW;
      T wv[VW];
      load_group<T, false>(w + n, full && w_vec, valid, wv);
#pragma unroll
      for (int j0 = 0; j0 < CHUNK; j0 += kProjectBatch) {
        if (j0 < nr) {
          T v[kProjectBatch][VW];
#pragma unroll
          for (int j = 0; j < kProjectBatch; ++j) {
            if (j0 + j < nr) {
              load_group<T, true>(base + (int64_t)(j0 + j) * N + n,
                                  full && (row_vec >> (j0 + j) & 1u), valid,
                                  v[j]);
            } else {
#pragma unroll
              for (int k = 0; k < VW; ++k) v[j][k] = T(0);
            }
          }
#pragma unroll
          for (int j = 0; j < kProjectBatch; ++j) {
#pragma unroll
            for (int k = 0; k < VW; ++k) acc[j0 + j] += v[j][k] * wv[k];
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < nr) {
        const T s = warp_sum(acc[j]);
        if (lane == 0) red[warp][j] = s;
      }
    }
    __syncthreads();
    if (tid < nr) {
      T s = T(0);
      for (int i = 0; i < nwarps; ++i) s += red[i][tid];
      partial[(int64_t)(r0 + tid) * gridDim.x + blockIdx.x] = s;
    }
    __syncthreads();  // red is refilled by the next chunk
  }
}

template <typename T, int CHUNK>
__global__ void __launch_bounds__(kProjectThreads, 2)
    project_partial_kernel(const T* __restrict__ V, const T* __restrict__ w,
                           T* __restrict__ partial, int64_t N, int rows) {
  project_partials<T, CHUNK>(V, w, partial, N, rows);
}

// Rows of K7's phase 1 loaded together (each batch's loads issued before
// any is used).
constexpr int kUpdateBatch = 16;

// Launch K4's first pass with the row chunk the wrapper chose.
template <typename T>
cudaError_t launch_project_partials(const T* V, const T* w, T* partial,
                                    int64_t N, int rows, int blocks,
                                    int threads, int chunk, cudaStream_t s) {
  if (threads > kProjectThreads || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  switch (chunk) {
    case 8:
      project_partial_kernel<T, 8><<<blocks, threads, 0, s>>>(V, w, partial,
                                                              N, rows);
      break;
    case 16:
      project_partial_kernel<T, 16><<<blocks, threads, 0, s>>>(V, w, partial,
                                                               N, rows);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Second pass of K4, K5 and K7: c[r] = (sum over blocks b of
// partial[b * stride_b + r * stride_r]) * mask[r] for r < rows, c[r] = 0
// for rows <= r < m (K4 and K7 lay the partials out row by row, K5 block
// by block).  One block per r; each thread adds a strided run of blocks
// in order, then a fixed shared-memory tree.  The mask multiplies the
// finished sum (the Pallas kernels multiply each tile's part; for the 0/1
// masks of GMRES the two are the same).
template <typename T>
__global__ void reduce_partials_kernel(const T* __restrict__ partial,
                                       int nblocks, int64_t stride_b,
                                       int64_t stride_r, int rows,
                                       const T* __restrict__ mask,
                                       T* __restrict__ c) {
  const int r = blockIdx.x;
  if (r >= rows) {
    if (threadIdx.x == 0) c[r] = T(0);
    return;
  }
  __shared__ T s[kReduceThreads];
  T acc = T(0);
  for (int b = threadIdx.x; b < nblocks; b += kReduceThreads) {
    acc += partial[b * stride_b + r * stride_r];
  }
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int off = kReduceThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) c[r] = s[0] * mask[r];
}

// K5, first pass.  Replaces krypy_tpu/kernels/orthogonalize.py:
// apply_project (_apply_project_kernel):
//   w1 = w - sum_r c[r] V[r, :],  partials of c2_r = sum_n V[r, n] w1[n].
//
// Bound: device memory.  It reads the V prefix once, w once, and writes
// w1 once ((rows + 2) * N elements), 4 flops per V element.  The point
// of the TPU kernel is kept: each V element is read ONCE from device
// memory and used twice.  The thread that owns column n stages its rows'
// values in its own slot of shared memory (vals[r][tid]) while it forms
// w1[n], then reads them back for the c2 products; c is broadcast from
// shared memory.  Left for later: keeping the column in registers for
// small rows, vector loads, a TMA pipeline.
template <typename T>
__global__ void apply_project_partial_kernel(const T* __restrict__ V,
                                             const T* __restrict__ w,
                                             const T* __restrict__ c,
                                             T* __restrict__ w1,
                                             T* __restrict__ partial,
                                             int64_t N, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  T* cs = reinterpret_cast<T*>(smem_raw);  // [rows]
  T* wacc = cs + rows;                     // [nwarps][rows]
  T* vals = wacc + nwarps * rows;          // [rows][blockDim.x]
  for (int i = tid; i < rows; i += blockDim.x) cs[i] = c[i];
  for (int i = tid; i < nwarps * rows; i += blockDim.x) wacc[i] = T(0);
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < N;
       base += stride) {
    const int64_t n = base + tid;
    const bool ok = n < N;
    T upd = T(0);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const T v = ok ? V[(int64_t)r * N + n] : T(0);
      vals[r * blockDim.x + tid] = v;
      upd += cs[r] * v;
    }
    const T w1n = (ok ? w[n] : T(0)) - upd;
    if (ok) w1[n] = w1n;
    for (int r = 0; r < rows; ++r) {
      const T p = warp_sum(vals[r * blockDim.x + tid] * w1n);
      if (lane == 0) wacc[warp * rows + r] += p;
    }
  }
  __syncthreads();
  write_block_partials(wacc, partial, rows, nwarps);
}

// K6.  Replaces krypy_tpu/kernels/orthogonalize.py:update_prefix
// (_update_kernel):
//   out = w - sum_r c[r] V[r, :].
//
// Bound: device memory, (rows + 2) * N elements (the V prefix and w
// read once, out written once), 2 flops per V element.  Purely
// column-parallel: one thread per column, c broadcast from shared
// memory, no reduction.
template <typename T>
__global__ void update_kernel(const T* __restrict__ V,
                              const T* __restrict__ w,
                              const T* __restrict__ c, T* __restrict__ out,
                              int64_t N, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // [rows]
  for (int i = threadIdx.x; i < rows; i += blockDim.x) cs[i] = c[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    T upd = T(0);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) upd += cs[r] * V[(int64_t)r * N + n];
    out[n] = w[n] - upd;
  }
}

// Phase 1 of K7 where N is not a multiple of the 16-byte group, so that
// the rows start at different offsets from a 16-byte boundary (config 3's
// N = 4095^2): K6's update out = w - sum_r c[r] B[r, :] on K4's grid
// (block b owns a contiguous range of column groups, each warp walking it
// kStepGroups at a time), each row of B and w read by 16-byte loads
// whatever its alignment and out written by 16-byte stores (the wrapper
// allocates it, aligned).  On the H100 it took 0.4193 / 0.7631 ms where
// K6's one-thread-a-column update took 0.5146 / 1.0156 (rows 16 / 30 of a
// 31 x 4095^2 basis); where all rows share one offset K6's update is as
// fast or faster (0.6250 against 0.6621 ms at 26 rows of 4096^2, the
// basis one element off alignment), so those bases keep it
// (chip_smoke.py --only kernels, parent against this kernel in one
// call).  Per column the same sum in the same order as K6 (rows in order,
// then w minus it).  c sits in shared memory.
template <typename T>
__global__ void __launch_bounds__(kProjectThreads)
    update_shifted_kernel(const T* __restrict__ B, const T* __restrict__ w,
                          const T* __restrict__ c, T* __restrict__ out,
                          int64_t N, int rows) {
  using G = Group<T>;
  using Vec = typename G::vec;
  constexpr int VW = G::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // [rows]
  for (int i = threadIdx.x; i < rows; i += blockDim.x) cs[i] = c[i];
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t ngroups = (N + VW - 1) / VW;
  const int64_t span = (ngroups + gridDim.x - 1) / gridDim.x;
  const int64_t g_lo = (int64_t)blockIdx.x * span;
  const int64_t g_hi = min(ngroups, g_lo + span);
  const int ow = offset16(w);

  for (int64_t g0 = g_lo + (int64_t)warp * kStepGroups; g0 < g_hi;
       g0 += (int64_t)nwarps * kStepGroups) {
    const int64_t g = g0 + lane;
    const int valid = (lane < kStepGroups && g < g_hi)
                          ? (int)min((int64_t)VW, N - g * VW)
                          : 0;
    const Vec w_own = load_aligned<T, false>(w, ow, g, N);
    T upd[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) upd[k] = T(0);
    for (int r0 = 0; r0 < rows; r0 += kUpdateBatch) {
      Vec own[kUpdateBatch];
      int o[kUpdateBatch];
#pragma unroll
      for (int j = 0; j < kUpdateBatch; ++j) {
        o[j] = 0;
        if (r0 + j < rows) {
          const T* row = B + (int64_t)(r0 + j) * N;
          o[j] = offset16(row);
          own[j] = load_aligned<T, true>(row, o[j], g, N);
        }
      }
#pragma unroll
      for (int j = 0; j < kUpdateBatch; ++j) {
        if (r0 + j < rows) {
          T v[VW];
          settle_group<T>(own[j], o[j], valid, v);
#pragma unroll
          for (int k = 0; k < VW; ++k) upd[k] += cs[r0 + j] * v[k];
        }
      }
    }
    T wv[VW];
    settle_group<T>(w_own, ow, valid, wv);
    T res[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) res[k] = wv[k] - upd[k];
    T* dst = out + g * VW;
    if (valid == VW) {
      Vec vv;
      T* e = reinterpret_cast<T*>(&vv);
#pragma unroll
      for (int k = 0; k < VW; ++k) e[k] = res[k];
      *reinterpret_cast<Vec*>(dst) = vv;
    } else {
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        if (k < valid) dst[k] = res[k];
      }
    }
  }
}

// K7.  Replaces krypy_tpu/kernels/orthogonalize.py:cgs_project (_kernel):
// one classical Gram-Schmidt pass with an optional dual basis,
//   c_r = (sum_n V[r, n] w[n]) * mask[r],   w' = w - sum_r c_r B[r, :],
// r < rows, where B is V itself or a second (m, N) basis (GMRES with an
// inner-product-changing preconditioner M keeps V = M B).
//
// The Pallas kernel is ONE call over a (2, n_tiles) grid that walks its
// column tiles in order and carries c in a VMEM scratch from phase 0 to
// phase 1.  Hopper's blocks run side by side and share nothing, so the
// sum over column tiles is a step of its own: phase 0 writes per-block
// partials (K4's sweep of V, on K4's grid), a fixed-order second pass
// sums them into the coefficient output (masked, zero past `rows`, so the
// caller can add it to a full-height Hessenberg column), and phase 1 (K6's
// update) is column-parallel over B with c in shared memory: K6's own
// kernel, or update_shifted_kernel where N is not a multiple of the
// 16-byte group.  Three launches on one stream; no float atomics, so a
// repeated call gives the same bits.
//
// Bound: device memory, 4 flops per basis element.  The function must
// move (2 rows + 2) * N elements with a dual basis (the V and B prefixes
// and w read once, w' written once) and (rows + 2) * N with B = V; this
// design sweeps twice, so it moves (2 rows + 3) * N either way (w is read
// in both phases, and with B = V the prefix too: at 26 x 4096^2 it is far
// larger than the L2).  What held it below that floor at config 3's shape
// was alignment: with N % 4 != 0 (float32; odd N for float64) the rows
// start at differing offsets from a 16-byte boundary, and K6's update,
// one thread a column, ran at 70% of its bound there; phase 1 now reads
// every row as aligned 16-byte groups shifted across lanes
// (load_aligned / settle_group) and stores 16-byte groups.  K4's sweep,
// which takes 16-byte loads on the aligned rows and scalar loads on the
// others, measured faster as phase 0 there than shifted loads (0.3830
// against 0.4042 ms at 16 rows; chip_smoke.py --only kernels), so phase 0
// stays K4's.  Left for later: one cooperative launch with a grid-wide
// barrier between the phases.
template <typename T>
size_t apply_project_smem(int rows, int threads) {
  return sizeof(T) * (size_t)rows * (1 + threads / 32 + threads);
}

// A block may take more than the default 48 KB of dynamic shared memory
// only once the kernel opts in (up to 227 KB on Hopper); the wrappers'
// launch_config keeps every request within that.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int project_prefix(const T* V, const T* w, const T* mask, T* partial, T* c,
                   long long N, int rows, int m, int blocks, int threads,
                   int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_project_partials<T>(V, w, partial, (int64_t)N,
                                               rows, blocks, threads, chunk,
                                               s);
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<T><<<m, kReduceThreads, 0, s>>>(
      partial, blocks, 1, blocks, rows, mask, c);
  return (int)cudaGetLastError();
}

template <typename T>
int apply_project(const T* V, const T* w, const T* c, const T* mask, T* w1,
                  T* partial, T* c2, long long N, int rows, int m, int blocks,
                  int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = apply_project_smem<T>(rows, threads);
  cudaError_t err = allow_smem(apply_project_partial_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  apply_project_partial_kernel<T><<<blocks, threads, smem, s>>>(
      V, w, c, w1, partial, (int64_t)N, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<T><<<m, kReduceThreads, 0, s>>>(
      partial, blocks, rows, 1, rows, mask, c2);
  return (int)cudaGetLastError();
}

template <typename T>
int update_prefix(const T* V, const T* w, const T* c, T* out, long long N,
                  int rows, int blocks, int threads, void* stream) {
  const size_t smem = sizeof(T) * (size_t)rows;
  cudaError_t err = allow_smem(update_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  update_kernel<T><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      V, w, c, out, (int64_t)N, rows);
  return (int)cudaGetLastError();
}

// K7: phase 0 on K4's grid (`blocks`, `threads`, `chunk`); phase 1 K6's
// update on its grid (`update_blocks`) or, where N is not a multiple of
// the 16-byte group, the shifted update on K4's grid.  w_out must be
// 16-byte aligned (the wrapper allocates it).
template <typename T>
int cgs_project(const T* V, const T* B, const T* w, const T* mask,
                T* partial, T* w_out, T* coeffs, long long N, int rows,
                int m, int blocks, int threads, int chunk, int update_blocks,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!aligned16(w_out)) return (int)cudaErrorInvalidValue;
  const bool shifted = (N * sizeof(T)) % 16 != 0;
  const size_t smem1 = sizeof(T) * (size_t)rows;
  cudaError_t err = shifted ? allow_smem(update_shifted_kernel<T>, smem1)
                            : allow_smem(update_kernel<T>, smem1);
  if (err != cudaSuccess) return (int)err;
  err = launch_project_partials<T>(V, w, partial, (int64_t)N, rows, blocks,
                                   threads, chunk, s);
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<T><<<m, kReduceThreads, 0, s>>>(
      partial, blocks, 1, blocks, rows, mask, coeffs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (shifted) {
    update_shifted_kernel<T><<<blocks, threads, smem1, s>>>(
        B, w, coeffs, w_out, (int64_t)N, rows);
  } else {
    update_kernel<T><<<update_blocks, threads, smem1, s>>>(
        B, w, coeffs, w_out, (int64_t)N, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define KRYPY_ORTHO_ENTRIES(T, SUFFIX)                                        \
  int krypy_project_prefix_##SUFFIX(const T* V, const T* w, const T* mask,    \
                                    T* partial, T* c, long long N, int rows,  \
                                    int m, int blocks, int threads,           \
                                    int chunk, void* stream) {                \
    return project_prefix<T>(V, w, mask, partial, c, N, rows, m, blocks,      \
                             threads, chunk, stream);                         \
  }                                                                           \
  int krypy_apply_project_##SUFFIX(const T* V, const T* w, const T* c,        \
                                   const T* mask, T* w1, T* partial, T* c2,   \
                                   long long N, int rows, int m, int blocks,  \
                                   int threads, void* stream) {               \
    return apply_project<T>(V, w, c, mask, w1, partial, c2, N, rows, m,       \
                            blocks, threads, stream);                         \
  }                                                                           \
  int krypy_update_prefix_##SUFFIX(const T* V, const T* w, const T* c,        \
                                   T* out, long long N, int rows, int blocks, \
                                   int threads, void* stream) {               \
    return update_prefix<T>(V, w, c, out, N, rows, blocks, threads, stream);  \
  }                                                                           \
  int krypy_cgs_project_##SUFFIX(const T* V, const T* B, const T* w,          \
                                 const T* mask, T* partial, T* w_out,         \
                                 T* coeffs, long long N, int rows, int m,     \
                                 int blocks, int threads, int chunk,          \
                                 int update_blocks, void* stream) {           \
    return cgs_project<T>(V, B, w, mask, partial, w_out, coeffs, N, rows, m,  \
                          blocks, threads, chunk, update_blocks, stream);     \
  }

KRYPY_ORTHO_ENTRIES(float, f32)
KRYPY_ORTHO_ENTRIES(double, f64)

#undef KRYPY_ORTHO_ENTRIES

}  // extern "C"
