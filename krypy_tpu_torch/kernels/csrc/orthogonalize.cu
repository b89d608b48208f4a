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
// per-block partials instead of float atomics.  Within a block, each warp
// reduces its 32 lanes with a fixed shuffle tree per column tile, lane 0
// adds the tile's sum to the warp's running total, and the warps' totals
// are added in warp order; the second pass adds the blocks' partials in a
// fixed tree.  The launch configuration depends only on N and rows, so a
// repeated call gives the same bits.
//
// Each C entry point launches on the given stream, does not synchronise,
// allocates nothing (the caller passes the partials' scratch), and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads of the fixed-order second pass; one block per coefficient
constexpr int kReduceThreads = 256;
// rows loaded together per column in K4 (independent loads in flight)
constexpr int kRowChunk = 8;

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

// K4, first pass, and phase 0 of K7.  Replaces
// krypy_tpu/kernels/orthogonalize.py:project_prefix
// (_project_prefix_kernel): the per-block partials of
//   c_r = sum_n V[r, n] w[n],  r < rows.
//
// Bound: device memory.  It reads the V prefix once (rows * N elements)
// and w once, and does 2 flops per V element.  Each thread walks one
// column per tile (a warp reads 32 contiguous elements of each row) and
// loads kRowChunk rows at a time, so several independent loads are in
// flight per thread; w[n] is read once into a register and used for all
// rows.  (Running sums per row in registers, reduced once at the end,
// measured slower on the H100.)  Left for later: 16-byte vector loads and
// a TMA/cp.async pipeline.
template <typename T>
__device__ __forceinline__ void project_partials(const T* __restrict__ V,
                                                 const T* __restrict__ w,
                                                 T* __restrict__ partial,
                                                 int64_t N, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wacc = reinterpret_cast<T*>(smem_raw);  // [nwarps][rows]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < nwarps * rows; i += blockDim.x) wacc[i] = T(0);
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // every thread runs the same trip count, so the shuffles see full warps
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < N;
       base += stride) {
    const int64_t n = base + tid;
    const bool ok = n < N;
    const T wn = ok ? w[n] : T(0);
    for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
      T v[kRowChunk];
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j) {
        v[j] = (ok && r0 + j < rows) ? V[(int64_t)(r0 + j) * N + n] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j) {
        const T p = warp_sum(v[j] * wn);
        if (lane == 0 && r0 + j < rows) wacc[warp * rows + r0 + j] += p;
      }
    }
  }
  __syncthreads();
  write_block_partials(wacc, partial, rows, nwarps);
}

template <typename T>
__global__ void project_partial_kernel(const T* __restrict__ V,
                                       const T* __restrict__ w,
                                       T* __restrict__ partial, int64_t N,
                                       int rows) {
  project_partials(V, w, partial, N, rows);
}

// Second pass of K4, K5 and K7: c[r] = (sum over blocks of partial[b][r]) *
// mask[r] for r < rows, c[r] = 0 for rows <= r < m.  One block per r; each
// thread adds a strided run of blocks in order, then a fixed shared-memory
// tree.  The mask multiplies the finished sum (the Pallas kernels multiply
// each tile's part; for the 0/1 masks of GMRES the two are the same).
template <typename T>
__global__ void reduce_partials_kernel(const T* __restrict__ partial,
                                       int nblocks, int rows,
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
    acc += partial[(int64_t)b * rows + r];
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

// K6, and phase 1 of K7.  Replaces
// krypy_tpu/kernels/orthogonalize.py:update_prefix (_update_kernel):
//   out = w - sum_r c[r] V[r, :].
//
// Bound: device memory, (rows + 2) * N elements (the V prefix and w
// read once, out written once), 2 flops per V element.  Purely
// column-parallel: one thread per column, c broadcast from shared
// memory, no reduction.
template <typename T>
__device__ __forceinline__ void update_columns(const T* __restrict__ V,
                                               const T* __restrict__ w,
                                               const T* __restrict__ c,
                                               T* __restrict__ out,
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

template <typename T>
__global__ void update_kernel(const T* __restrict__ V,
                              const T* __restrict__ w,
                              const T* __restrict__ c, T* __restrict__ out,
                              int64_t N, int rows) {
  update_columns(V, w, c, out, N, rows);
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
// partials (K4's sweep of V), a fixed-order second pass sums them into
// the coefficient output (masked, zero past `rows`, so the caller can add
// it to a full-height Hessenberg column), and phase 1 is column-parallel
// over B with c in shared memory (K6's sweep).  Three launches on one
// stream; no float atomics, so a repeated call gives the same bits.
//
// Bound: device memory, 4 flops per basis element.  The function must
// move (2 rows + 2) * N elements with a dual basis (the V and B prefixes
// and w read once, w' written once) and (rows + 2) * N with B = V; this
// design sweeps twice, so it moves (2 rows + 3) * N either way (w is read
// in both phases, and with B = V the prefix too: at 26 x 4096^2 it is far
// larger than the L2).  Left for later: one cooperative launch with a
// grid-wide barrier between the phases, 16-byte loads, a TMA pipeline.
// The host function cgs_project below launches K4's project_partial_kernel,
// reduce_partials_kernel and K6's update_kernel.
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
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sizeof(T) * (size_t)(threads / 32) * rows;
  cudaError_t err = allow_smem(project_partial_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  project_partial_kernel<T><<<blocks, threads, smem, s>>>(V, w, partial,
                                                          (int64_t)N, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<T><<<m, kReduceThreads, 0, s>>>(partial, blocks,
                                                          rows, mask, c);
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
  reduce_partials_kernel<T><<<m, kReduceThreads, 0, s>>>(partial, blocks,
                                                          rows, mask, c2);
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

template <typename T>
int cgs_project(const T* V, const T* B, const T* w, const T* mask,
                T* partial, T* w_out, T* coeffs, long long N, int rows,
                int m, int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem0 = sizeof(T) * (size_t)(threads / 32) * rows;
  const size_t smem1 = sizeof(T) * (size_t)rows;
  cudaError_t err = allow_smem(project_partial_kernel<T>, smem0);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(update_kernel<T>, smem1);
  if (err != cudaSuccess) return (int)err;
  project_partial_kernel<T><<<blocks, threads, smem0, s>>>(
      V, w, partial, (int64_t)N, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<T><<<m, kReduceThreads, 0, s>>>(partial, blocks,
                                                          rows, mask, coeffs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_kernel<T><<<blocks, threads, smem1, s>>>(
      B, w, coeffs, w_out, (int64_t)N, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define KRYPY_ORTHO_ENTRIES(T, SUFFIX)                                        \
  int krypy_project_prefix_##SUFFIX(const T* V, const T* w, const T* mask,    \
                                    T* partial, T* c, long long N, int rows,  \
                                    int m, int blocks, int threads,           \
                                    void* stream) {                           \
    return project_prefix<T>(V, w, mask, partial, c, N, rows, m, blocks,      \
                             threads, stream);                                \
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
                                 int blocks, int threads, void* stream) {     \
    return cgs_project<T>(V, B, w, mask, partial, w_out, coeffs, N, rows, m,  \
                          blocks, threads, stream);                           \
  }

KRYPY_ORTHO_ENTRIES(float, f32)
KRYPY_ORTHO_ENTRIES(double, f64)

#undef KRYPY_ORTHO_ENTRIES

}  // extern "C"
