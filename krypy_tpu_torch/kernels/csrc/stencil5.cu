// Hand-written Hopper (sm_90a) kernels for the grid-padded 5-point
// Dirichlet stencil: the three kernels of the multigrid-CG solve.
//
// Layout: a row-major (nx, ny) float32 buffer that holds an
// (nrows, ncols) logical grid in its top-left corner.  Every kernel
// reads only the logical region (a neighbour outside it is the
// Dirichlet zero) and writes exact zeros everywhere else, so none of
// them relies on the pads being zero.
//
// Arithmetic parity with the JAX package: the stencil is evaluated in
// grouped-difference form with the same add order,
//   a(u-up) + b(u-down) + c(u-left) + d(u-right), then + e*u, + alpha*u,
//   + beta*g,
// and every constant is computed on the host in double precision and
// rounded once to float.  nvcc contracts the multiply-adds to FMA, so
// results differ from the plain PyTorch versions by a few ulps.
//
// Each C entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

struct Coeffs {
  float a, b, c, d, e;
};

// Value of u at (i, j), or the Dirichlet zero outside the logical region.
__device__ __forceinline__ float load_logical(const float* __restrict__ u,
                                              int i, int j, int ny,
                                              int nrows, int ncols) {
  return (i >= 0 && i < nrows && j >= 0 && j < ncols)
             ? u[(size_t)i * ny + j]
             : 0.0f;
}

// Grouped-difference stencil at logical point (i, j): a(u-up) + b(u-dn)
// + c(u-lf) + d(u-rt) + e*u.
__device__ __forceinline__ float stencil_at(const float* __restrict__ u,
                                            int i, int j, int ny, int nrows,
                                            int ncols, Coeffs k, float* uc) {
  const float c0 = u[(size_t)i * ny + j];
  const float up = load_logical(u, i - 1, j, ny, nrows, ncols);
  const float dn = load_logical(u, i + 1, j, ny, nrows, ncols);
  const float lf = load_logical(u, i, j - 1, ny, nrows, ncols);
  const float rt = load_logical(u, i, j + 1, ny, nrows, ncols);
  float o = k.a * (c0 - up) + k.b * (c0 - dn) + k.c * (c0 - lf) +
            k.d * (c0 - rt);
  o = o + k.e * c0;
  *uc = c0;
  return o;
}

// K1 and K2 geometry.  A block of kStepRows warps owns a strip of kStrip
// columns (4 per lane) and a run of `steps` * kStepRows rows; each step
// computes kStepRows rows, one per warp.  Shared memory holds rings of
// rows, each row the strip's columns j0-4 .. j0+131 (column j0 + c at
// index c + kHalo; K2's 2-column halo, K1's 1-column one, widened to
// whole 16-byte groups).  K1 stages a row whose start is off 16-byte
// alignment by its aligned superset instead: column j0 + c at index
// c + kHalo + o, with o the row start's distance in floats from the
// 16-byte boundary below it, so indices 0 .. 135 still hold it.
constexpr int kStrip = 128;
constexpr int kStepRows = 8;
constexpr int kJacobiThreads = 32 * kStepRows;
constexpr int kHalo = 4;
constexpr int kPitch = kStrip + 2 * kHalo;
// ring depths: rows a step reads plus rows the next step's loads write
// (u: 10 + 8, g: 9 + 8) and the 10 rows of v a step's output reads
constexpr int kURing = 18;
constexpr int kGRing = 18;
constexpr int kVRing = 10;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of `bytes` valid bytes (the rest of the cp-size
// zero-filled, none read) from device to shared memory.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Distance in floats of row i's start from the 16-byte boundary at or
// below it (0 for every row of a 16-byte aligned buffer with ny % 4 == 0).
__device__ __forceinline__ int row_offset(const float* base, int i, int ny) {
  return static_cast<int>(
      (reinterpret_cast<uintptr_t>(base + (ptrdiff_t)i * ny) >> 2) & 3);
}

// Stage the four columns c-o .. c-o+3 of row i of a (nx, ny) buffer into
// dst: those on the logical region and any before column 0 (the previous
// row's, which the reader masks); zeros past ncols and for a row off the
// logical region (the pads are never read).  `vec`: one 16-byte copy (the
// group 16-byte aligned), else four 4-byte copies (o = 0 only).  A copied
// group always holds an element of row i, so an aligned 16-byte copy of
// it never leaves the buffer's pages.
__device__ __forceinline__ void stage_group(float* dst,
                                            const float* __restrict__ src,
                                            int i, int c, int o, int ny,
                                            int nrows, int ncols, bool vec) {
  const int s = c - o;
  const int valid = (i >= 0 && i < nrows && s + 4 > 0)
                        ? min(max(ncols - s, 0), 4)
                        : 0;
  const float* p = valid > 0 ? src + (ptrdiff_t)i * ny + s : src;
  if (vec) {
    cp_async16(dst, p, 4 * valid);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cp_async4(dst + k, k < valid ? p + k : src, k < valid ? 4 : 0);
    }
  }
}

// One warp stages row i of the strip into a ring row: lane l the group at
// column j0 + 4l, lanes 0 and 1 also the halo groups at j0-4 and j0+128,
// each shifted back by the row's offset o.
__device__ __forceinline__ void stage_row(float* row,
                                          const float* __restrict__ src,
                                          int i, int j0, int o, int ny,
                                          int nrows, int ncols, bool vec) {
  const int lane = threadIdx.x & 31;
  stage_group(row + kHalo + 4 * lane, src, i, j0 + 4 * lane, o, ny, nrows,
              ncols, vec);
  if (lane < 2) {
    const int c = lane == 0 ? -kHalo : kStrip;
    stage_group(row + kHalo + c, src, i, j0 + c, o, ny, nrows, ncols, vec);
  }
}

// One damped-Jacobi sweep in the K1 form at one point: the grouped
// stencil, + e*c0, + alpha*c0, + beta*g, in the order of the Pallas
// kernel.
__device__ __forceinline__ float sweep_at(float c0, float up, float dn,
                                          float lf, float rt, float g,
                                          Coeffs k, float alpha,
                                          float beta) {
  float o = k.a * (c0 - up) + k.b * (c0 - dn) + k.c * (c0 - lf) +
            k.d * (c0 - rt);
  o = o + k.e * c0;
  o = o + alpha * c0;
  o = o + beta * g;
  return o;
}

// One warp applies a sweep to row i of the strip from the ring rows
// above, at and below it (`up`, `mid`, `dn`) and g's row: lane l the
// columns j0 + 4l .. j0 + 4l + 3, left and right neighbours across lanes
// by shuffle and at the strip's edges from the halo.  Zero off the
// logical region.  Returns the lane's four values; with `halo`, lanes 0
// and 1 also return the value at column j0 - 1 and j0 + 128 (in *edge).
__device__ __forceinline__ float4 sweep_row(const float* up, const float* mid,
                                            const float* dn, const float* g,
                                            int i, int j0, int nrows,
                                            int ncols, Coeffs k, float alpha,
                                            float beta, bool halo,
                                            float* edge) {
  const int lane = threadIdx.x & 31;
  const int x = kHalo + 4 * lane;
  const float4 cu = *reinterpret_cast<const float4*>(mid + x);
  const float4 cau = *reinterpret_cast<const float4*>(up + x);
  const float4 cad = *reinterpret_cast<const float4*>(dn + x);
  const float4 cg = *reinterpret_cast<const float4*>(g + x);
  float lf = __shfl_up_sync(0xffffffffu, cu.w, 1);
  float rt = __shfl_down_sync(0xffffffffu, cu.x, 1);
  if (lane == 0) lf = mid[kHalo - 1];
  if (lane == 31) rt = mid[kHalo + kStrip];
  const bool row_in = i >= 0 && i < nrows;
  const int j = j0 + 4 * lane;
  float4 o;
  o.x = (row_in && j < ncols)
            ? sweep_at(cu.x, cau.x, cad.x, lf, cu.y, cg.x, k, alpha, beta)
            : 0.0f;
  o.y = (row_in && j + 1 < ncols)
            ? sweep_at(cu.y, cau.y, cad.y, cu.x, cu.z, cg.y, k, alpha, beta)
            : 0.0f;
  o.z = (row_in && j + 2 < ncols)
            ? sweep_at(cu.z, cau.z, cad.z, cu.y, cu.w, cg.z, k, alpha, beta)
            : 0.0f;
  o.w = (row_in && j + 3 < ncols)
            ? sweep_at(cu.w, cau.w, cad.w, cu.z, rt, cg.w, k, alpha, beta)
            : 0.0f;
  if (halo && lane < 2) {
    const int c = lane == 0 ? -1 : kStrip;  // strip column of the value
    const int xs = kHalo + c;
    *edge = (row_in && j0 + c >= 0 && j0 + c < ncols)
                ? sweep_at(mid[xs], up[xs], dn[xs], mid[xs - 1],
                           mid[xs + 1], g[xs], k, alpha, beta)
                : 0.0f;
  }
  return o;
}

// K2.  Replaces krypy_tpu/kernels/stencil.py:stencil5_jacobi2
// (_make_jacobi2_kernel): two damped-Jacobi sweeps
//   v = u + w(g - A u),  out = s (v + w(g - A v))
// in one pass, each sweep in the K1 form with its own constants (k1,
// alpha=1, beta=w; k2, alpha=s, beta=s*w).
//
// Bound: device memory, 3 streams (u, g, out; 12 bytes per point against
// ~30 flops).  The point of the TPU kernel is kept: v never goes to
// device memory.  Design: the block marches down its strip.  At each
// step every warp stages one new row of u and one of g into the rings
// with cp.async (16-byte copies; zero-filled off the logical region, so
// the pads are never read) for the NEXT step while the block computes
// this step: one row of v per warp (from u rows i-1..i+1 and g) into the
// v ring, a barrier, one row of output per warp (from v rows i-1..i+1)
// with 16-byte stores.  The rows above and below a step stay in the
// rings, so u is read (run + 4) / run times and g (run + 2) / run times,
// and the 2-column halo costs 8 / 128 more (it shares its sectors with
// the neighbouring strip's own groups).  No division in the fill loops;
// two barriers per step of 8 rows.  The wrapper picks the run length
// from the shape alone (kernels/stencil.py: jacobi2_grid); the C entry
// sets the grid from it.
__global__ void __launch_bounds__(kJacobiThreads)
    stencil5_jacobi2_kernel(const float* __restrict__ u,
                            const float* __restrict__ g,
                            float* __restrict__ out, int nx, int ny,
                            int nrows, int ncols, Coeffs k1, float beta1,
                            Coeffs k2, float alpha2, float beta2,
                            int steps) {
  __shared__ __align__(16) float su[kURing][kPitch];
  __shared__ __align__(16) float sg[kGRing][kPitch];
  __shared__ __align__(16) float sv[kVRing][kPitch];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kStrip;
  const int i0 = blockIdx.y * steps * kStepRows;
  const int i_end = min(nx, i0 + steps * kStepRows);  // output rows
  const bool aligned = ny % 4 == 0;
  const bool vec_in = aligned && (reinterpret_cast<uintptr_t>(u) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool vec_out =
      aligned && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  // ring rows: u from row i0-2, g from i0-1, v from i0-1
  auto urow = [&](int i) { return su[(i - i0 + 2) % kURing]; };
  auto grow = [&](int i) { return sg[(i - i0 + 1) % kGRing]; };
  auto vrow = [&](int i) { return sv[(i - i0 + 1) % kVRing]; };
  // the run's output rows need v on rows i0-1 .. i_end, so u on rows
  // i0-2 .. i_end+1 and g on rows i0-1 .. i_end
  const int u_end = i_end + 2, g_end = i_end + 1;

  // prologue: u rows i0-2 .. i0+9, g rows i0-1 .. i0+8, then v rows i0-1
  // and i0
  for (int i = i0 - 2 + warp; i < min(i0 + 10, u_end); i += kStepRows) {
    stage_row(urow(i), u, i, j0, 0, ny, nrows, ncols, vec_in);
  }
  for (int i = i0 - 1 + warp; i < min(i0 + 9, g_end); i += kStepRows) {
    stage_row(grow(i), g, i, j0, 0, ny, nrows, ncols, vec_in);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (warp < 2) {
    const int i = i0 - 1 + warp;
    float edge = 0.0f;
    const float4 v = sweep_row(urow(i - 1), urow(i), urow(i + 1), grow(i), i,
                               j0, nrows, ncols, k1, 1.0f, beta1, true,
                               &edge);
    float* vr = vrow(i);
    *reinterpret_cast<float4*>(vr + kHalo + 4 * lane) = v;
    if (lane < 2) vr[lane == 0 ? kHalo - 1 : kHalo + kStrip] = edge;
  }
  __syncthreads();  // the next loads reuse the ring rows read above

  for (int b = i0; b < i_end; b += kStepRows) {
    // the next step's rows: u b+10 .. b+17, g b+9 .. b+16
    if (b + 10 + warp < u_end) {
      stage_row(urow(b + 10 + warp), u, b + 10 + warp, j0, 0, ny, nrows,
                ncols, vec_in);
    }
    if (b + 9 + warp < g_end) {
      stage_row(grow(b + 9 + warp), g, b + 9 + warp, j0, 0, ny, nrows,
                ncols, vec_in);
    }
    cp_async_commit();
    // sweep 1: v on rows b+1 .. b+8 (as far as the run needs)
    {
      const int i = b + 1 + warp;
      if (i <= i_end) {
        float edge = 0.0f;
        const float4 v = sweep_row(urow(i - 1), urow(i), urow(i + 1),
                                   grow(i), i, j0, nrows, ncols, k1, 1.0f,
                                   beta1, true, &edge);
        float* vr = vrow(i);
        *reinterpret_cast<float4*>(vr + kHalo + 4 * lane) = v;
        if (lane < 2) vr[lane == 0 ? kHalo - 1 : kHalo + kStrip] = edge;
      }
    }
    __syncthreads();
    // sweep 2: output rows b .. b+7
    {
      const int i = b + warp;
      if (i < i_end) {
        const float4 o = sweep_row(vrow(i - 1), vrow(i), vrow(i + 1),
                                   grow(i), i, j0, nrows, ncols, k2, alpha2,
                                   beta2, false, nullptr);
        const int j = j0 + 4 * lane;
        float* dst = out + (size_t)i * ny + j;
        if (vec_out && j + 3 < ny) {
          *reinterpret_cast<float4*>(dst) = o;
        } else {
          if (j < ny) dst[0] = o.x;
          if (j + 1 < ny) dst[1] = o.y;
          if (j + 2 < ny) dst[2] = o.z;
          if (j + 3 < ny) dst[3] = o.w;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// The four values at indices o .. o+3 of the eight in (a, b); o in 0..3,
// the same across the warp.
__device__ __forceinline__ float4 shift4(float4 a, float4 b, int o) {
  switch (o) {
    case 0:
      return a;
    case 1:
      return make_float4(a.y, a.z, a.w, b.x);
    case 2:
      return make_float4(a.z, a.w, b.x, b.y);
    default:
      return make_float4(a.w, b.x, b.y, b.z);
  }
}

// The four values at ring-row indices x .. x+3 (x >= 1, the same across
// the warp but for a multiple of 4 per lane), and in *next the one at
// x+4: two 16-byte shared-memory reads.
__device__ __forceinline__ float4 ring_at(const float* row, int x,
                                          float* next) {
  const int o = x & 3;
  const float4 a = *reinterpret_cast<const float4*>(row + (x - o));
  const float4 b = *reinterpret_cast<const float4*>(row + (x - o) + 4);
  *next = o == 0 ? b.x : o == 1 ? b.y : o == 2 ? b.z : b.w;
  return shift4(a, b, o);
}

// K1 ring depths: the 10 rows of u a step reads plus the 8 the next step's
// loads write; g's 8 plus 8
constexpr int kAffineURing = 18;
constexpr int kAffineGRing = 16;

// K1.  Replaces krypy_tpu/kernels/stencil.py:stencil5_affine
// (_make_stencil5_kernel):
//   out = alpha*u + beta*g + a(u-up) + b(u-dn) + c(u-lf) + d(u-rt) + e*u
// on the logical region, zero elsewhere.  g may be null (beta unused).
//
// Bound: device memory.  It moves 3 streams (u, g, out; 2 without g)
// and does ~15 flops per 12 bytes.  Design: K2's row-ring tiles with one
// sweep.  The block marches down its strip (K2's runs,
// kernels/stencil.py: affine_grid); at each step every warp stages one
// new row of u (and of g) with 16-byte cp.async copies for the NEXT step
// while the block computes this step, one output row per warp from the
// ring rows above, at and below it, so each row of u is read once per
// run of rows (and its halo groups from the neighbouring strips).  Rows
// that start off 16-byte alignment (the odd widths of the unpadded
// V-cycle, 4095, 2047, ...) take the same path: each row is staged as its
// aligned superset (stage_row's offset), and the strip covers each row in
// the frame of its OUTPUT's alignment (columns j0 - o .. j0 - o + 127 for
// an output row o floats past a 16-byte boundary), so every lane stores
// one aligned 16-byte group and only the groups at a row's two ends are
// stored a float at a time; the inputs are read at their offset against
// that frame (ring_at).  The staged copies are zero off the logical
// region except before column 0 (the row above's elements), which the
// row computation masks: the Dirichlet zero.  One barrier per step of 8
// rows.
//
// K8's form (kHaloRows).  Replaces the per-shard body of
// krypy_tpu/kernels/stencil.py:stencil5_sharded: stencil5_pipelined on
// the rank's row block, then `.at[0].add(cu * top)` and
// `.at[-1].add(cd * bot)`, which XLA fuses on the TPU and which on the
// card were four more launches on two rows.  Row -1 of u is read from
// `top` and row nrows from `bot`, each one row of ncols values (a null
// pointer is the Dirichlet zero), so the edge rows of a rank's block are
// computed whole with their true neighbours in the same per-point
// arithmetic as every other row (the gathered result is the one-device
// K1 matvec bit for bit), and no fix-up follows.  A halo row is staged
// like any row of u (at its own 16-byte offset), from device memory or
// from pinned host memory mapped into the device's address space.  Bound
// as K1: device memory, the block read and written once, 2 rows more.
// Only the runs that read row -1 or row nrows take the halo rows' code;
// the last run, which reads bot, is scheduled second, so a halo row's
// latency in host memory overlaps the other blocks' work.  Without halos
// (kHaloRows false) the kernel is K1 as before.
//
// A launch computes the output rows [begin, end) of one or two segments
// (blockIdx.z), each in runs of `steps` steps: K1 and K8 one segment of
// every row; K8 with its exchange in flight the interior rows [1, nx-1)
// first and then rows 0 and nx-1 as two one-row segments.
struct Segments {
  int begin0, end0, begin1, end1;
};

// One block's run of K1: the output rows [i0, i_end) of its strip.  With
// kHaloRows, row -1 of u is top's and row nrows bot's.
template <bool kHaloRows>
__device__ __forceinline__ void affine_run(
    float (*su)[kPitch], float (*sg)[kPitch], const float* __restrict__ u,
    const float* __restrict__ g, const float* __restrict__ top,
    const float* __restrict__ bot, float* __restrict__ out, int ny,
    int nrows, int ncols, Coeffs k, float alpha, float beta, int i0,
    int i_end) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kStrip;
  const bool has_g = g != nullptr;
  // ring rows: u from row i0-1, g from i0
  auto urow = [&](int i) { return su[(i - i0 + 1) % kAffineURing]; };
  auto grow = [&](int i) { return sg[(i - i0) % kAffineGRing]; };
  // where row i of u is read: row `r` of `p`, inside while r < n
  struct RowSrc {
    const float* p;
    int r, n;
  };
  auto src_of = [&](int i) {
    if (kHaloRows) {
      if (i == -1 && top != nullptr) return RowSrc{top, 0, 1};
      if (i == nrows && bot != nullptr) return RowSrc{bot, 0, 1};
    }
    return RowSrc{u, i, nrows};
  };
  auto u_off = [&](int i) {
    const RowSrc s = src_of(i);
    return row_offset(s.p, s.r, ny);
  };
  auto stage_u = [&](int i) {
    const RowSrc s = src_of(i);
    stage_row(urow(i), s.p, s.r, j0, row_offset(s.p, s.r, ny), ny, s.n,
              ncols, true);
  };
  auto stage_g = [&](int i) {
    stage_row(grow(i), g, i, j0, row_offset(g, i, ny), ny, nrows, ncols,
              true);
  };
  // the run's output rows need u on rows i0-1 .. i_end and g on i0 ..
  // i_end-1
  const int u_end = i_end + 1;

  // prologue: u rows i0-1 .. i0+8, g rows i0 .. i0+7
  for (int i = i0 - 1 + warp; i < min(i0 + 9, u_end); i += kStepRows) {
    stage_u(i);
  }
  if (has_g && i0 + warp < i_end) stage_g(i0 + warp);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int b = i0; b < i_end; b += kStepRows) {
    // the next step's rows: u b+9 .. b+16, g b+8 .. b+15
    if (b + 9 + warp < u_end) stage_u(b + 9 + warp);
    if (has_g && b + 8 + warp < i_end) stage_g(b + 8 + warp);
    cp_async_commit();
    const int i = b + warp;
    if (i < i_end) {
      // the lane's columns j .. j+3 in the output row's aligned frame; a
      // row staged with offset o' holds column J at kHalo + J - j0 + o'
      const int oo = row_offset(out, i, ny);
      const int j = j0 - oo + 4 * lane;
      const int x = kHalo + 4 * lane - oo;
      const int xu = x + u_off(i);
      float rt, unused;
      const float4 cu = ring_at(urow(i), xu, &rt);
      const float4 cau = ring_at(urow(i - 1), x + u_off(i - 1), &unused);
      const float4 cad = ring_at(urow(i + 1), x + u_off(i + 1), &unused);
      const float4 cg =
          has_g ? ring_at(grow(i), x + row_offset(g, i, ny), &unused)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float lf = __shfl_up_sync(0xffffffffu, cu.w, 1);
      if (lane == 0) lf = urow(i)[xu - 1];
      const float c0[4] = {cu.x, cu.y, cu.z, cu.w};
      const float up[4] = {cau.x, cau.y, cau.z, cau.w};
      const float dn[4] = {cad.x, cad.y, cad.z, cad.w};
      const float gg[4] = {cg.x, cg.y, cg.z, cg.w};
      const float left[4] = {lf, cu.x, cu.y, cu.z};
      const float right[4] = {cu.y, cu.z, cu.w, rt};
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // left of column 0 the staged value is the row above's
        const float lq = j + q > 0 ? left[q] : 0.0f;
        float v = k.a * (c0[q] - up[q]) + k.b * (c0[q] - dn[q]) +
                  k.c * (c0[q] - lq) + k.d * (c0[q] - right[q]);
        v = v + k.e * c0[q];
        v = v + alpha * c0[q];
        if (has_g) v = v + beta * gg[q];
        o[q] = (i < nrows && j + q >= 0 && j + q < ncols) ? v : 0.0f;
      }
      float* dst = out + (ptrdiff_t)i * ny + j;
      if (j >= 0 && j + 3 < ny) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + q >= 0 && j + q < ny) dst[q] = o[q];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <bool kHaloRows>
__global__ void __launch_bounds__(kJacobiThreads)
    stencil5_affine_kernel(const float* __restrict__ u,
                           const float* __restrict__ g,
                           const float* __restrict__ top,
                           const float* __restrict__ bot,
                           float* __restrict__ out, int nx, int ny,
                           int nrows, int ncols, Coeffs k, float alpha,
                           float beta, Segments seg, int steps) {
  __shared__ __align__(16) float su[kAffineURing][kPitch];
  __shared__ __align__(16) float sg[kAffineGRing][kPitch];
  const int h = steps * kStepRows;
  const int begin = blockIdx.z ? seg.begin1 : seg.begin0;
  const int end = blockIdx.z ? seg.end1 : seg.end0;
  int run = blockIdx.y;
  if (kHaloRows) {
    // the segment's last run (which reads bot) goes second, so that the
    // latency of a halo row in host memory overlaps the other blocks'
    // work rather than adding to the kernel's tail
    const int runs = (end - begin + h - 1) / h;
    if (runs > 2 && run > 0) run = run == 1 ? runs - 1 : run - 1;
  }
  const int i0 = begin + run * h;
  const int i_end = min(end, i0 + h);  // output rows
  if (i0 >= i_end) return;  // past its segment: the whole block
  // only a run that reads row -1 or row nrows takes the halo rows' code
  if (kHaloRows && (i0 == 0 || i_end >= nrows)) {
    affine_run<true>(su, sg, u, g, top, bot, out, ny, nrows, ncols, k,
                     alpha, beta, i0, i_end);
  } else {
    affine_run<false>(su, sg, u, g, nullptr, nullptr, out, ny, nrows,
                      ncols, k, alpha, beta, i0, i_end);
  }
}

// K1's coarse form: `sweeps` damped-Jacobi sweeps from zero,
//   u <- u + w (r - A u),   A u = a(u-up) + b(u-dn) + c(u-lf) + d(u-rt) + e*u,
// on the (nrows, ncols) logical region of an (nx, ny) buffer, zero
// elsewhere: the coarsest level's solve of both V-cycles (the JAX
// package's `u = w r` and `coarse_sweeps - 1` further sweeps on the padded
// lane, `coarse_sweeps` sweeps from zero on the unpadded one; the first
// sweep from zero IS w r).  Every product and sum is rounded on its own
// (no FMA contraction: __fmul_rn / __fadd_rn), in the plain version's
// order, so the two agree bit for bit and the V-cycles' coarse solve
// keeps the rounding their plain coarse steps had (with FMA, bench.py's
// Poisson solve took 16 inner iterations against the reference's 17 to
// 21 on the H100).  ONE block holds u (double-buffered, each with a
// zero border: the Dirichlet ghost) and r in shared memory, so the grid
// goes to device memory once each way; a barrier between sweeps.  Bound:
// the sweeps' latency on one SM, not bytes (the wrapper dispatches by
// size: kernels/stencil.py: coarse_fits).
__global__ void __launch_bounds__(1024)
    stencil5_coarse_kernel(const float* __restrict__ r,
                           float* __restrict__ out, int nx, int ny,
                           int nrows, int ncols, Coeffs k, float w,
                           int sweeps) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = ncols + 2;
  const int plane = (nrows + 2) * pitch;
  const int npts = nrows * ncols;
  float* ua = smem;
  float* ub = smem + plane;
  float* rs = smem + 2 * plane;
  for (int t = threadIdx.x; t < 2 * plane; t += blockDim.x) smem[t] = 0.0f;
  for (int t = threadIdx.x; t < npts; t += blockDim.x) {
    const int i = t / ncols, j = t - i * ncols;
    rs[t] = r[(ptrdiff_t)i * ny + j];
  }
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) {
    for (int t = threadIdx.x; t < npts; t += blockDim.x) {
      const int i = t / ncols, j = t - i * ncols;
      const int x = (i + 1) * pitch + j + 1;
      const float c0 = ua[x];
      float au = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(k.a, c0 - ua[x - pitch]),
                              __fmul_rn(k.b, c0 - ua[x + pitch])),
                    __fmul_rn(k.c, c0 - ua[x - 1])),
          __fmul_rn(k.d, c0 - ua[x + 1]));
      au = __fadd_rn(au, __fmul_rn(k.e, c0));
      ub[x] = __fadd_rn(c0, __fmul_rn(w, rs[t] - au));
    }
    __syncthreads();
    float* tmp = ua;
    ua = ub;
    ub = tmp;
  }
  for (int t = threadIdx.x; t < nx * ny; t += blockDim.x) {
    const int i = t / ny, j = t - i * ny;
    out[t] = (i < nrows && j < ncols) ? ua[(i + 1) * pitch + j + 1] : 0.0f;
  }
}

// K3.  Replaces krypy_tpu/kernels/stencil.py:stencil5_resrestrict_rows
// (_make_resrestrict_kernel): the residual res = g + S(u) (S given with
// negated coefficients) and the full-weighting row restriction
//   out[I] = 0.25 res[2I] + 0.5 res[2I+1] + 0.25 res[2I+2]
// for I < (nrows-1)/2 and j < ncols, zero elsewhere; out is (nx/2, ny).
//
// Bound: device memory, 2.5 streams (u and g read once, out at half
// height).  One thread per coarse output recomputes res at its three
// fine rows from u and g; the strided reads replace the TPU kernel's
// banded MXU matmul, and the row shared by two neighbouring outputs is
// recomputed rather than exchanged.  Left for later: a shared-memory
// tile of res so each fine row is computed once.
__global__ void stencil5_resrestrict_rows_kernel(
    const float* __restrict__ u, const float* __restrict__ g,
    float* __restrict__ out, int nx, int ny, int nrows, int ncols,
    Coeffs k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int I = blockIdx.y * blockDim.y + threadIdx.y;
  if (I >= nx / 2 || j >= ny) return;
  const int ncoarse = (nrows - 1) / 2;
  float o = 0.0f;
  if (I < ncoarse && j < ncols) {
    float c0;
    const int i = 2 * I;
    const float r0 = stencil_at(u, i, j, ny, nrows, ncols, k, &c0) +
                     g[(size_t)i * ny + j];
    const float r1 = stencil_at(u, i + 1, j, ny, nrows, ncols, k, &c0) +
                     g[(size_t)(i + 1) * ny + j];
    const float r2 = stencil_at(u, i + 2, j, ny, nrows, ncols, k, &c0) +
                     g[(size_t)(i + 2) * ny + j];
    o = 0.25f * r0 + 0.5f * r1 + 0.25f * r2;
  }
  out[(size_t)I * ny + j] = o;
}

dim3 grid_for(int rows, int cols, dim3 block) {
  return dim3((cols + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
}

}  // namespace

extern "C" {

int krypy_stencil5_affine(const float* u, const float* g, const float* top,
                          const float* bot, float* out, int nx, int ny,
                          int nrows, int ncols, float a, float b, float c,
                          float d, float e, float alpha, float beta,
                          int begin0, int end0, int begin1, int end1,
                          int strip, int step_rows, int strips, int steps,
                          void* stream) {
  // The wrapper sizes the grid with its own copy of the geometry
  // (kernels/stencil.py: affine_grid); refuse any other.  Where the
  // output's rows do not all start 16-byte aligned, each row's strips
  // start up to 3 columns early (its aligned frame), so one more strip
  // may be needed.  Segment 0 must hold rows; segment 1 may be empty.
  const bool aligned =
      ny % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int want = (ny + (aligned ? 0 : 3) + kStrip - 1) / kStrip;
  const bool two = end1 > begin1;
  if (strip != kStrip || step_rows != kStepRows || strips != want ||
      steps < 1 || begin0 < 0 || end0 <= begin0 || end0 > nx ||
      (two && (begin1 < 0 || end1 > nx))) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = max(end0 - begin0, two ? end1 - begin1 : 0);
  const int runs = (rows + steps * kStepRows - 1) / (steps * kStepRows);
  const dim3 grid(want, runs, two ? 2 : 1);
  const Segments seg{begin0, end0, begin1, end1};
  const Coeffs k{a, b, c, d, e};
  if (top != nullptr || bot != nullptr) {
    stencil5_affine_kernel<true><<<grid, kJacobiThreads, 0,
                                   (cudaStream_t)stream>>>(
        u, g, top, bot, out, nx, ny, nrows, ncols, k, alpha, beta, seg,
        steps);
  } else {
    stencil5_affine_kernel<false><<<grid, kJacobiThreads, 0,
                                    (cudaStream_t)stream>>>(
        u, g, nullptr, nullptr, out, nx, ny, nrows, ncols, k, alpha, beta,
        seg, steps);
  }
  return (int)cudaGetLastError();
}

// One staging copy of `height` rows of `width` bytes, `spitch` bytes apart
// in src and `dpitch` in dst, between any two of device and pinned host
// memory (the direction from the pointers): K8's halo rows through host
// memory, both edge rows of a row block in one copy.
int krypy_copy_rows(void* dst, long long dpitch, const void* src,
                    long long spitch, long long width, long long height,
                    void* stream) {
  return (int)cudaMemcpy2DAsync(dst, (size_t)dpitch, src, (size_t)spitch,
                                (size_t)width, (size_t)height,
                                cudaMemcpyDefault, (cudaStream_t)stream);
}

// Shared memory of the coarse form: two bordered planes of u and r.
static size_t coarse_smem(int nrows, int ncols) {
  return sizeof(float) * (2 * (size_t)(nrows + 2) * (ncols + 2) +
                          (size_t)nrows * ncols);
}

int krypy_stencil5_coarse(const float* r, float* out, int nx, int ny,
                          int nrows, int ncols, float a, float b, float c,
                          float d, float e, float w, int sweeps,
                          int max_smem, void* stream) {
  // the wrapper's limit (kernels/stencil.py: COARSE_MAX_SMEM) must be the
  // kernel's own; a grid above it keeps the per-sweep K1 launches
  const size_t smem = coarse_smem(nrows, ncols);
  if (max_smem != 232448 || smem > (size_t)max_smem || sweeps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil5_coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int pts = nrows * ncols;
  const int threads = min(1024, max(32, (pts + 31) / 32 * 32));
  stencil5_coarse_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      r, out, nx, ny, nrows, ncols, Coeffs{a, b, c, d, e}, w, sweeps);
  return (int)cudaGetLastError();
}

int krypy_stencil5_jacobi2(const float* u, const float* g, float* out, int nx,
                           int ny, int nrows, int ncols, float a1, float b1,
                           float c1, float d1, float e1, float beta1,
                           float a2, float b2, float c2, float d2, float e2,
                           float alpha2, float beta2, int strip,
                           int step_rows, int steps, void* stream) {
  // The wrapper sizes its grid with its own copy of the geometry
  // (kernels/stencil.py: JACOBI2_STRIP, JACOBI2_STEP_ROWS); refuse any
  // other, so that no block skips or repeats an output.
  if (strip != kStrip || step_rows != kStepRows || steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int strips = (ny + kStrip - 1) / kStrip;
  const int runs = (nx + steps * kStepRows - 1) / (steps * kStepRows);
  stencil5_jacobi2_kernel<<<dim3(strips, runs), kJacobiThreads, 0,
                            (cudaStream_t)stream>>>(
      u, g, out, nx, ny, nrows, ncols, Coeffs{a1, b1, c1, d1, e1}, beta1,
      Coeffs{a2, b2, c2, d2, e2}, alpha2, beta2, steps);
  return (int)cudaGetLastError();
}

int krypy_stencil5_resrestrict_rows(const float* u, const float* g,
                                    float* out, int nx, int ny, int nrows,
                                    int ncols, float a, float b, float c,
                                    float d, float e, void* stream) {
  const dim3 block(32, 8);
  stencil5_resrestrict_rows_kernel<<<grid_for(nx / 2, ny, block), block, 0,
                                     (cudaStream_t)stream>>>(
      u, g, out, nx, ny, nrows, ncols, Coeffs{a, b, c, d, e});
  return (int)cudaGetLastError();
}

}  // extern "C"
