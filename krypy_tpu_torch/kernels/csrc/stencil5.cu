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

// K1.  Replaces krypy_tpu/kernels/stencil.py:stencil5_affine
// (_make_stencil5_kernel):
//   out = alpha*u + beta*g + a(u-up) + b(u-dn) + c(u-lf) + d(u-rt) + e*u
// on the logical region, zero elsewhere.  g may be null (beta unused).
//
// Bound: device memory.  It moves 3 streams (u, g, out; 2 without g)
// and does ~15 flops per 12 bytes.  This simple design runs one thread
// per output element in a 2-D grid whose x dimension walks along a row,
// so each warp reads and writes 128 contiguous bytes; the four
// neighbour reads hit L1/L2.  Left for later: shared-memory or TMA
// tiles with cp.async double-buffering, and vectorised 16-byte access.
__global__ void stencil5_affine_kernel(const float* __restrict__ u,
                                       const float* __restrict__ g,
                                       float* __restrict__ out, int nx,
                                       int ny, int nrows, int ncols,
                                       Coeffs k, float alpha, float beta) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  float o = 0.0f;
  if (i < nrows && j < ncols) {
    float c0;
    o = stencil_at(u, i, j, ny, nrows, ncols, k, &c0);
    o = o + alpha * c0;
    if (g != nullptr) o = o + beta * g[(size_t)i * ny + j];
  }
  out[(size_t)i * ny + j] = o;
}

// K2 geometry.  A block of kStepRows warps owns a strip of kStrip
// columns (4 per lane) and a run of `steps` * kStepRows rows; each step
// computes kStepRows rows, one per warp.  Shared memory holds rings of
// rows, each row the strip's columns j0-4 .. j0+131 (column j0 + c at
// index c + kHalo; the 2-column halo that the two sweeps need, widened to
// whole 16-byte groups).
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

// Stage columns c .. c+3 of row i of a (nx, ny) buffer into dst: the
// values on the logical region, zeros elsewhere (the pads are never
// read).  `vec`: one 16-byte copy (rows and the base 16-byte aligned),
// else four 4-byte copies.
__device__ __forceinline__ void stage_group(float* dst,
                                            const float* __restrict__ src,
                                            int i, int c, int ny, int nrows,
                                            int ncols, bool vec) {
  const int valid = (i >= 0 && i < nrows && c >= 0)
                        ? min(max(ncols - c, 0), 4)
                        : 0;
  const float* p = valid > 0 ? src + (size_t)i * ny + c : src;
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
// column j0 + 4l, lanes 0 and 1 also the halo groups at j0-4 and j0+128.
__device__ __forceinline__ void stage_row(float* row,
                                          const float* __restrict__ src,
                                          int i, int j0, int ny, int nrows,
                                          int ncols, bool vec) {
  const int lane = threadIdx.x & 31;
  stage_group(row + kHalo + 4 * lane, src, i, j0 + 4 * lane, ny, nrows,
              ncols, vec);
  if (lane < 2) {
    const int c = lane == 0 ? -kHalo : kStrip;
    stage_group(row + kHalo + c, src, i, j0 + c, ny, nrows, ncols, vec);
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
    stage_row(urow(i), u, i, j0, ny, nrows, ncols, vec_in);
  }
  for (int i = i0 - 1 + warp; i < min(i0 + 9, g_end); i += kStepRows) {
    stage_row(grow(i), g, i, j0, ny, nrows, ncols, vec_in);
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
      stage_row(urow(b + 10 + warp), u, b + 10 + warp, j0, ny, nrows, ncols,
                vec_in);
    }
    if (b + 9 + warp < g_end) {
      stage_row(grow(b + 9 + warp), g, b + 9 + warp, j0, ny, nrows, ncols,
                vec_in);
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

int krypy_stencil5_affine(const float* u, const float* g, float* out, int nx,
                          int ny, int nrows, int ncols, float a, float b,
                          float c, float d, float e, float alpha, float beta,
                          void* stream) {
  const dim3 block(32, 8);
  stencil5_affine_kernel<<<grid_for(nx, ny, block), block, 0,
                           (cudaStream_t)stream>>>(
      u, g, out, nx, ny, nrows, ncols, Coeffs{a, b, c, d, e}, alpha, beta);
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
