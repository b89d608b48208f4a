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

// K2 tile: TY x TX outputs per block of TX x TY threads.
constexpr int TX = 32;
constexpr int TY = 8;

// K2.  Replaces krypy_tpu/kernels/stencil.py:stencil5_jacobi2
// (_make_jacobi2_kernel): two damped-Jacobi sweeps
//   v = u + w(g - A u),  out = s (v + w(g - A v))
// in one pass, each sweep in the K1 form with its own constants (k1,
// alpha=1, beta=w; k2, alpha=s, beta=s*w).
//
// Bound: device memory, 3 streams (u, g, out).  The point of the TPU
// kernel is kept: v never goes to device memory.  The block stages u and
// g over its tile plus a 2-cell halo in shared memory (zero outside the
// logical region), computes v over the tile plus a 1-cell halo (zero
// outside the logical region), then the output tile.  Left for later:
// TMA tile loads, a taller tile (the halo re-reads 1.7x the tile here),
// and a persistent grid.
__global__ void stencil5_jacobi2_kernel(const float* __restrict__ u,
                                        const float* __restrict__ g,
                                        float* __restrict__ out, int nx,
                                        int ny, int nrows, int ncols,
                                        Coeffs k1, float beta1, Coeffs k2,
                                        float alpha2, float beta2) {
  __shared__ float su[TY + 4][TX + 4];
  __shared__ float sg[TY + 2][TX + 2];
  __shared__ float sv[TY + 2][TX + 2];
  const int i0 = blockIdx.y * TY;
  const int j0 = blockIdx.x * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthreads = TX * TY;

  for (int t = tid; t < (TY + 4) * (TX + 4); t += nthreads) {
    const int r = t / (TX + 4), c = t % (TX + 4);
    su[r][c] = load_logical(u, i0 - 2 + r, j0 - 2 + c, ny, nrows, ncols);
  }
  for (int t = tid; t < (TY + 2) * (TX + 2); t += nthreads) {
    const int r = t / (TX + 2), c = t % (TX + 2);
    sg[r][c] = load_logical(g, i0 - 1 + r, j0 - 1 + c, ny, nrows, ncols);
  }
  __syncthreads();

  // sweep 1 on the tile plus a 1-cell halo; v = 0 off the logical region
  for (int t = tid; t < (TY + 2) * (TX + 2); t += nthreads) {
    const int r = t / (TX + 2), c = t % (TX + 2);
    const int i = i0 - 1 + r, j = j0 - 1 + c;
    float v = 0.0f;
    if (i >= 0 && i < nrows && j >= 0 && j < ncols) {
      const float c0 = su[r + 1][c + 1];
      v = k1.a * (c0 - su[r][c + 1]) + k1.b * (c0 - su[r + 2][c + 1]) +
          k1.c * (c0 - su[r + 1][c]) + k1.d * (c0 - su[r + 1][c + 2]);
      v = v + k1.e * c0;
      v = v + c0;  // alpha = 1
      v = v + beta1 * sg[r][c];
    }
    sv[r][c] = v;
  }
  __syncthreads();

  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= nx || j >= ny) return;
  float o = 0.0f;
  if (i < nrows && j < ncols) {
    const int r = threadIdx.y + 1, c = threadIdx.x + 1;
    const float c0 = sv[r][c];
    o = k2.a * (c0 - sv[r - 1][c]) + k2.b * (c0 - sv[r + 1][c]) +
        k2.c * (c0 - sv[r][c - 1]) + k2.d * (c0 - sv[r][c + 1]);
    o = o + k2.e * c0;
    o = o + alpha2 * c0;
    o = o + beta2 * sg[r][c];
  }
  out[(size_t)i * ny + j] = o;
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
                           float alpha2, float beta2, void* stream) {
  const dim3 block(TX, TY);
  stencil5_jacobi2_kernel<<<grid_for(nx, ny, block), block, 0,
                            (cudaStream_t)stream>>>(
      u, g, out, nx, ny, nrows, ncols, Coeffs{a1, b1, c1, d1, e1}, beta1,
      Coeffs{a2, b2, c2, d2, e2}, alpha2, beta2);
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
