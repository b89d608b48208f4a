"""Grid-padded 5-point stencil kernels: CUDA wrappers and their plain
PyTorch versions.

Counterparts of the three Pallas kernels in
``krypy_tpu/kernels/stencil.py`` that the padded multigrid-CG solve runs:

* :func:`stencil5_affine` (K1): ``alpha*u + beta*g + S(u)``, the matvec,
  damped-Jacobi step, residual and collapsed presmooth;
* :func:`stencil5_jacobi2` (K2): two fused damped-Jacobi sweeps;
* :func:`stencil5_resrestrict_rows` (K3): residual plus full-weighting
  row restriction;

and the thin entries over K1 on an unpadded grid (logical region = the
whole buffer), which launch K1 itself: :func:`stencil5_pipelined`,
:func:`laplacian_2d_pipelined`, and :func:`laplacian_2d_kernel` with its
operator constructor :func:`laplacian_2d` (K10, the JAX package's older
manual-copy Laplacian kernel, which its pipelined kernel superseded).

Operands are flat ``(nx*ny,)`` tensors holding a row-major ``(nx, ny)``
buffer whose top-left ``(nrows, ncols)`` corner is the logical Dirichlet
grid.  Each wrapper launches its CUDA kernel (``csrc/stencil5.cu``) for a
float32 tensor on a CUDA device, raises for any other CUDA tensor, and
runs the plain version only for a tensor on the CPU.  The plain versions
read only the logical region and zero everything else, as the kernels do,
and follow the Pallas kernels' arithmetic term for term.
"""

import torch

from ._launch import LAUNCHES, launch_counts, reset_launch_counts  # noqa: F401
from ._launch import launch as _launch

__all__ = [
    "stencil5_affine",
    "stencil5_jacobi2",
    "stencil5_resrestrict_rows",
    "stencil5_pipelined",
    "laplacian_2d_pipelined",
    "laplacian_2d_kernel",
    "laplacian_2d",
    "stencil5_affine_torch",
    "stencil5_jacobi2_torch",
    "stencil5_resrestrict_rows_torch",
    "launch_counts",
    "reset_launch_counts",
]


def _grouped(coeffs):
    """Grouped-difference constants ``(a, b, c, d, e)`` of the operator
    coefficients ``(cc, cu, cd, cl, cr)``, in Python double as the Pallas
    kernels compute them."""
    cc, cu, cd, cl, cr = (float(c) for c in coeffs)
    return -cu, -cd, -cl, -cr, cc + cu + cd + cl + cr


def _check(name, nx, ny, nrows, ncols, *tensors):
    if not (0 < nrows <= nx and 0 < ncols <= ny):
        raise ValueError(f"{name}: logical region ({nrows}, {ncols}) does "
                         f"not fit the ({nx}, {ny}) buffer")
    t0 = tensors[0]
    for t in tensors:
        if t.numel() != nx * ny:
            raise ValueError(f"{name}: operand has {t.numel()} elements, "
                             f"expected {nx}*{ny}")
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if t0.device.type == "cuda":
        if t0.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, "
                            f"got {t0.dtype}")
        return True
    if t0.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {t0.device}")
    return False


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _logical_mask(R, P, nrows, ncols, device):
    rows = torch.arange(R, device=device)[:, None] < nrows
    cols = torch.arange(P, device=device)[None, :] < ncols
    return rows & cols


def stencil5_affine_torch(u, g, coeffs, nrows, ncols, alpha=0.0, beta=0.0):
    """Plain version of K1 on a 2-D ``(R, P)`` buffer: ``alpha*u +
    beta*g + a(u-up) + b(u-dn) + c(u-lf) + d(u-rt) + e*u`` on the
    ``(nrows, ncols)`` logical region, exact zeros elsewhere.  Neighbours
    outside the logical region are the Dirichlet zero; ``g`` may be
    None."""
    a, b, c, d, e = _grouped(coeffs)
    R, P = u.shape
    inside = _logical_mask(R, P, nrows, ncols, u.device)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    uz = torch.where(inside, u, zero)
    zr = torch.zeros((1, P), dtype=u.dtype, device=u.device)
    zc = torch.zeros((R, 1), dtype=u.dtype, device=u.device)
    up = torch.cat([zr, uz[:-1]], 0)
    dn = torch.cat([uz[1:], zr], 0)
    lf = torch.cat([zc, uz[:, :-1]], 1)
    rt = torch.cat([uz[:, 1:], zc], 1)
    out = a * (u - up) + b * (u - dn) + c * (u - lf) + d * (u - rt)
    if e != 0.0:
        out = out + e * u
    if alpha != 0.0:
        out = out + alpha * u
    if g is not None and beta != 0.0:
        out = out + beta * g
    return torch.where(inside, out, zero)


def _jacobi2_stages(coeffs, w, s):
    """Per-sweep ``(coeffs, alpha, beta)`` of K2: sweep k applies
    ``s_k (v + w (g - A v))`` as the affine stencil with coefficients
    ``-s_k w A``, ``alpha = s_k`` and ``beta = s_k w``."""
    lapc = tuple(float(c) for c in coeffs)
    w, s = float(w), float(s)
    return [
        (tuple(-sk * w * c for c in lapc), sk, sk * w) for sk in (1.0, s)
    ]


def stencil5_jacobi2_torch(u, g, coeffs, w, s, nrows, ncols):
    """Plain version of K2 on 2-D buffers: ``v = u + w (g - A u)``, then
    ``s (v + w (g - A v))``, with ``coeffs`` the operator ``A``'s."""
    v = u
    for sc, alpha, beta in _jacobi2_stages(coeffs, w, s):
        v = stencil5_affine_torch(v, g, sc, nrows, ncols, alpha, beta)
    return v


def stencil5_resrestrict_rows_torch(u, g, coeffs, nrows, ncols):
    """Plain version of K3 on 2-D ``(R, P)`` buffers: ``res = g + S(u)``
    (``coeffs`` already negated), then ``out[I] = 0.25 res[2I] + 0.5
    res[2I+1] + 0.25 res[2I+2]`` for ``I < (nrows-1)//2``; the output is
    ``(R//2, P)`` with exact zeros off the coarse logical region."""
    R, P = u.shape
    res = stencil5_affine_torch(u, g, coeffs, nrows, ncols, beta=1.0)
    rl = res[:nrows]
    half = 0.25 * rl[0:-2:2] + 0.5 * rl[1:-1:2] + 0.25 * rl[2::2]
    out = torch.zeros((R // 2, P), dtype=u.dtype, device=u.device)
    out[: half.shape[0]] = half
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def stencil5_affine(x, g=None, *, nx, ny, coeffs, ncols=None, nrows=None,
                    alpha=0.0, beta=0.0):
    """K1: ``out = alpha*x + beta*g + Stencil5(x)`` on the ``(nrows,
    ncols)`` logical region of an ``(nx, ny)`` buffer (flat operands),
    exact zeros elsewhere.  ``coeffs = (cc, cu, cd, cl, cr)``.
    Counterpart of ``krypy_tpu.kernels.stencil.stencil5_affine``."""
    ncols = ny if ncols is None else ncols
    nrows = nx if nrows is None else nrows
    ops = (x,) if g is None else (x, g)
    if not _check("stencil5_affine", nx, ny, nrows, ncols, *ops):
        return stencil5_affine_torch(
            x.reshape(nx, ny), None if g is None else g.reshape(nx, ny),
            coeffs, nrows, ncols, alpha, beta,
        ).reshape(-1)
    out = torch.empty(nx * ny, dtype=x.dtype, device=x.device)
    a, b, c, d, e = _grouped(coeffs)
    _launch(
        "stencil5_affine", "krypy_stencil5_affine",
        (x.data_ptr(), None if g is None else g.data_ptr(), out.data_ptr(),
         nx, ny, nrows, ncols, a, b, c, d, e, float(alpha),
         float(beta) if g is not None else 0.0),
        x.device,
    )
    return out


def stencil5_jacobi2(u, g, *, nx, ny, coeffs, w, s=1.0, ncols, nrows):
    """K2: two damped-Jacobi sweeps ``out = s (v + w (g - A v))`` with
    ``v = u + w (g - A u)`` in one kernel; ``coeffs`` are the operator
    ``A``'s, and ``v`` never goes to device memory.  Counterpart of
    ``krypy_tpu.kernels.stencil.stencil5_jacobi2``."""
    if not _check("stencil5_jacobi2", nx, ny, nrows, ncols, u, g):
        return stencil5_jacobi2_torch(
            u.reshape(nx, ny), g.reshape(nx, ny), coeffs, w, s, nrows,
            ncols,
        ).reshape(-1)
    out = torch.empty(nx * ny, dtype=u.dtype, device=u.device)
    (sc1, _, beta1), (sc2, alpha2, beta2) = _jacobi2_stages(coeffs, w, s)
    _launch(
        "stencil5_jacobi2", "krypy_stencil5_jacobi2",
        (u.data_ptr(), g.data_ptr(), out.data_ptr(), nx, ny, nrows, ncols,
         *_grouped(sc1), beta1, *_grouped(sc2), alpha2, beta2),
        u.device,
    )
    return out


def stencil5_resrestrict_rows(u, g, *, nx, ny, coeffs, ncols, nrows):
    """K3: residual ``res = g + Stencil5(u)`` (pass NEGATED operator
    coefficients) and full-weighting row restriction into a flat
    ``(nx//2 * ny,)`` output, zero off the coarse logical region.
    Counterpart of
    ``krypy_tpu.kernels.stencil.stencil5_resrestrict_rows``."""
    if nx % 2 != 0:
        raise ValueError(f"stencil5_resrestrict_rows: nx must be even, "
                         f"got {nx}")
    if not _check("stencil5_resrestrict_rows", nx, ny, nrows, ncols, u, g):
        return stencil5_resrestrict_rows_torch(
            u.reshape(nx, ny), g.reshape(nx, ny), coeffs, nrows, ncols,
        ).reshape(-1)
    out = torch.empty((nx // 2) * ny, dtype=u.dtype, device=u.device)
    _launch(
        "stencil5_resrestrict_rows", "krypy_stencil5_resrestrict_rows",
        (u.data_ptr(), g.data_ptr(), out.data_ptr(), nx, ny, nrows, ncols,
         *_grouped(coeffs)),
        u.device,
    )
    return out


def stencil5_pipelined(x, *, nx, ny, coeffs):
    """K1 as the matvec of an unpadded ``nx x ny`` Dirichlet grid (flat
    operand; the logical region is the whole buffer).  Counterpart of
    ``krypy_tpu.kernels.stencil.stencil5_pipelined``; launches K1 and
    counts as one ``stencil5_affine`` launch."""
    return stencil5_affine(x, nx=nx, ny=ny, coeffs=coeffs)


def laplacian_2d_pipelined(x, *, nx, ny, hx2=None, hy2=None):
    """5-point Dirichlet Laplacian through :func:`stencil5_pipelined`.
    Counterpart of ``krypy_tpu.kernels.stencil.laplacian_2d_pipelined``."""
    hx2 = (1.0 / (nx + 1)) ** 2 if hx2 is None else hx2
    hy2 = (1.0 / (ny + 1)) ** 2 if hy2 is None else hy2
    return stencil5_pipelined(
        x, nx=nx, ny=ny,
        coeffs=(2.0 / hx2 + 2.0 / hy2, -1.0 / hx2, -1.0 / hx2, -1.0 / hy2,
                -1.0 / hy2),
    )


def laplacian_2d_kernel(x, *, nx, ny, hx2=None, hy2=None):
    """K10: the Dirichlet 5-point Laplacian of the flat vector ``x`` (grid
    ``nx`` x ``ny``) through K1.  Counterpart of
    ``krypy_tpu.kernels.stencil.laplacian_2d_kernel``, whose row-block
    argument and ``nx % 8`` rule belong to its TPU tiling and are not
    carried over; counts as one ``stencil5_affine`` launch."""
    return laplacian_2d_pipelined(x, nx=nx, ny=ny, hx2=hx2, hy2=hy2)


def laplacian_2d(nx, ny=None, device="cuda"):
    """Operator constructor over :func:`laplacian_2d_kernel`: a matvec
    closure with ``.shape`` and ``.diag`` (drop-in for
    :func:`krypy_tpu_torch.ops.poisson_2d`).  Counterpart of
    ``krypy_tpu.kernels.stencil.laplacian_2d``; ``device`` places
    ``.diag``."""
    ny = nx if ny is None else ny

    def matvec(x):
        return laplacian_2d_kernel(x, nx=nx, ny=ny)

    matvec.shape = (nx * ny, nx * ny)
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    matvec.diag = torch.full((nx * ny,), 2.0 / hx2 + 2.0 / hy2,
                             dtype=torch.float64, device=device)
    return matvec
