"""Operators of the multigrid-CG, north-star and deflation slices
(counterpart of the matching parts of :mod:`krypy_tpu.ops`).

Operators are plain callables on 1-D ``(N,)`` tensors that carry
``.shape`` (and ``.grid``, ``.nx_pad``, ``.ny_pad``, ``.diag`` where the
JAX operator has them).  They are not ``nn.Module``s: a solver operator
has no parameters.  Their output dtype follows the input vector.

``impl="torch"`` is the JAX package's ``impl="jnp"`` and ``impl="cuda"``
its ``impl="pallas"``: on the cuda lane the fine multigrid levels and the
float32 stencil matvecs go through the hand-written kernels of
:mod:`krypy_tpu_torch.kernels`, under the JAX package's dispatch rules
(kernels only at ``n >= 256`` and on float32; float64 through the plain
stencil).

Every constructor takes ``device``, where the operator keeps its own
tensors (``.diag``); it defaults to ``"cuda"``, the current CUDA device,
and raises where torch sees no CUDA device.  Pass ``device="cpu"`` to
build an operator on the CPU.
"""

import torch
import torch.nn.functional as F

from . import kernels

__all__ = [
    "diagonal",
    "poisson_2d",
    "convection_diffusion_2d",
    "shifted_laplacian_2d",
    "jacobi_preconditioner",
    "multigrid_poisson_preconditioner",
    "pad_cols_width",
    "pad_rows_width",
    "pad_grid_vec",
    "unpad_grid_vec",
]

_IMPLS = ("torch", "cuda")


def _check_impl(impl):
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {_IMPLS})")


def _device(device):
    """Resolve an operator's ``device``: a bare ``"cuda"`` is the current
    CUDA device (a CUDA tensor always reports its index).  Raises where
    torch sees no CUDA device, rather than building CPU tensors."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch sees no CUDA device; "
                "pass device='cpu' to build the operator on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _kernel_matvec(nx, ny, coeffs, kernel):
    """Unpadded ``impl="cuda"`` stencil matvec: ``kernel`` (an entry over
    K1 on the whole ``(nx, ny)`` buffer) on float32 input, the plain
    grouped-difference stencil otherwise."""
    coeffs = tuple(float(c) for c in coeffs)

    def matvec(x):
        if x.dtype == torch.float32:
            return kernel(x)
        return _stencil5_padded(x.reshape(nx, ny), coeffs, nx, ny).reshape(-1)

    return matvec


def diagonal(d):
    """diag(d) as a matvec; ``d`` is an ``(N,)`` tensor and the operator
    lives on its device.  Keeps the JAX operator's family attributes
    (``family``, ``params``, ``rebuild``), by which a sequence of
    diagonals can be told to be one operator family."""
    def matvec(x):
        return d * x

    matvec.diag = d
    matvec.shape = (d.shape[0], d.shape[0])
    matvec.family = "diagonal"
    matvec.params = d
    matvec.rebuild = lambda p: (lambda x: p * x)
    return matvec


def poisson_2d(nx, ny=None, impl="torch", pad_cols=False, device="cuda"):
    """5-point Laplacian on an nx x ny interior grid of the unit square,
    Dirichlet boundaries; SPD, N = nx*ny.

    ``pad_cols=True`` returns the grid-padded operator on
    ``(pad_rows_width(nx) * pad_cols_width(ny),)`` vectors whose pads are
    zero.  With ``impl="cuda"`` the float32 matvec is the K1 kernel on
    either layout (unpadded: :func:`~krypy_tpu_torch.kernels.stencil.
    laplacian_2d_pipelined`), other dtypes the plain grouped-difference
    stencil.  ``device`` places ``.diag``.
    """
    _check_impl(impl)
    device = _device(device)
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    dval = 2.0 / hx2 + 2.0 / hy2

    if pad_cols:
        coeffs = (dval, -1.0 / hx2, -1.0 / hx2, -1.0 / hy2, -1.0 / hy2)
        matvec, nx_pad, ny_pad = _padded_stencil_matvec(nx, ny, coeffs,
                                                        impl)
        Np = nx_pad * ny_pad
        matvec.shape = (Np, Np)
        matvec.grid = (nx, ny)
        matvec.nx_pad, matvec.ny_pad = nx_pad, ny_pad
        # pad diagonal entries are 1 so diag-based preconditioners stay
        # finite (they multiply zeros anyway)
        dg = torch.ones((nx_pad, ny_pad), dtype=torch.float64,
                        device=device)
        dg[:nx, :ny] = dval
        matvec.diag = dg.reshape(-1)
        return matvec

    if impl == "cuda":
        matvec = _kernel_matvec(
            nx, ny, (dval, -1.0 / hx2, -1.0 / hx2, -1.0 / hy2, -1.0 / hy2),
            lambda x: kernels.laplacian_2d_pipelined(x, nx=nx, ny=ny,
                                                     hx2=hx2, hy2=hy2),
        )
    else:
        def matvec(x):
            u = x.reshape(nx, ny)
            ux = (2.0 * u
                  - F.pad(u[:-1, :], (0, 0, 1, 0))
                  - F.pad(u[1:, :], (0, 0, 0, 1))) / hx2
            uy = (2.0 * u
                  - F.pad(u[:, :-1], (1, 0))
                  - F.pad(u[:, 1:], (0, 1))) / hy2
            return (ux + uy).reshape(-1)

    matvec.shape = (nx * ny, nx * ny)
    matvec.diag = torch.full((nx * ny,), dval, dtype=torch.float64,
                             device=device)
    return matvec


def convection_diffusion_2d(nx, ny=None, wind=(1.0, 0.5), eps=1.0,
                            impl="torch", pad_cols=False, device="cuda"):
    """Nonsymmetric convection-diffusion operator ``-eps * Lap(u) +
    w . grad(u)`` with first-order upwind convection (wind components
    non-negative), Dirichlet boundaries; N = nx*ny.

    The stencil's up (row i-1) and left (column j-1) coefficients carry
    the upwind terms, so ``cu != cd`` and ``cl != cr``.  ``pad_cols=True``
    is the grid-padded operator (K1 on float32 with ``impl="cuda"``, the
    plain grouped stencil otherwise); unpadded, ``impl="cuda"`` runs K1
    through :func:`~krypy_tpu_torch.kernels.stencil.stencil5_pipelined` on
    float32 and ``impl="torch"`` is the JAX ``impl="jnp"`` formula
    ``eps * Lap(x) + wx * dx(u) + wy * dy(u)``.  ``device`` places
    ``.diag``.
    """
    _check_impl(impl)
    device = _device(device)
    ny = nx if ny is None else ny
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    hx2, hy2 = hx * hx, hy * hy
    wx, wy = wind
    coeffs = (
        eps * (2.0 / hx2 + 2.0 / hy2) + wx / hx + wy / hy,
        -eps / hx2 - wx / hx,
        -eps / hx2,
        -eps / hy2 - wy / hy,
        -eps / hy2,
    )

    if pad_cols:
        matvec, nx_pad, ny_pad = _padded_stencil_matvec(nx, ny, coeffs,
                                                        impl)
        Np = nx_pad * ny_pad
        matvec.shape = (Np, Np)
        matvec.grid = (nx, ny)
        matvec.nx_pad, matvec.ny_pad = nx_pad, ny_pad
        dg = torch.ones((nx_pad, ny_pad), dtype=torch.float64,
                        device=device)
        dg[:nx, :ny] = coeffs[0]
        matvec.diag = dg.reshape(-1)
        return matvec

    if impl == "cuda":
        matvec = _kernel_matvec(
            nx, ny, coeffs,
            lambda x: kernels.stencil5_pipelined(x, nx=nx, ny=ny,
                                                 coeffs=coeffs),
        )
    else:
        lap = poisson_2d(nx, ny, device=device)

        def matvec(x):
            u = x.reshape(nx, ny)
            # upwind differences (wind components assumed non-negative)
            dux = (u - F.pad(u[:-1, :], (0, 0, 1, 0))) / hx
            duy = (u - F.pad(u[:, :-1], (1, 0))) / hy
            conv = wx * dux + wy * duy
            return eps * lap(x) + conv.reshape(-1)

    matvec.shape = (nx * ny, nx * ny)
    matvec.diag = torch.full((nx * ny,), coeffs[0], dtype=torch.float64,
                             device=device)
    return matvec


def shifted_laplacian_2d(nx, ny=None, sigma=0.0, impl="torch", mesh=None,
                         device="cuda"):
    """Shifted Laplacian ``Lap - sigma I`` (indefinite for sigma inside
    the spectrum) on an nx x ny Dirichlet grid.  ``impl="cuda"`` folds
    the shift into the stencil's centre coefficient and runs K1 through
    :func:`~krypy_tpu_torch.kernels.stencil.stencil5_pipelined` on
    float32 (the plain grouped stencil on other dtypes);
    ``impl="torch"`` is ``poisson_2d(x) - sigma x``.  ``mesh=`` (the
    sharded stencil) raises ``NotImplementedError``.  ``device`` places
    ``.diag``."""
    _check_impl(impl)
    if mesh is not None:
        raise NotImplementedError(
            "shifted_laplacian_2d mesh= is not ported yet (ROADMAP.md "
            "queue B, K8)")
    device = _device(device)
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    dval = 2.0 / hx2 + 2.0 / hy2 - sigma

    if impl == "cuda":
        coeffs = (dval, -1.0 / hx2, -1.0 / hx2, -1.0 / hy2, -1.0 / hy2)
        matvec = _kernel_matvec(
            nx, ny, coeffs,
            lambda x: kernels.stencil5_pipelined(x, nx=nx, ny=ny,
                                                 coeffs=coeffs),
        )
    else:
        lap = poisson_2d(nx, ny, device=device)

        def matvec(x):
            return lap(x) - sigma * x

    matvec.shape = (nx * ny, nx * ny)
    matvec.diag = torch.full((nx * ny,), dval, dtype=torch.float64,
                             device=device)
    return matvec


def jacobi_preconditioner(op_or_diag):
    """Jacobi preconditioner M = diag(A)^{-1} from an operator exposing
    ``.diag`` or from an explicit diagonal tensor."""
    d = getattr(op_or_diag, "diag", None)
    if d is None:
        d = op_or_diag
    inv = 1.0 / d

    def matvec(x):
        return inv * x

    matvec.diag = inv
    matvec.shape = (d.shape[0], d.shape[0])
    return matvec


# ---------------------------------------------------------------------------
# grid-padded layout
# ---------------------------------------------------------------------------
# An (nx, ny) Dirichlet grid stored in an (nx_pad, ny_pad) buffer with the
# pad rows/columns kept exactly zero; the first pad row/column doubles as
# the Dirichlet ghost.  The widths (8 rows, 128 columns) are the JAX
# package's TPU tiling, kept so that both packages see the same vectors.


def pad_cols_width(ny):
    """Smallest multiple of 128 >= ``ny``."""
    return -(-ny // 128) * 128


def pad_rows_width(nx):
    """Smallest multiple of 8 >= ``nx``."""
    return -(-nx // 8) * 8


def pad_grid_vec(x, nx, ny):
    """Embed a flat ``(nx*ny,)`` grid vector into the grid-padded
    ``(pad_rows_width(nx) * pad_cols_width(ny),)`` layout (pads zero)."""
    nxp, nyp = pad_rows_width(nx), pad_cols_width(ny)
    if (nxp, nyp) == (nx, ny):
        return x
    u = x.reshape(nx, ny)
    return F.pad(u, (0, nyp - ny, 0, nxp - nx)).reshape(-1)


def unpad_grid_vec(x, nx, ny):
    """Extract the logical ``(nx*ny,)`` vector from the grid-padded
    layout (inverse of :func:`pad_grid_vec`)."""
    nxp, nyp = pad_rows_width(nx), pad_cols_width(ny)
    if (nxp, nyp) == (nx, ny):
        return x
    return x.reshape(nxp, nyp)[:nx, :ny].reshape(-1)


def _stencil5_padded(u, coeffs, nrows, ncols):
    """Plain 5-point Dirichlet stencil on a grid-padded 2-D array with an
    ``nrows x ncols`` logical region (counterpart of the JAX
    ``_stencil5_padded_jnp``): column shifts wrap through the zero pad
    column (the Dirichlet ghost), row shifts read the zero pad row, and
    the output pads are re-zeroed.  Grouped-difference form, as in the
    kernels."""
    cc, cu, cd, cl, cr = coeffs
    R, P = u.shape
    up = F.pad(u[:-1, :], (0, 0, 1, 0))
    dn = F.pad(u[1:, :], (0, 0, 0, 1))
    if P > ncols:
        lf = torch.roll(u, 1, dims=1)
        rt = torch.roll(u, -1, dims=1)
    else:
        lf = F.pad(u[:, :-1], (1, 0))
        rt = F.pad(u[:, 1:], (0, 1))
    out = (-cu * (u - up) - cd * (u - dn) - cl * (u - lf)
           - cr * (u - rt))
    e = cc + cu + cd + cl + cr
    if e != 0.0:
        out = out + e * u
    if P > ncols:
        keep = torch.arange(P, device=u.device) < ncols
        out = out * keep.to(out.dtype)[None, :]
    if R > nrows:
        keep = torch.arange(R, device=u.device) < nrows
        out = out * keep.to(out.dtype)[:, None]
    return out


def _padded_stencil_matvec(nx, ny, coeffs, impl):
    """Grid-padded matvec: the K1 kernel on float32 input with
    ``impl="cuda"``, the plain stencil otherwise (float64 always)."""
    nx_pad, ny_pad = pad_rows_width(nx), pad_cols_width(ny)
    coeffs = tuple(float(c) for c in coeffs)

    def matvec(x):
        if impl == "cuda" and x.dtype == torch.float32:
            return kernels.stencil5_affine(
                x, nx=nx_pad, ny=ny_pad, coeffs=coeffs, ncols=ny, nrows=nx,
            )
        return _stencil5_padded(
            x.reshape(nx_pad, ny_pad), coeffs, nx, ny
        ).reshape(-1)

    return matvec, nx_pad, ny_pad


# ---------------------------------------------------------------------------
# multigrid
# ---------------------------------------------------------------------------


def _restrict_fw_1d(u, axis):
    """Vertex-centered full weighting along one axis (``n = 2 nc + 1``):
    ``c_j = u_{2j}/4 + u_{2j+1}/2 + u_{2j+2}/4`` as strided slices."""
    u = torch.movedim(u, axis, 0)
    out = 0.25 * u[0:-2:2] + 0.5 * u[1:-1:2] + 0.25 * u[2::2]
    return torch.movedim(out, 0, axis)


def _prolong_bilinear_1d(c, axis):
    """Bilinear prolongation along one axis: odd fine nodes copy the
    coarse value, even fine nodes average their coarse neighbours
    (Dirichlet zero outside)."""
    c = torch.movedim(c, axis, 0)
    nc = c.shape[0]
    ext = F.pad(c, (0, 0) * (c.ndim - 1) + (1, 1))
    evens = 0.5 * (ext[:-1] + ext[1:])  # nc + 1 values
    inter = torch.stack([evens[:-1], c], dim=1).reshape(
        (2 * nc,) + tuple(c.shape[1:])
    )
    out = torch.cat([inter, evens[-1:]], dim=0)
    return torch.movedim(out, 0, axis)


def _multigrid_padded(nx, nu_pre, nu_post, omega, coarsest, coarse_sweeps,
                      impl, scale=1.0, device="cuda"):
    """Grid-padded V-cycle with damped-Jacobi smoothing (counterpart of
    the JAX ``_multigrid_padded``): every level lives in an ``(n_pad,
    pad128(n))`` buffer.  With ``impl="cuda"``, float32 levels with
    ``n >= 256`` run the kernels: K1 for the step, residual and collapsed
    presmooth, K2 for post-smoothing pairs, K3 for residual plus row
    restriction; every other leg is plain torch.  ``scale`` is folded
    into the final post-smoothing sweep.  The operator applies only to
    vectors on ``device``."""
    device = _device(device)

    def step_fn(n, R, P, h2, dtype_is_f32, s=1.0):
        diag = 4.0 / h2
        lapc = (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)
        w = omega / diag
        if impl == "cuda" and n >= 256 and dtype_is_f32:
            # s*(u + w*(r - A u)) as ONE kernel: alpha*u + beta*r + S(u)
            # with S = -s*w*A, alpha=s, beta=s*w
            sc = tuple(-s * w * c for c in lapc)
            rc = tuple(-c for c in lapc)
            # two sweeps FROM ZERO collapse to one stencil on r:
            # u2 = 2w r - w^2 A r
            pc = tuple(-w * w * c for c in lapc)
            kw = dict(nx=R, ny=P, ncols=n, nrows=n)

            def step(u, r):
                return kernels.stencil5_affine(
                    u.reshape(-1), r.reshape(-1), coeffs=sc, alpha=s,
                    beta=s * w, **kw,
                ).reshape(R, P)

            def residual(u, r):
                return kernels.stencil5_affine(
                    u.reshape(-1), r.reshape(-1), coeffs=rc, beta=1.0, **kw,
                ).reshape(R, P)

            def presmooth2(r):
                return kernels.stencil5_affine(
                    r.reshape(-1), None, coeffs=pc, alpha=2.0 * w, **kw,
                ).reshape(R, P)

            def step2(u, r, s2=1.0):
                return kernels.stencil5_jacobi2(
                    u.reshape(-1), r.reshape(-1), coeffs=lapc, w=w, s=s2,
                    **kw,
                ).reshape(R, P)

            nc = (n - 1) // 2
            if R % 16 == 0 and R // 2 == pad_rows_width(nc):
                # residual + row restriction in one kernel; columns
                # restrict on the half-height intermediate
                def resrestrict(u, r):
                    half = kernels.stencil5_resrestrict_rows(
                        u.reshape(-1), r.reshape(-1), coeffs=rc, **kw,
                    ).reshape(R // 2, P)
                    c = _restrict_fw_1d(half[:nc, :n], 1)
                    return F.pad(c, (0, pad_cols_width(nc) - nc,
                                     0, R // 2 - nc))
            else:
                resrestrict = None
        else:
            def step(u, r):
                v = u + w * (r - _stencil5_padded(u, lapc, n, n))
                return s * v if s != 1.0 else v

            def residual(u, r):
                return r - _stencil5_padded(u, lapc, n, n)

            def presmooth2(r):
                return (2.0 * w) * r - (w * w) * _stencil5_padded(
                    r, lapc, n, n
                )

            resrestrict = None
            step2 = None

        return step, residual, w, presmooth2, resrestrict, step2

    def smooth(u, r, step, k):
        for _ in range(k):
            u = step(u, r)
        return u

    def restrict_p(r, n):
        nc = (n - 1) // 2
        c = _restrict_fw_1d(_restrict_fw_1d(r[:n], 0)[:, :n], 1)
        return F.pad(c, (0, pad_cols_width(nc) - nc,
                         0, pad_rows_width(nc) - nc))

    def prolong_p(c, nc, R, P):
        n = 2 * nc + 1
        out = _prolong_bilinear_1d(c[:nc, :nc], 1)    # (nc, n)
        out = _prolong_bilinear_1d(out, 0)            # (n, n)
        return F.pad(out, (0, P - n, 0, R - n))

    def vcycle(r, n, top=False):
        R, P = r.shape
        is_f32 = r.dtype == torch.float32
        h2 = (1.0 / (n + 1)) ** 2
        step, residual, w, presmooth2, resrestrict, step2 = step_fn(
            n, R, P, h2, is_f32
        )

        if n <= coarsest:
            # first sweep from u=0 is the elementwise u1 = w*r
            u = smooth(w * r, r, step, coarse_sweeps - 1)
            return scale * u if (top and scale != 1.0) else u

        # sweeps 1+2 from u=0 collapse into ONE stencil pass on r
        u = smooth(presmooth2(r), r, step, nu_pre - 2)
        if resrestrict is not None:
            rc_grid = resrestrict(u, r)
        else:
            rc_grid = restrict_p(residual(u, r), n)
        ec = vcycle(rc_grid, (n - 1) // 2)
        u = u + prolong_p(ec, (n - 1) // 2, R, P)
        s_fold = scale if (top and scale != 1.0) else 1.0
        if step2 is not None and nu_post >= 2:
            # post-smoothing as fused PAIRS; the scale folds into the
            # last pair's second sweep, an odd sweep runs first alone
            u = smooth(u, r, step, nu_post % 2)
            for _ in range(nu_post // 2 - 1):
                u = step2(u, r)
            return step2(u, r, s_fold)
        if s_fold != 1.0 and nu_post >= 1:
            u = smooth(u, r, step, nu_post - 1)
            step_s = step_fn(n, R, P, h2, is_f32, s=s_fold)[0]
            return step_s(u, r)
        u = smooth(u, r, step, nu_post)
        return s_fold * u if s_fold != 1.0 else u

    nx_pad, ny_pad = pad_rows_width(nx), pad_cols_width(nx)

    def matvec(x):
        if x.device != device:
            raise ValueError(f"multigrid built for {device}, applied to a "
                             f"vector on {x.device}")
        return vcycle(x.reshape(nx_pad, ny_pad), nx, top=True).reshape(-1)

    matvec.shape = (nx_pad * ny_pad, nx_pad * ny_pad)
    matvec.grid = (nx, nx)
    matvec.nx_pad, matvec.ny_pad = nx_pad, ny_pad
    return matvec


def multigrid_poisson_preconditioner(
    nx, nu_pre=2, nu_post=2, omega=0.8, coarsest=7, coarse_sweeps=20,
    coarse_solver=None, impl="torch", smoother="jacobi", pad_cols=False,
    scale=1.0, device="cuda",
):
    r"""Geometric multigrid V-cycle preconditioner for the 2-D Dirichlet
    Poisson operator (``nx = 2^k - 1``): damped-Jacobi smoothing,
    full-weighting restriction, bilinear prolongation, a sweep solve on
    the coarsest level.  M becomes ``scale * V(r)``.

    Only the grid-padded V-cycle (``pad_cols=True``) is ported; the
    unpadded lane and ``smoother="rbgs"`` raise ``NotImplementedError``
    (ROADMAP.md queue A, item 3).  ``nu_pre < 2`` and ``coarse_sweeps <
    1`` raise ``ValueError``: the JAX padded lane runs one sweep too many
    there (ROADMAP.md queue C).  The operator makes no tensors of its own
    and runs in the dtype of the vector it is applied to, which must lie
    on ``device`` (default ``"cuda"``, the current CUDA device; raises
    where torch sees none).
    """
    _check_impl(impl)
    if (nx + 1) & nx != 0:
        raise ValueError("multigrid requires nx = 2^k - 1")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if not pad_cols or smoother != "jacobi":
        raise NotImplementedError(
            "only the grid-padded jacobi V-cycle (pad_cols=True) is ported "
            "yet (ROADMAP.md queue A, item 3)"
        )
    if coarse_solver is not None:
        raise ValueError(
            "pad_cols multigrid supports the jacobi smoother with the sweep "
            "coarse solve only"
        )
    if nu_pre < 2 or coarse_sweeps < 1:
        raise ValueError(
            "the padded V-cycle needs nu_pre >= 2 and coarse_sweeps >= 1 "
            f"(got nu_pre={nu_pre}, coarse_sweeps={coarse_sweeps})"
        )
    return _multigrid_padded(
        nx, nu_pre, nu_post, omega, coarsest, coarse_sweeps, impl,
        scale=scale, device=device,
    )
