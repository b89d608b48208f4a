"""Operators of the ported slices (counterpart of the matching parts of
:mod:`krypy_tpu.ops`): the README diagonal and the 1-D and 2-D Poisson,
convection-diffusion and shifted-Laplacian stencils, the Jacobi, SSOR and
DST preconditioners, and the multigrid V-cycle on both layouts.

Operators are plain callables on 1-D ``(N,)`` tensors that carry
``.shape`` (and ``.grid``, ``.nx_pad``, ``.ny_pad``, ``.diag`` where the
JAX operator has them).  They are not ``nn.Module``s: a solver operator
has no parameters.  Their output dtype follows the input vector.

``impl="torch"`` is the JAX package's ``impl="jnp"`` and ``impl="cuda"``
its ``impl="pallas"``: on the cuda lane the multigrid levels and the
float32 stencil matvecs go through the hand-written kernels of
:mod:`krypy_tpu_torch.kernels` (the padded V-cycle at ``n >= 256`` as in
the JAX package, the unpadded one at every level; float32 only, float64
through the plain stencil).

Every constructor takes the JAX package's arguments in its positional
order and, keyword-only, ``device``, where the operator keeps its own
tensors (``.diag``); it defaults to ``"cuda"``, the current CUDA device,
and raises where torch sees no CUDA device.  Pass ``device="cpu"`` to
build an operator on the CPU.

The three stencil constructors take ``mesh=`` (a
:class:`krypy_tpu_torch.parallel.Mesh`; ``nx`` divisible by its size):
the operator then maps the rank's row block of a vector to the rank's
block of the product, through K8 (:func:`~krypy_tpu_torch.kernels.
stencil.stencil5_sharded`) on float32 with ``impl="cuda"`` and through
its plain version otherwise (where the JAX package's ``impl="jnp"`` has
GSPMD insert the exchange, the port runs the plain stencil per shard with
the same exchange); ``.diag`` is the rank's block, ``.shape`` the global
one.  ``pad_cols=True`` with ``mesh=`` raises ``ValueError``, as in the
JAX package.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .kernels import stencil as _kst
from .parallel import active_mesh, block_of

__all__ = [
    "diagonal",
    "readme_diag",
    "poisson_1d",
    "poisson_2d",
    "convection_diffusion_2d",
    "shifted_laplacian_2d",
    "jacobi_preconditioner",
    "nls_residual_2d",
    "nls_jacobian_sequence",
    "poisson_dst_solver",
    "ssor_poisson_preconditioner",
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


def _check_mesh(mesh, pad_cols):
    if mesh is not None and pad_cols:
        raise ValueError("pad_cols does not compose with mesh= yet")


def _sharded_matvec(nx, ny, coeffs, impl, mesh):
    """The row-sharded matvec on ``mesh``: K8 on float32 with
    ``impl="cuda"``, its plain version otherwise."""
    coeffs = tuple(float(c) for c in coeffs)

    def matvec(x):
        fn = (kernels.stencil5_sharded
              if impl == "cuda" and x.dtype == torch.float32
              else _kst.stencil5_sharded_torch)
        return fn(x, nx=nx, ny=ny, coeffs=coeffs, mesh=mesh)

    matvec.mesh = mesh
    return matvec


def _finish(matvec, nx, ny, dval, device, mesh):
    """``.shape`` (global) and ``.diag`` (float64, the rank's block on a
    mesh) of an unpadded stencil operator."""
    N = nx * ny
    n = N if mesh is None else len(range(N)[block_of(N, mesh)])
    matvec.shape = (N, N)
    matvec.diag = torch.full((n,), dval, dtype=torch.float64, device=device)
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


def readme_diag(n=100, *, device="cuda"):
    """The README example operator ``A = diag(1e-3, 2, 3, ..., n)``, in
    float64 on ``device`` (BASELINE config 1)."""
    device = _device(device)
    d = torch.cat([torch.tensor([1.0e-3], dtype=torch.float64),
                   torch.arange(2.0, n + 1, dtype=torch.float64)])
    return diagonal(d.to(device))


def _lap1d_apply(u, h2):
    """1-D central second difference with Dirichlet boundaries."""
    left = F.pad(u[:-1], (1, 0))
    right = F.pad(u[1:], (0, 1))
    return (2.0 * u - left - right) / h2


def poisson_1d(n, *, device="cuda"):
    """1-D Dirichlet Laplacian on n interior points of (0, 1); SPD.
    ``device`` places ``.diag``."""
    device = _device(device)
    h2 = (1.0 / (n + 1)) ** 2

    def matvec(x):
        return _lap1d_apply(x, h2)

    matvec.shape = (n, n)
    matvec.diag = torch.full((n,), 2.0 / h2, dtype=torch.float64,
                             device=device)
    return matvec


def poisson_2d(nx, ny=None, impl="torch", mesh=None, pad_cols=False, *,
               device="cuda"):
    """5-point Laplacian on an nx x ny interior grid of the unit square,
    Dirichlet boundaries; SPD, N = nx*ny.

    ``pad_cols=True`` returns the grid-padded operator on
    ``(pad_rows_width(nx) * pad_cols_width(ny),)`` vectors whose pads are
    zero.  With ``impl="cuda"`` the float32 matvec is the K1 kernel on
    either layout (unpadded: :func:`~krypy_tpu_torch.kernels.stencil.
    laplacian_2d_pipelined`), other dtypes the plain grouped-difference
    stencil.  ``device`` places ``.diag``; ``mesh=`` shards it (module
    docstring).
    """
    _check_impl(impl)
    _check_mesh(mesh, pad_cols)
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

    if mesh is not None:
        matvec = _sharded_matvec(
            nx, ny, (dval, -1.0 / hx2, -1.0 / hx2, -1.0 / hy2, -1.0 / hy2),
            impl, mesh)
    elif impl == "cuda":
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

    return _finish(matvec, nx, ny, dval, device, mesh)


def convection_diffusion_2d(nx, ny=None, wind=(1.0, 0.5), eps=1.0,
                            impl="torch", mesh=None, pad_cols=False, *,
                            device="cuda"):
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
    ``.diag``; ``mesh=`` shards it (module docstring).
    """
    _check_impl(impl)
    _check_mesh(mesh, pad_cols)
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

    if mesh is not None:
        matvec = _sharded_matvec(nx, ny, coeffs, impl, mesh)
    elif impl == "cuda":
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

    return _finish(matvec, nx, ny, coeffs[0], device, mesh)


def shifted_laplacian_2d(nx, ny=None, sigma=0.0, impl="torch", mesh=None, *,
                         device="cuda"):
    """Shifted Laplacian ``Lap - sigma I`` (indefinite for sigma inside
    the spectrum) on an nx x ny Dirichlet grid.  ``impl="cuda"`` folds
    the shift into the stencil's centre coefficient and runs K1 through
    :func:`~krypy_tpu_torch.kernels.stencil.stencil5_pipelined` on
    float32 (the plain grouped stencil on other dtypes);
    ``impl="torch"`` is ``poisson_2d(x) - sigma x``.  ``device`` places
    ``.diag``; ``mesh=`` shards it (module docstring)."""
    _check_impl(impl)
    device = _device(device)
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    dval = 2.0 / hx2 + 2.0 / hy2 - sigma
    coeffs = (dval, -1.0 / hx2, -1.0 / hx2, -1.0 / hy2, -1.0 / hy2)

    if mesh is not None:
        matvec = _sharded_matvec(nx, ny, coeffs, impl, mesh)
    elif impl == "cuda":
        matvec = _kernel_matvec(
            nx, ny, coeffs,
            lambda x: kernels.stencil5_pipelined(x, nx=nx, ny=ny,
                                                 coeffs=coeffs),
        )
    else:
        lap = poisson_2d(nx, ny, device=device)

        def matvec(x):
            return lap(x) - sigma * x

    return _finish(matvec, nx, ny, dval, device, mesh)


def nls_residual_2d(nx, kappa=1.0, lam=25.0, amplitude=1.0,
                    dtype=torch.float32, *, impl="torch", device="cuda"):
    r"""Stationary nonlinear-Schrödinger (Gross-Pitaevskii) residual on
    the 2-D unit square:

    .. math:: F(u) = -\Delta u + \kappa u^3 - \lambda u - g,

    with the source g manufactured so that ``u* = amplitude *`` (Gaussian
    bump) satisfies ``F(u*) = 0``.  Returns ``(F, u_star)``, ``u_star`` a
    ``dtype`` tensor on ``device``.  Counterpart of
    ``krypy_tpu.ops.nls_residual_2d`` (the BASELINE config-5 problem),
    with the formula term for term.

    The Jacobian action ``J(u) v = -Lap v + 3 kappa u^2 v - lam v`` is
    symmetric and, with ``lam`` inside the spectrum of the discrete
    :math:`-\Delta`, indefinite with a few low-lying modes.
    :func:`torch.func.jvp` of ``F`` computes it.  ``impl`` is
    :func:`poisson_2d`'s: with ``impl="cuda"`` the Laplacian of a float32
    ``u`` is K1 (``kernels.stencil5_affine``), and so is its tangent
    under ``torch.func.jvp`` (one launch each).
    """
    lap = poisson_2d(nx, impl=impl, device=device)
    xs = np.linspace(1.0 / (nx + 1), nx / (nx + 1.0), nx)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    bump = np.exp(-30.0 * ((X - 0.5) ** 2 + (Y - 0.5) ** 2))
    ustar = torch.tensor(amplitude * bump.reshape(-1), dtype=dtype,
                         device=lap.diag.device)
    g = lap(ustar) + kappa * ustar**3 - lam * ustar

    def F(u):
        return lap(u) + kappa * u**3 - lam * u - g

    return F, ustar


def nls_jacobian_sequence(n, n_sys=5, kappa=1.0, seed=0, *, device="cuda"):
    """A sequence of Jacobian-like SPD operators ``J_i = Lap_1d + diag(1 +
    3 kappa psi_i^2)`` mimicking Newton steps on a nonlinear
    Schrödinger-type equation (counterpart of
    ``krypy_tpu.ops.nls_jacobian_sequence``); float64 diagonals on
    ``device``.  Each operator keeps the JAX package's family attributes
    (``family``, ``params``, ``rebuild``): the diagonal part as the
    parameter of one operator family."""
    lap = poisson_1d(n, device=device)
    dev = lap.diag.device
    rng = np.random.RandomState(seed)
    xs = np.linspace(0, 1, n)
    psi = np.exp(-40 * (xs - 0.5) ** 2)
    out = []
    for i in range(n_sys):
        psi_i = psi * (1.0 + 0.05 * i) + 0.01 * rng.randn(n) * i
        d = torch.tensor(1.0 + 3.0 * kappa * psi_i**2, device=dev)

        def matvec(x, _d=d):
            return lap(x) + _d * x

        matvec.shape = (n, n)
        matvec.diag = lap.diag + d
        matvec.family = ("nls_jacobian", id(lap))
        matvec.params = d
        matvec.rebuild = lambda p, _lap=lap: (lambda x: _lap(x) + p * x)
        out.append(matvec)
    return out


def jacobi_preconditioner(op_or_diag):
    """Jacobi preconditioner M = diag(A)^{-1} from an operator exposing
    ``.diag`` or from an explicit diagonal tensor."""
    # a tensor's own .diag is a method, not a diagonal
    d = (op_or_diag if isinstance(op_or_diag, torch.Tensor)
         else op_or_diag.diag)
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


def _lap_coeffs(h2):
    """The 5-point Laplacian's stencil coefficients ``(centre, up, down,
    left, right)`` at grid spacing squared ``h2``."""
    return (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)


def _lap2d_grid(u, h2):
    """5-point Laplacian on a 2-D grid array (Dirichlet): K1's plain
    version with the Laplacian's coefficients."""
    return _kst.stencil5_affine_torch(u, None, _lap_coeffs(h2), *u.shape)


def _restrict_fw(r):
    """Full-weighting restriction (vertex-centered, ``nx = 2 nc + 1``)."""
    return _restrict_fw_1d(_restrict_fw_1d(r, 0), 1)


def _prolong_bilinear(c, nx):
    """Bilinear prolongation (``nx = 2 nc + 1``)."""
    return _prolong_bilinear_1d(_prolong_bilinear_1d(c, 0), 1)


def _dst1(u, dim):
    """DST-I along ``dim`` through the FFT of the odd extension (length
    2(n+1))."""
    u = torch.movedim(u, dim, -1)
    n = u.shape[-1]
    zero = torch.zeros(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)
    z = torch.cat([zero, u, zero, -u.flip(-1)], dim=-1)
    out = -torch.fft.rfft(z, dim=-1).imag[..., 1:n + 1] / 2.0
    return torch.movedim(out.to(u.dtype), -1, dim)


def poisson_dst_solver(nx, ny=None, *, device="cuda"):
    r"""Fast direct solver for the 2-D Dirichlet Poisson operator by sine
    diagonalization: :math:`x = S \Lambda^{-1} S b` with S the DST-I in
    both grid directions (four FFTs per solve).  Exactly :math:`A^{-1}`
    for :func:`poisson_2d`; the multigrid's ``coarse_solver="dst"``.
    The eigenvalues are kept in float64 on ``device`` and rounded to the
    vector's dtype at each application."""
    device = _device(device)
    ny = nx if ny is None else ny
    hx2 = (1.0 / (nx + 1)) ** 2
    hy2 = (1.0 / (ny + 1)) ** 2
    ii = np.arange(1, nx + 1)
    jj = np.arange(1, ny + 1)
    lam_x = 4.0 * np.sin(ii * np.pi / (2 * (nx + 1))) ** 2 / hx2
    lam_y = 4.0 * np.sin(jj * np.pi / (2 * (ny + 1))) ** 2 / hy2
    lam = torch.from_numpy(lam_x[:, None] + lam_y[None, :]).to(device)
    # DST-I is involutory up to the factor 2/(n+1) per direction
    scale = (2.0 / (nx + 1)) * (2.0 / (ny + 1))

    def matvec(b):
        u = b.reshape(nx, ny)
        u = _dst1(_dst1(u, 0), 1)
        u = u / lam.to(u.dtype)
        u = _dst1(_dst1(u, 0), 1) * scale
        return u.reshape(-1)

    matvec.shape = (nx * ny, nx * ny)
    return matvec


def _checkerboard(nx, ny, device):
    """The red points ``(i + j) % 2 == 0`` of an nx x ny grid, and the
    black ones."""
    red = (torch.arange(nx, device=device)[:, None]
           + torch.arange(ny, device=device)[None, :]) % 2 == 0
    return red, ~red


def _rb_gs_half(u, r, mask, diag, omega, apply_A):
    """One red-black Gauss-Seidel half-update on a grid: the masked
    colour's value by the residual form ``u + (omega/diag)(r - A u)``."""
    return torch.where(mask, u + (omega / diag) * (r - apply_A(u)), u)


def ssor_poisson_preconditioner(nx, ny=None, omega=1.0, sweeps=1, *,
                                device="cuda"):
    r"""Red-black SSOR preconditioner for the 2-D 5-point Laplacian: each
    application runs ``sweeps`` symmetric Gauss-Seidel sweeps (forward
    red then black, backward black then red) from zero, each colour a
    masked stencil update.  SPD for the symmetric operator, so a CG
    preconditioner.  The colour masks are built once, on ``device``."""
    device = _device(device)
    ny = nx if ny is None else ny
    h2 = (1.0 / (nx + 1)) ** 2
    diag = 4.0 / h2
    red, black = _checkerboard(nx, ny, device)

    def apply_A(u):
        return _lap2d_grid(u, h2)

    def matvec(rv):
        r = rv.reshape(nx, ny)
        u = torch.zeros_like(r)
        for _ in range(int(sweeps)):
            for mask in (red, black, black, red):
                u = _rb_gs_half(u, r, mask, diag, omega, apply_A)
        return u.reshape(-1)

    matvec.shape = (nx * ny, nx * ny)
    return matvec


def _multigrid_padded(nx, nu_pre, nu_post, omega, coarsest, coarse_sweeps,
                      impl, scale=1.0, device="cuda"):
    """Grid-padded V-cycle with damped-Jacobi smoothing (counterpart of
    the JAX ``_multigrid_padded``): every level lives in an ``(n_pad,
    pad128(n))`` buffer.  With ``impl="cuda"``, float32 levels with
    ``n >= 256`` run the kernels: K1 for the step, residual and collapsed
    presmooth, K2 for post-smoothing pairs, K3 for residual plus row
    restriction; the coarsest level's sweeps run as ONE launch of K1's
    coarse form (:func:`~krypy_tpu_torch.kernels.stencil.stencil5_coarse`)
    where its grid fits the kernel (``coarse_fits``: up to 127^2), as its
    per-sweep steps above that; every other leg is plain torch.  The JAX
    package's coarse level, below its kernels' 256, is plain jnp (a TPU
    choice); on the H100 its ~240 launches per coarse solve were most of a
    host-bound V-cycle's time.  ``scale`` is folded
    into the final post-smoothing sweep.  The operator applies only to
    vectors on ``device``."""
    device = _device(device)

    def step_fn(n, R, P, h2, dtype_is_f32, s=1.0):
        diag = 4.0 / h2
        lapc = _lap_coeffs(h2)
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
            if not coarse_sweeps:
                u = torch.zeros_like(r)
            elif impl == "cuda" and is_f32 and _kst.coarse_fits(n, n):
                # every sweep in ONE launch (K1's coarse form)
                u = kernels.stencil5_coarse(
                    r.reshape(-1), nx=R, ny=P, coeffs=_lap_coeffs(h2), w=w,
                    sweeps=coarse_sweeps, ncols=n, nrows=n,
                ).reshape(R, P)
            else:
                # first sweep from u=0 is the elementwise u1 = w*r
                u = smooth(w * r, r, step, coarse_sweeps - 1)
            return scale * u if (top and scale != 1.0) else u

        if nu_pre >= 2:
            # sweeps 1+2 from u=0 collapse into ONE stencil pass on r
            u = smooth(presmooth2(r), r, step, nu_pre - 2)
        else:
            u = w * r if nu_pre == 1 else torch.zeros_like(r)
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
        if active_mesh() is not None:
            raise NotImplementedError(
                "the padded V-cycle on a mesh is not ported (nor in the JAX "
                "package; ROADMAP.md queue A, slice 5)")
        if x.device != device:
            raise ValueError(f"multigrid built for {device}, applied to a "
                             f"vector on {x.device}")
        return vcycle(x.reshape(nx_pad, ny_pad), nx, top=True).reshape(-1)

    matvec.shape = (nx_pad * ny_pad, nx_pad * ny_pad)
    matvec.grid = (nx, nx)
    matvec.nx_pad, matvec.ny_pad = nx_pad, ny_pad
    return matvec


def _multigrid_unpadded(nx, nu_pre, nu_post, omega, coarsest, coarse_sweeps,
                        coarse_solver, impl, smoother, scale, device):
    """The unpadded V-cycle on ``(nx, nx)`` grids (counterpart of the JAX
    package's ``multigrid_poisson_preconditioner`` without ``pad_cols``):
    each level's Laplacian is K1 (:func:`~krypy_tpu_torch.kernels.
    stencil.stencil5_pipelined`) on float32 with ``impl="cuda"``, the
    plain stencil otherwise; every other leg is plain torch.

    K1 runs at every level, and the coarsest level's Jacobi sweeps run as
    ONE launch of K1's coarse form (:func:`~krypy_tpu_torch.kernels.
    stencil.stencil5_coarse`) where its grid fits the kernel
    (``coarse_fits``: up to 127^2), as per-sweep K1 launches above that.
    The JAX package starts its kernel at 256 (a
    TPU choice); on the H100 (80GB HBM3, 700 W) one K1 launch took less
    time per call than the plain stencil's chain of launches at every
    level size measured, 1^2 to 4095^2: below 2047^2 the cost is the
    launches, not the bytes (``chip_smoke.py``'s
    ``k1_unpadded_crossover``; its readings are in PERF.md)."""
    device = _device(device)
    if coarse_solver == "dst":
        coarse_solver = poisson_dst_solver(coarsest, device=device)
    masks = {}
    if smoother == "rbgs":
        n = nx
        while True:
            masks[n] = _checkerboard(n, n, device)
            if n <= coarsest:
                break
            n = (n - 1) // 2

    def lap_grid(u, n, h2):
        if impl == "cuda" and u.dtype == torch.float32:
            return kernels.stencil5_pipelined(
                u.reshape(-1), nx=n, ny=n, coeffs=_lap_coeffs(h2),
            ).reshape(n, n)
        return _lap2d_grid(u, h2)

    def vcycle(r, n):
        h2 = (1.0 / (n + 1)) ** 2
        diag = 4.0 / h2

        def A(u):
            return lap_grid(u, n, h2)

        def step(u, reverse=False):
            if smoother == "rbgs":
                # omega=1: plain Gauss-Seidel; the post-smoother runs the
                # colours reversed, so the cycle stays symmetric
                red, black = masks[n]
                for mask in ((black, red) if reverse else (red, black)):
                    u = _rb_gs_half(u, r, mask, diag, 1.0, A)
                return u
            return u + (omega / diag) * (r - A(u))

        def smooth(u, k, reverse=False):
            for _ in range(k):
                u = step(u, reverse)
            return u

        if n <= coarsest:
            if coarse_solver is not None:
                return coarse_solver(r.reshape(-1)).reshape(r.shape)
            u = torch.zeros_like(r)
            if smoother == "rbgs":
                # (forward, reverse) pairs keep the coarse smoothing
                # symmetric: coarse_sweeps rounds up to a pair
                for _ in range((coarse_sweeps + 1) // 2):
                    u = step(step(u), reverse=True)
                return u
            if coarse_sweeps and impl == "cuda" and \
                    r.dtype == torch.float32 and _kst.coarse_fits(n, n):
                # every sweep in ONE launch (K1's coarse form)
                return kernels.stencil5_coarse(
                    r.reshape(-1), nx=n, ny=n, coeffs=_lap_coeffs(h2),
                    w=omega / diag, sweeps=coarse_sweeps,
                ).reshape(n, n)
            return smooth(u, coarse_sweeps)

        if smoother == "rbgs" or nu_pre < 2:
            u = smooth(torch.zeros_like(r), nu_pre)
        else:
            # Jacobi sweeps 1+2 from u=0 collapse to one stencil pass
            w = omega / diag
            u = smooth((2.0 * w) * r - (w * w) * A(r), nu_pre - 2)
        res = r - A(u)
        ec = vcycle(_restrict_fw(res), (n - 1) // 2)
        u = u + _prolong_bilinear(ec, n)
        return smooth(u, nu_post, reverse=True)

    def matvec(x):
        if active_mesh() is not None:
            raise NotImplementedError(
                "the V-cycle on a mesh is not ported (ROADMAP.md queue A, "
                "A4)")
        if x.device != device:
            raise ValueError(f"multigrid built for {device}, applied to a "
                             f"vector on {x.device}")
        u = vcycle(x.reshape(nx, nx), nx).reshape(-1)
        return scale * u if scale != 1.0 else u

    matvec.shape = (nx * nx, nx * nx)
    return matvec


def multigrid_poisson_preconditioner(
    nx, nu_pre=2, nu_post=2, omega=0.8, coarsest=7, coarse_sweeps=20,
    coarse_solver=None, impl="torch", smoother="jacobi", pad_cols=False,
    scale=1.0, *, device="cuda",
):
    r"""Geometric multigrid V-cycle preconditioner for the 2-D Dirichlet
    Poisson operator (``nx = 2^k - 1``): full-weighting restriction,
    bilinear prolongation, ``nu_pre`` / ``nu_post`` smoothing sweeps
    (``smoother="jacobi"``, damped by ``omega``, or ``"rbgs"``, red-black
    Gauss-Seidel whose post-smoother runs the colours reversed so that
    the cycle stays symmetric) and, on the coarsest level, the smoother
    from zero (``coarse_sweeps``; ``rbgs`` rounds up to symmetric pairs)
    or ``coarse_solver`` (a matvec, or ``"dst"`` for
    :func:`poisson_dst_solver`).  M becomes ``scale * V(r)``.

    Without ``pad_cols`` the cycle runs on ``(nx, nx)`` grids (K1 for
    every float32 level Laplacian with ``impl="cuda"``).
    ``pad_cols=True`` is the grid-padded lane (K1-K3 at ``n >= 256``),
    which takes the jacobi smoother and the sweep coarse solve only
    (``ValueError`` otherwise, as in the JAX package);
    its ``nu_pre`` of 0 and 1 and ``coarse_sweeps=0`` run as many sweeps
    as the unpadded lane (the JAX padded lane runs one more there).  The
    operator makes no tensors of its own apart from the ``rbgs`` masks
    and the ``dst`` eigenvalues, and runs in the dtype of the vector it
    is applied to, which must lie on ``device`` (default ``"cuda"``, the
    current CUDA device; raises where torch sees none).
    """
    _check_impl(impl)
    if (nx + 1) & nx != 0:
        raise ValueError("multigrid requires nx = 2^k - 1")
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if not pad_cols:
        return _multigrid_unpadded(
            nx, nu_pre, nu_post, omega, coarsest, coarse_sweeps,
            coarse_solver, impl, smoother, scale, device)
    if smoother != "jacobi" or coarse_solver is not None:
        raise ValueError(
            "pad_cols multigrid supports the jacobi smoother with the sweep "
            "coarse solve only"
        )
    return _multigrid_padded(
        nx, nu_pre, nu_post, omega, coarsest, coarse_sweeps, impl,
        scale=scale, device=device,
    )
