"""Grid-padded 5-point stencil kernels: CUDA wrappers and their plain
PyTorch versions.

Counterparts of the three Pallas kernels in
``krypy_tpu/kernels/stencil.py`` that the padded multigrid-CG solve runs:

* :func:`stencil5_affine` (K1): ``alpha*u + beta*g + S(u)``, the matvec,
  damped-Jacobi step, residual and collapsed presmooth, with its coarse
  form :func:`stencil5_coarse`, the coarsest level's damped-Jacobi
  sweeps in one launch;
* :func:`stencil5_jacobi2` (K2): two fused damped-Jacobi sweeps;
* :func:`stencil5_resrestrict_rows` (K3): residual plus full-weighting
  row restriction;

and the thin entries over K1 on an unpadded grid (logical region = the
whole buffer), which launch K1 itself: :func:`stencil5_pipelined`,
:func:`laplacian_2d_pipelined`, and :func:`laplacian_2d_kernel` with its
operator constructor :func:`laplacian_2d` (K10, the JAX package's older
manual-copy Laplacian kernel, which its pipelined kernel superseded).
:func:`stencil5_sharded` (K8) is the matvec of a grid split by rows over
a mesh: a one-row halo exchange with the neighbouring ranks, then K8's
kernel :func:`stencil5_halo`, K1's tiles reading the received rows as the
block's rows -1 and ``nx/P``, so the edge rows need no correction.

Operands are flat ``(nx*ny,)`` tensors holding a row-major ``(nx, ny)``
buffer whose top-left ``(nrows, ncols)`` corner is the logical Dirichlet
grid.  Each wrapper launches its CUDA kernel (``csrc/stencil5.cu``) for a
float32 tensor on a CUDA device, raises for any other CUDA tensor, and
runs the plain version only for a tensor on the CPU.  The plain versions
read only the logical region and zero everything else, as the kernels do,
and follow the Pallas kernels' arithmetic term for term.
"""

import torch
import torch.autograd.forward_ad as _fwad

from ..parallel import halo_exchange
from ._launch import (  # noqa: F401
    LAUNCHES,
    TANGENT_LAUNCHES,
    launch_counts,
    reset_launch_counts,
    tangent_counts,
)
from ._launch import launch as _launch

__all__ = [
    "stencil5_affine",
    "stencil5_jacobi2",
    "stencil5_resrestrict_rows",
    "stencil5_pipelined",
    "laplacian_2d_pipelined",
    "laplacian_2d_kernel",
    "laplacian_2d",
    "stencil5_sharded",
    "stencil5_sharded_torch",
    "stencil5_halo",
    "stencil5_halo_torch",
    "halo_segments",
    "stencil5_affine_torch",
    "stencil5_jacobi2_torch",
    "stencil5_resrestrict_rows_torch",
    "coarse_smem",
    "stencil5_coarse",
    "stencil5_coarse_torch",
    "coarse_fits",
    "jacobi2_grid",
    "affine_grid",
    "launch_counts",
    "reset_launch_counts",
    "tangent_counts",
]


#: K1's and K2's geometry: a block's strip of columns and the rows of one
#: step (one per warp), both passed to the C entries, which refuse any
#: other than ``csrc/stencil5.cu``'s own; the most steps of a block's run,
#: and the grid size below which the runs are shortened
JACOBI2_STRIP = 128
JACOBI2_STEP_ROWS = 8
JACOBI2_MAX_STEPS = 4
JACOBI2_MIN_BLOCKS = 512


def affine_grid(nx, ny, aligned=True):
    """K1's launch on an ``(nx, ny)`` buffer: ``(strips, runs, steps)``,
    K2's runs (:func:`jacobi2_grid`).  Strip ``x`` computes, in each row,
    the columns ``[x * JACOBI2_STRIP - o, (x + 1) * JACOBI2_STRIP - o)``
    of the row's aligned frame, where the output row starts ``o`` floats
    past a 16-byte boundary; a buffer whose rows are not all 16-byte
    aligned (``aligned=False``: ``ny % 4 != 0`` or the output itself
    offset) takes ``ceil((ny + 3) / JACOBI2_STRIP)`` strips."""
    strips, runs, steps = jacobi2_grid(nx, ny)
    if not aligned:
        strips = -(-(ny + 3) // JACOBI2_STRIP)
    return strips, runs, steps


#: the most dynamic shared memory a block can have on Hopper; the coarse
#: form takes every grid whose buffers fit in it (:func:`coarse_fits`),
#: and its C entry refuses any other limit
COARSE_MAX_SMEM = 232448


def jacobi2_grid(nx, ny):
    """K2's launch on an ``(nx, ny)`` buffer, and K1's runs
    (:func:`affine_grid`): ``(strips, runs, steps)``.
    Block ``(x, y)`` computes the output columns ``[x * JACOBI2_STRIP,
    (x + 1) * JACOBI2_STRIP)`` and rows ``[y * h, (y + 1) * h)`` with ``h
    = steps * JACOBI2_STEP_ROWS``, each clipped to the buffer.  A run is
    ``JACOBI2_MAX_STEPS`` steps long, halved while the grid has fewer
    than ``JACOBI2_MIN_BLOCKS`` blocks (down to one step), so that small
    levels still spread over the card; it depends on the shape alone.
    On the H100 these runs (32, 32, 16 and 8 rows at the V-cycle's
    4096^2, 2048^2, 1024^2 and 512^2 buffers) took K2 the least summed
    time of runs from 8 to 64 rows."""
    strips = -(-ny // JACOBI2_STRIP)
    steps = JACOBI2_MAX_STEPS
    while steps > 1 and strips * -(-nx // (steps * JACOBI2_STEP_ROWS)) \
            < JACOBI2_MIN_BLOCKS:
        steps //= 2
    return strips, -(-nx // (steps * JACOBI2_STEP_ROWS)), steps


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
    # an unpadded grid is its own logical region: no mask to apply
    full = (nrows, ncols) == (R, P)
    if not full:
        inside = _logical_mask(R, P, nrows, ncols, u.device)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
    uz = u if full else torch.where(inside, u, zero)
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
    return out if full else torch.where(inside, out, zero)


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


def stencil5_coarse_torch(r, coeffs, w, sweeps, nrows, ncols):
    """Plain version of K1's coarse form on a 2-D ``(R, P)`` buffer:
    ``sweeps`` damped-Jacobi sweeps from zero, ``u = u + w (r - A u)``
    with ``A = coeffs`` (:func:`stencil5_affine_torch`), on the ``(nrows,
    ncols)`` logical region (``r`` read there only), exact zeros
    elsewhere.  The JAX package's coarse solves, step by step: the
    unpadded lane's ``coarse_sweeps`` sweeps from zero, and the padded
    lane's ``u = w r`` and ``coarse_sweeps - 1`` sweeps (the first sweep
    from zero is ``w r``)."""
    R, P = r.shape
    if (nrows, ncols) != (R, P):
        r = torch.where(_logical_mask(R, P, nrows, ncols, r.device), r,
                        torch.zeros((), dtype=r.dtype, device=r.device))
    u = torch.zeros_like(r)
    for _ in range(int(sweeps)):
        u = u + w * (r - stencil5_affine_torch(u, None, coeffs, nrows,
                                               ncols))
    return u


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _affine(x, g, nx, ny, coeffs, nrows, ncols, alpha, beta, tangent):
    """K1 on tensors that hold storage: the launch on a CUDA tensor, the
    plain version on a CPU one.  ``tangent`` marks the launch of a
    forward-mode tangent (counted as a ``stencil5_affine`` launch and,
    besides, in ``tangent_counts()``)."""
    ops = (x,) if g is None else (x, g)
    if not _check("stencil5_affine", nx, ny, nrows, ncols, *ops):
        return stencil5_affine_torch(
            x.reshape(nx, ny), None if g is None else g.reshape(nx, ny),
            coeffs, nrows, ncols, alpha, beta,
        ).reshape(-1)
    out = torch.empty(nx * ny, dtype=x.dtype, device=x.device)
    a, b, c, d, e = _grouped(coeffs)
    strips, _, steps = affine_grid(
        nx, ny, ny % 4 == 0 and out.data_ptr() % 16 == 0)
    _launch(
        "stencil5_affine", "krypy_stencil5_affine",
        (x.data_ptr(), None if g is None else g.data_ptr(), None, None,
         out.data_ptr(), nx, ny, nrows, ncols, a, b, c, d, e, float(alpha),
         float(beta) if g is not None else 0.0, 0, nx, 0, 0, JACOBI2_STRIP,
         JACOBI2_STEP_ROWS, strips, steps),
        x.device,
    )
    if tangent:
        TANGENT_LAUNCHES["stencil5_affine"] += 1
    return out


class _Affine(torch.autograd.Function):
    """K1 with its forward-mode rule.  K1 is affine in ``(x, g)``, so the
    tangent of ``alpha*x + beta*g + S(x)`` is K1 itself on the tangents
    ``(x', g')`` with the same coefficients: one more launch.  A missing
    tangent is a zero one (``g' = None`` leaves out the ``beta`` term).
    ``forward`` and ``jvp`` both launch K1 on CUDA tensors and run its
    plain version on CPU tensors, so the CPU tests go through the same
    rule.  Reverse mode is not ported."""

    @staticmethod
    def forward(x, g, geom, tangent):
        return _affine(x, g, *geom, tangent=tangent)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, geom, _ = inputs
        ctx.geom = geom
        ctx.like = (x.shape, x.dtype, x.device)

    @staticmethod
    def jvp(ctx, x_t, g_t, *_):
        if x_t is None:
            shape, dtype, device = ctx.like
            x_t = torch.zeros(shape, dtype=dtype, device=device)
        return _dispatch(x_t.contiguous(),
                         None if g_t is None else g_t.contiguous(),
                         ctx.geom, tangent=True)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "stencil5_affine has a forward-mode rule only; reverse mode "
            "is not ported (ROADMAP.md queue A, A7)")


def _differentiated(*tensors):
    """Whether a derivative may pass through ``tensors``: a torch.func
    transform or a forward-mode dual level is active, or one of them
    requires grad.  Only then does K1 go through :class:`_Affine`, whose
    ``apply`` costs tens of microseconds of host time per call, about a
    hundred times these checks (the solvers launch K1 thousands of times
    a solve)."""
    if torch._C._are_functorch_transforms_active() or \
            _fwad._current_level >= 0:
        return True
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _dispatch(x, g, geom, tangent=False):
    if _differentiated(x, g):
        return _Affine.apply(x, g, geom, tangent)
    return _affine(x, g, *geom, tangent=tangent)


def stencil5_affine(x, g=None, *, nx, ny, coeffs, ncols=None, nrows=None,
                    alpha=0.0, beta=0.0):
    """K1: ``out = alpha*x + beta*g + Stencil5(x)`` on the ``(nrows,
    ncols)`` logical region of an ``(nx, ny)`` buffer (flat operands),
    exact zeros elsewhere.  ``coeffs = (cc, cu, cd, cl, cr)``.
    Counterpart of ``krypy_tpu.kernels.stencil.stencil5_affine``.

    Differentiable in forward mode (``torch.func.jvp``,
    ``torch.autograd.forward_ad``): the tangent is one more K1 launch on
    the tangents (:class:`_Affine`), counted as a ``stencil5_affine``
    launch and in ``tangent_counts()``.  Reverse mode raises
    ``NotImplementedError``."""
    ncols = ny if ncols is None else ncols
    nrows = nx if nrows is None else nrows
    geom = (nx, ny, tuple(float(c) for c in coeffs), nrows, ncols,
            float(alpha), float(beta))
    return _dispatch(x, g, geom)


def coarse_smem(nrows, ncols):
    """Bytes of shared memory the coarse form takes for an ``(nrows,
    ncols)`` logical region: two planes of ``u`` with a zero border (the
    Dirichlet ghost) and ``r``, in float32."""
    return 4 * (2 * (nrows + 2) * (ncols + 2) + nrows * ncols)


def coarse_fits(nrows, ncols):
    """Whether :func:`stencil5_coarse` takes a logical region of ``(nrows,
    ncols)``: its buffers fit one block's shared memory,
    ``COARSE_MAX_SMEM`` (127^2 does, 255^2 does not)."""
    return coarse_smem(nrows, ncols) <= COARSE_MAX_SMEM


def stencil5_coarse(r, *, nx, ny, coeffs, w, sweeps, ncols=None,
                    nrows=None):
    """K1's coarse form: ``sweeps`` damped-Jacobi sweeps from zero, ``u =
    u + w (r - A u)`` with ``A = coeffs`` (the operator's ``(cc, cu, cd,
    cl, cr)``), on the ``(nrows, ncols)`` logical region of an ``(nx,
    ny)`` buffer (flat operand), exact zeros elsewhere: the coarsest
    level's solve of both V-cycles in ONE launch of one block that keeps
    the grid in shared memory.  Counts as one ``stencil5_affine`` launch
    (and one ``stencil5_coarse``).

    Dispatch by size: the kernel takes every region for which
    :func:`coarse_fits` holds (up to 127^2 of the V-cycle's levels) and
    raises ``ValueError`` for a larger one, which the V-cycles run as
    per-sweep launches instead.  Plain version:
    :func:`stencil5_coarse_torch`."""
    ncols = ny if ncols is None else ncols
    nrows = nx if nrows is None else nrows
    if sweeps < 0:
        raise ValueError(f"stencil5_coarse: sweeps={sweeps} < 0")
    if not _check("stencil5_coarse", nx, ny, nrows, ncols, r):
        return stencil5_coarse_torch(r.reshape(nx, ny), coeffs, w, sweeps,
                                     nrows, ncols).reshape(-1)
    if not coarse_fits(nrows, ncols):
        raise ValueError(
            f"stencil5_coarse: a {nrows}x{ncols} region needs "
            f"{coarse_smem(nrows, ncols)} bytes of shared memory, above "
            f"one block's {COARSE_MAX_SMEM}")
    out = torch.empty(nx * ny, dtype=r.dtype, device=r.device)
    _launch(
        "stencil5_affine", "krypy_stencil5_coarse",
        (r.data_ptr(), out.data_ptr(), nx, ny, nrows, ncols,
         *_grouped(coeffs), float(w), int(sweeps), COARSE_MAX_SMEM),
        r.device,
    )
    LAUNCHES["stencil5_coarse"] += 1
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
         *_grouped(sc1), beta1, *_grouped(sc2), alpha2, beta2,
         JACOBI2_STRIP, JACOBI2_STEP_ROWS, jacobi2_grid(nx, ny)[2]),
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


#: K8's defaults, chosen on the H100 (PERF.md §6, chip_smoke.py's mesh
#: phase): ``K8_OVERLAP``, the order against the exchange (False: one
#: launch after the halo rows arrive; True: the interior rows while they
#: cross, then rows 0 and ``nx_loc - 1``); ``K8_MAPPED``, the route of the
#: received rows under gloo (False: one copy into a device buffer; True:
#: the kernel reads the pinned receive buffer in place)
K8_OVERLAP = False
K8_MAPPED = True


def halo_segments(nrows, overlap):
    """K8's launches on a block of ``nrows`` rows, each a tuple of the one
    or two row segments ``(begin, end)`` its kernel computes: one launch
    of every row, or with ``overlap`` (and more than two rows) the
    interior rows, which read no halo row, and then rows 0 and ``nrows -
    1``."""
    if not overlap or nrows <= 2:
        return [((0, nrows),)]
    return [((1, nrows - 1),), ((0, 1), (nrows - 1, nrows))]


def stencil5_halo_torch(u, top, bot, coeffs):
    """Plain version of K8's kernel on a 2-D ``(R, P)`` row block: the
    plain stencil (:func:`stencil5_affine_torch`) on the rows ``[top; u;
    bot]``, its middle ``R`` rows.  ``top`` and ``bot`` are ``(P,)`` rows
    on any device, or None, the Dirichlet zero."""
    R, P = u.shape
    zero = torch.zeros((1, P), dtype=u.dtype, device=u.device)
    top, bot = (zero if t is None else t.reshape(1, P).to(u)
                for t in (top, bot))
    ext = torch.cat([top, u, bot], 0)
    return stencil5_affine_torch(ext, None, coeffs, R + 2, P)[1:-1]


def _halo_ptr(t, x, ny):
    """The address of a halo row for K8's kernel: None for None, else a
    contiguous float32 row of ``ny`` values on ``x``'s device or in pinned
    host memory (which the kernel reads in place)."""
    if t is None:
        return None
    if t.dtype != torch.float32 or t.numel() != ny or \
            not t.is_contiguous():
        raise ValueError(f"stencil5_halo: a halo row is a contiguous "
                         f"float32 row of {ny}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != x.device and not (t.device.type == "cpu"
                                     and t.is_pinned()):
        raise ValueError(f"stencil5_halo: a halo row lies on the operand's "
                         f"device {x.device} or in pinned host memory, "
                         f"not on {t.device}")
    return t.data_ptr()


def _halo_launch(x, top, bot, out, nx, ny, coeffs, segments):
    """One launch of K1's kernel in its halo form on the ``(nx, ny)`` row
    block ``x``: rows -1 and ``nx`` read from ``top`` and ``bot``, the
    output rows of ``segments`` (:func:`halo_segments`) written to
    ``out``."""
    (b0, e0), (b1, e1) = (segments + ((0, 0),))[:2]
    strips, _, steps = affine_grid(
        max(e0 - b0, e1 - b1), ny,
        ny % 4 == 0 and out.data_ptr() % 16 == 0)
    _launch(
        "stencil5_affine", "krypy_stencil5_affine",
        (x.data_ptr(), None, _halo_ptr(top, x, ny), _halo_ptr(bot, x, ny),
         out.data_ptr(), nx, ny, nx, ny, *_grouped(coeffs), 0.0, 0.0, b0, e0,
         b1, e1, JACOBI2_STRIP, JACOBI2_STEP_ROWS, strips, steps),
        x.device,
    )


def stencil5_halo(x, top=None, bot=None, *, nx, ny, coeffs):
    """K8's kernel: the 5-point Dirichlet matvec of an ``(nx, ny)`` row
    block (flat ``x``) whose row above is ``top`` and row below is ``bot``
    (``(ny,)`` rows; None is the Dirichlet zero).  Every row, the edge
    rows too, is computed whole in K1's grouped-difference arithmetic with
    its true neighbours: one launch of K1's kernel in its halo form,
    counted as a ``stencil5_affine`` launch.  On the card a halo row lies
    on ``x``'s device or in pinned host memory, which the kernel reads in
    place.  With both halos None it is K1's matvec of the block, the
    same bits.  Plain version: :func:`stencil5_halo_torch`."""
    if not _check("stencil5_halo", nx, ny, nx, ny, x):
        return stencil5_halo_torch(x.reshape(nx, ny), top, bot,
                                   coeffs).reshape(-1)
    out = torch.empty_like(x)
    _halo_launch(x, top, bot, out, nx, ny, coeffs,
                 halo_segments(nx, False)[0])
    return out


def _block_rows(nx, x, ny, mesh):
    """The rank's rows ``nx / P``; raises where P does not divide ``nx``
    or ``x`` is not a block of that many rows."""
    if nx % mesh.size != 0:
        raise ValueError(f"nx={nx} must be divisible by the mesh size "
                         f"{mesh.size} for the sharded stencil")
    nx_loc = nx // mesh.size
    if x.numel() != nx_loc * ny:
        raise ValueError(f"stencil5_sharded: operand has {x.numel()} "
                         f"elements, expected {nx_loc}*{ny}")
    return nx_loc


def _neighbours(rows, mesh):
    """The received ``(top, bottom)`` rows, None where the rank has no
    neighbour (the Dirichlet edge of the first and last rank)."""
    top, bot = rows
    return (top if mesh.rank > 0 else None,
            bot if mesh.rank < mesh.size - 1 else None)


def stencil5_sharded_torch(x, *, nx, ny, coeffs, mesh):
    """Plain version of K8: the same exchange, then the plain stencil on
    the rank's rows with the received rows above and below
    (:func:`stencil5_halo_torch`); any dtype, on any device."""
    nx_loc = _block_rows(nx, x, ny, mesh)
    u = x.reshape(nx_loc, ny)
    top, bot = _neighbours(halo_exchange(u[0], u[-1], mesh=mesh), mesh)
    return stencil5_halo_torch(u, top, bot, coeffs).reshape(-1)


def stencil5_sharded(x, *, nx, ny, coeffs, mesh, overlap=None,
                     mapped=None):
    """K8: the 5-point Dirichlet matvec of an ``nx x ny`` grid whose rows
    are split over ``mesh`` (a :class:`krypy_tpu_torch.parallel.Mesh`;
    ``nx`` divisible by its size, else ``ValueError``): ``x`` is the
    rank's flat ``(nx/P * ny,)`` row block.  One
    :func:`~krypy_tpu_torch.parallel.halo_exchange` per call brings the
    neighbours' edge rows, and K8's kernel (:func:`stencil5_halo`) computes
    every row whole with them: no fix-up follows.  ``overlap`` (default
    ``K8_OVERLAP``) runs the interior rows while the rows cross and then
    rows 0 and ``nx/P - 1``, two launches; ``mapped`` (default
    ``K8_MAPPED``) lets the kernel read the rows gloo received in pinned
    host memory in place instead of copying them to the card first.

    Counterpart of ``krypy_tpu.kernels.stencil.stencil5_sharded``; on a
    CUDA tensor it counts one ``stencil5_sharded`` launch per call and
    each kernel launch as a ``stencil5_affine`` one, and it launches or
    raises; on a CPU tensor it is :func:`stencil5_sharded_torch`.  The
    operand is checked before the exchange is posted."""
    overlap = K8_OVERLAP if overlap is None else overlap
    mapped = K8_MAPPED if mapped is None else mapped
    nx_loc = _block_rows(nx, x, ny, mesh)
    if not _check("stencil5_sharded", nx_loc, ny, nx_loc, ny, x):
        return stencil5_sharded_torch(x, nx=nx, ny=ny, coeffs=coeffs,
                                      mesh=mesh)
    u = x.view(nx_loc, ny)
    out = torch.empty_like(x)
    launches = halo_segments(nx_loc, overlap and mesh.size > 1)
    halo = halo_exchange(u[0], u[-1], mesh=mesh, async_op=True,
                         mapped=mapped)
    for segments in launches[:-1]:
        _halo_launch(x, None, None, out, nx_loc, ny, coeffs, segments)
    top, bot = _neighbours(halo.wait(), mesh)
    _halo_launch(x, top, bot, out, nx_loc, ny, coeffs, launches[-1])
    LAUNCHES["stencil5_sharded"] += 1
    return out
