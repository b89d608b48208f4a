r"""Chebyshev iteration, the solver with no reduction between its checks
(counterpart of :mod:`krypy_tpu.functional.chebyshev`).

Given bounds ``[lmin, lmax]`` on the spectrum of the SPD (preconditioned)
operator, the optimal residual polynomial is known a priori and each step
is one matvec, one preconditioner application and axpys (Saad,
*Iterative Methods for Sparse Linear Systems*, alg. 12.1).  The only
reduction is the TRUE residual's norm, taken once per ``check_every``
steps: on a mesh that is one all-reduce per block.

The JAX package runs the blocks as a ``lax.while_loop`` over a
``lax.scan``.  Here the blocks are a host loop that reads one scalar per
block, that norm.  The recurrence's scalars (``theta``, ``delta``,
``sigma1``, ``rho``) are host numbers in the system's real dtype
(``np_real``), so the steps never synchronise and round as the JAX
package's real-dtype scalars do.

:func:`spectral_bounds` runs ``steps`` Lanczos steps on ``M A`` on the
device, reads the tridiagonal once and takes its eigenvalues on the host.
"""

import numpy as np
import torch

from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    cast_matvec,
    global_length,
    host_vectors,
    mesh_sum,
    safe_div,
    system_dtype,
)
from .eigh import _norm

__all__ = ["chebyshev", "spectral_bounds"]


def _host_div(a, b):
    """``a / b`` of two host real-dtype numbers, 0 where ``b == 0``."""
    return a / b if b != 0 else type(a)(0)


def spectral_bounds(A, b, *, M=None, steps=24, safety=(0.5, 1.05)):
    """Estimate spectral bounds of the SPD (preconditioned) operator by a
    ``steps``-step Lanczos run on ``M A`` (the Euclidean recurrence: an
    estimate, not the ``M^-1`` inner product), then a host ``eigvalsh`` of
    the tridiagonal.

    :param safety: multipliers applied to the extremal Ritz values (Ritz
      values lie inside the spectrum; an underestimated ``lmin`` costs
      Chebyshev a slower rate, an underestimated ``lmax`` its
      convergence, hence the asymmetric defaults).
    :return: ``(lmin, lmax)`` floats for :func:`chebyshev`.
    """
    (b,) = host_vectors(b)
    bv = b.reshape(-1)
    dtype = system_dtype(bv)
    bv = bv.to(dtype)
    A_mv, M_mv = (cast_matvec(as_matvec(f), dtype) for f in (A, M))
    one = torch.ones((), dtype=bv.real.dtype, device=bv.device)

    v = bv * safe_div(one, _norm(bv))
    v_prev = torch.zeros_like(v)
    beta = torch.zeros_like(one)
    alphas, betas = [], []
    for _ in range(int(steps)):
        w = apply(M_mv, A_mv(v)) - beta * v_prev
        alpha = mesh_sum(torch.vdot(v, w)).real
        w = w - alpha * v
        beta = _norm(w)
        alphas.append(alpha)
        betas.append(beta)
        v_prev = v
        v = w * safe_div(one, beta)

    al = torch.stack(alphas).double().cpu().numpy()
    be = torch.stack(betas).double().cpu().numpy()
    T = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    w = np.linalg.eigvalsh(T)
    return float(safety[0] * w[0]), float(safety[1] * w[-1])


def chebyshev(
    A,
    b,
    *,
    lmin,
    lmax,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    check_every=16,
    stagnation_window=4,
):
    """Solve SPD ``A x = b`` (optionally with SPD preconditioner ``M``) by
    Chebyshev iteration.

    :param lmin, lmax: bounds on the spectrum of ``M A`` (from
      :func:`spectral_bounds`, Gershgorin, or problem knowledge).
    :param check_every: steps between TRUE residual-norm checks, the only
      reductions of the solve.
    :param stagnation_window: stop after this many checks without
      improvement (wrong bounds / attainable-accuracy guard); 0 disables.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      ``resnorms`` holds one relative residual per check block, ``niter``
      counts iterations (blocks * check_every).
    """
    b, x0 = host_vectors(b, x0)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    dev = bv.device
    maxiter = global_length(bv) if maxiter is None else int(maxiter)
    check_every = int(check_every)
    blocks = -(-maxiter // check_every)

    dtype = system_dtype(bv, x0)
    bv = bv.to(dtype)
    A_mv, M_mv = (cast_matvec(as_matvec(f), dtype) for f in (A, M))
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    tol_r = np_real(tol)

    theta = np_real((lmax + lmin) / 2.0)
    delta = np_real((lmax - lmin) / 2.0)
    sigma1 = _host_div(theta, delta)
    one = np_real(1.0)
    inv_delta = _host_div(one, delta)

    x = (torch.zeros(N, dtype=dtype, device=dev) if x0 is None
         else x0.reshape(-1).to(dtype))
    bnorm = _norm(bv)
    r = bv - A_mv(x)
    rel = np_real(safe_div(_norm(r), bnorm).item())
    d = apply(M_mv, r) * float(_host_div(one, theta))
    rho = _host_div(one, sigma1)

    resnorms = torch.full((blocks + 1,), float("nan"), dtype=real_dtype,
                          device=dev)
    resnorms[0] = float(rel)
    best, stall, broken, j = rel, 0, False, 0

    def going():
        go = rel > tol_r and j < blocks and not broken
        if stagnation_window > 0:
            go = go and stall < stagnation_window
        return go

    while going():
        for _ in range(check_every):
            x = x + d
            r = r - A_mv(d)
            z = apply(M_mv, r)
            rho_new = _host_div(one, np_real(2.0) * sigma1 - rho)
            d = float(rho_new * rho) * d + \
                float(np_real(2.0) * rho_new * inv_delta) * z
            rho = rho_new
        # the one reduction of the block: the TRUE residual (which also
        # refreshes the recurrence's r against drift)
        r = bv - A_mv(x)
        rel = np_real(safe_div(_norm(r), bnorm).item())
        broken = not np.isfinite(rel)
        stall = 0 if rel < best else stall + 1
        best = min(rel, best)
        j += 1
        resnorms[j] = float(rel)

    status = CONVERGED if rel <= tol_r else (BREAKDOWN if broken
                                             else MAXITER)
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=resnorms,
        niter=torch.tensor(j * check_every, device=dev),
        status=torch.tensor(status, device=dev),
    )
