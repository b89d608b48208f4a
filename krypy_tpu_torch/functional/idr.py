"""IDR(s) (counterpart of :mod:`krypy_tpu.functional.idr`).

The biorthogonal IDR(s) of van Gijzen & Sonneveld (ACM TOMS 38(1),
2011), with the preconditioner on the right: a fixed orthonormal
``(s, N)`` shadow panel ``P``, ``s`` inner steps (one matvec each) and
one minimal-residual step per cycle, ``s + 1`` matvecs; the small
``(s, s)`` systems are triangular solves on the device.  The host loop
reads the cycle's residual entries and its breakdown flag once per cycle
(:mod:`~krypy_tpu_torch.functional._short`).

The shadow panel has the JAX package's structure (orthonormal rows, row
0 the normalized initial residual, the others from a Gaussian block) but
not its numbers: the JAX package draws with ``jax.random``, the port
with a ``torch.Generator`` seeded by ``seed`` on ``b``'s device.  Its
orthonormalization is CholeskyQR2 with positive ``R`` diagonal, through
one all-reduce of the ``(s, s)`` Gram per pass on a mesh, so that a
sharded solve builds the one-device panel (each rank draws the whole
block and keeps its rows).

``variant="1r"`` takes each step's products from one cross-Gram (one
all-reduce per matvec on a mesh), as the JAX package's.
"""

import numpy as np
import torch

from . import _short
from .cg import resolve_variant
from .common import BREAKDOWN, CONVERGED, MAXITER, apply, mesh_sum, safe_div
from ..parallel import active_mesh, block_of

__all__ = ["idrs"]


def _tril_solve(L, rhs):
    return torch.linalg.solve_triangular(L, rhs[:, None], upper=False)[:, 0]


def _shadow_block(seed, s, N, dtype, r0):
    """The fixed orthonormal ``(s, N)`` shadow panel (this rank's columns
    of it under a mesh): a Gaussian ``(N, s)`` block drawn from a
    ``torch.Generator`` seeded by ``seed`` on ``r0``'s device (complex
    dtypes add an imaginary block), its column 0 replaced by ``r0 /
    ||r0||``, orthonormalized by CholeskyQR2; row 0 of the panel is then
    ``r0 / ||r0||`` to rounding."""
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    mesh = active_mesh()
    n = N if mesh is None else int(mesh_sum(torch.tensor(
        N, device=r0.device)))
    gen = torch.Generator(device=r0.device).manual_seed(int(seed))
    block = torch.randn((n, s), generator=gen, dtype=real_dtype,
                        device=r0.device).to(dtype)
    if dtype.is_complex:
        block = block + 1j * torch.randn(
            (n, s), generator=gen, dtype=real_dtype, device=r0.device)
    if mesh is not None:
        block = block[block_of(n, mesh)]
    r0n = _short.norm(r0)
    block[:, 0] = r0 * safe_div(torch.ones_like(r0n), r0n)
    for _ in range(2):
        gram = mesh_sum(block.conj().T @ block)
        R = torch.linalg.cholesky(gram).conj().T
        block = torch.linalg.solve_triangular(R, block, upper=True,
                                              left=False)
    return block.T.contiguous()


def idrs(
    A,
    b,
    *,
    s=4,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=0,
    explicit_residual=False,
    seed=0,
    variant="classic",
):
    """Solve nonsymmetric ``A x = b`` by IDR(s) with biorthogonal
    shadow-space recurrences.

    :param s: Sonneveld-space codimension (memory ``2 s + 2`` vectors).
    :param M: optional right preconditioner (applied inside the
      recurrence; the tracked residual is the true residual).
    :param maxiter: bound on the matvecs (default N); a cycle of ``s +
      1`` matvecs always completes, so up to ``s`` more may run.
    :param stagnation_window: if > 0, stop after this many cycles
      without improving the best residual below 99% of it.
    :param seed: seed of the shadow panel's generator (module docstring).
    :param variant: ``"classic"``, ``"1r"`` (one all-reduce per matvec)
      or ``"auto"`` (``"1r"`` on a mesh of more than one rank where
      :func:`~krypy_tpu_torch.functional.policy.prefer_one_reduce` says
      so).
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult` with
      ``resnorms`` indexed by matvec count and ``niter`` the matvecs.
    """
    sy = _short.System(A, b, x0, M)
    A_mv, (M_mv,) = sy.A_mv, sy.operators
    dtype, dev, N = sy.dtype, sy.dev, sy.N
    n_global = sy.n_global()
    maxiter = n_global if maxiter is None else int(maxiter)
    s = int(s)
    if s < 1:
        raise ValueError("idrs requires s >= 1")
    variant = resolve_variant("idrs", variant, None, n_global, dtype, dev)
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown idrs variant {variant!r}")
    one_reduce = variant == "1r"
    tol_r = sy.np_real(tol)
    eps = sy.eps

    bv = sy.bv
    x = sy.x0v
    bnorm = _short.norm(bv)
    r = bv - A_mv(x)
    (rel,) = _short.read(safe_div(_short.norm(r), bnorm))
    rel = sy.np_real(rel)

    P = _shadow_block(seed, s, N, dtype, r)
    Pc = P.conj()
    angle = sy.scalar(0.7, real=True)  # omega maintenance threshold
    nbuf = maxiter + s + 2  # cycles overrun maxiter by at most s matvecs

    U = sy.zeros(s, N)
    G = sy.zeros(s, N)
    Mmat = torch.eye(s, dtype=dtype, device=dev)
    GG = sy.zeros(s, s)
    om = sy.scalar(1.0)
    f = mesh_sum(Pc @ r) if one_reduce else None
    broken_t = torch.zeros((), dtype=torch.bool, device=dev)
    broken = False
    best, stall, it = rel, 0, 0
    resnorms = [rel]

    while (rel > tol_r and it < maxiter and not broken
           and (stagnation_window <= 0 or stall < stagnation_window)):
        if not one_reduce:
            f = mesh_sum(Pc @ r)
        rel_ks = []
        for k in range(s):
            c = _tril_solve(Mmat[k:, k:], f[k:])
            v = apply(M_mv, r - c @ G[k:])
            u_k = om * v + c @ U[k:]
            g_t = A_mv(u_k)
            if one_reduce:
                # THE one reduction of the step: the shadow projections
                # P^H g_t and the anchors P^H r, <r, g_t>, ||r||^2,
                # ||g_t||^2, <g_i, g_t>, <g_i, r> for i < k
                L = torch.cat([Pc, r.conj()[None], g_t.conj()[None],
                               G[:k].conj()])
                Gm = mesh_sum(L @ torch.stack([g_t, r], dim=1))
                h, f_meas = Gm[:s, 0], Gm[:s, 1]
                r_gt, rr_m = Gm[s, 0], Gm[s, 1].real
                gt_gt = Gm[s + 1, 0].real
                gi_gt, gi_r = Gm[s + 2:, 0], Gm[s + 2:, 1]
                if k > 0:
                    alphas = _tril_solve(Mmat[:k, :k], h[:k])
                    g_k = g_t - alphas @ G[:k]
                    u_k = u_k - alphas @ U[:k]
                    Mcol = h[k:] - Mmat[k:, :k] @ alphas
                    r_gk = r_gt - torch.sum(alphas * gi_r.conj())
                    gg_col = gi_gt - GG[:k, :k] @ alphas
                    gk_gk = torch.clamp(
                        gt_gt - 2.0 * torch.sum(alphas.conj() * gi_gt).real
                        + torch.vdot(alphas, GG[:k, :k] @ alphas).real,
                        min=0.0)
                    GG[:k, k] = gg_col
                    GG[k, :k] = gg_col.conj()
                else:
                    g_k, Mcol, r_gk, gk_gk = g_t, h, r_gt, gt_gt
                GG[k, k] = gk_gk.to(dtype)
            else:
                g_k = g_t
                # biorthogonalize against the shadow rows < k: one
                # triangular solve on ONE (k, N) x (N,) product
                if k > 0:
                    alphas = _tril_solve(Mmat[:k, :k],
                                         mesh_sum(Pc[:k] @ g_k))
                    g_k = g_k - alphas @ G[:k]
                    u_k = u_k - alphas @ U[:k]
                Mcol = mesh_sum(Pc[k:] @ g_k)
            Mmat[k:, k] = Mcol
            Mkk = Mmat[k, k]
            broken_t = broken_t | (Mkk.abs() <= eps)
            beta = safe_div(f_meas[k] if one_reduce else f[k], Mkk)
            r = r - beta * g_k
            x = x + beta * u_k
            if one_reduce:
                # the next step's f: the fresh measurement minus the
                # recurrence step <p_j, r'> = <p_j, r> - beta M[j, k]
                ph = sy.zeros(s)
                ph[k:] = Mcol
                f = f_meas - beta * ph
                rr_new = torch.clamp(
                    rr_m - 2.0 * (beta * r_gk).real
                    + beta.abs() ** 2 * gk_gk, min=0.0)
                rel_ks.append(safe_div(torch.sqrt(rr_new), bnorm))
            else:
                if k + 1 < s:
                    f = f.clone()
                    f[k + 1:] = f[k + 1:] - beta * Mmat[k + 1:, k]
                rel_ks.append(safe_div(_short.norm(r), bnorm))
            G[k] = g_k
            U[k] = u_k

        # the omega step, with the "maintaining the convergence"
        # safeguard on the angle between t and r
        v = apply(M_mv, r)
        t = A_mv(v)
        if one_reduce:
            # <t,t>, <t,r>, <r,r> and the next cycle's f = P^H (r - om t)
            # from one (s+2, N) x (N, 2) product
            G2 = mesh_sum(torch.cat([Pc, t.conj()[None], r.conj()[None]])
                          @ torch.stack([t, r], dim=1))
            f_t, f_r = G2[:s, 0], G2[:s, 1]
            tt, ts, rr_m2 = G2[s, 0].real, G2[s, 1], G2[s + 1, 1].real
            tn = torch.sqrt(torch.clamp(tt, min=0.0))
            rn = torch.sqrt(torch.clamp(rr_m2, min=0.0))
            om = safe_div(ts, tt)
        else:
            tn = _short.norm(t)
            rn = _short.norm(r)
            ts = _short.vdot(t, r)
            om = safe_div(ts, _short.vdot(t, t).real)
        rho = safe_div(ts.abs(), tn * rn)
        om = om * torch.where(rho < angle, safe_div(angle, rho),
                              torch.ones_like(rho))
        broken_t = broken_t | (om.abs() <= eps)
        x = x + om * v
        r = r - om * t
        it += s + 1
        if one_reduce:
            rr_om = torch.clamp(
                rr_m2 - 2.0 * (om.conj() * ts).real + om.abs() ** 2 * tt,
                min=0.0)
            rel_upd = safe_div(torch.sqrt(rr_om), bnorm)
            f = f_r - om * f_t
        else:
            rel_upd = safe_div(_short.norm(r), bnorm)
        *rel_ks, rel_upd, lost = _short.read(*rel_ks, rel_upd, broken_t)
        rel = sy.np_real(rel_upd)
        if explicit_residual or rel <= tol_r or it >= maxiter:
            rel = sy.true_rel(x, bnorm)
        broken = bool(lost) or not np.isfinite(rel)
        stall = 0 if rel < sy.np_real(0.99) * best else stall + 1
        best = np.minimum(best, rel)
        resnorms += [sy.np_real(v) for v in rel_ks] + [rel]

    if rel <= tol_r:
        status = CONVERGED
    else:
        status = BREAKDOWN if broken else MAXITER
    return sy.finish(x, resnorms, nbuf, it, status)
