r"""Multi-shift solvers: solve (A + sigma_i I) x_i = b for MANY shifts
from ONE Krylov basis (counterpart of :mod:`krypy_tpu.functional.shifted`).

Krylov spaces are shift-invariant -- :math:`K_m(A, b) = K_m(A + \sigma
I, b)` -- so a single Arnoldi basis serves every shifted system: the
per-shift work is a small projected least squares with :math:`H +
\sigma \bar I` (one batched QR over the shifts), and the solution
assembly for ALL shifts is one ``(n_shifts, m) x (m, N)`` product.

* :func:`shifted_gmres` -- one cycle, per-shift status.
* :func:`restarted_shifted_gmres` -- Frommer & Glässner's seed-system
  restarts with collinear residuals, re-seeded on the hardest shift each
  cycle, explicit per-shift residuals and a per-shift restarted-GMRES
  rescue (:func:`~krypy_tpu_torch.functional.gmres.restarted_gmres`).
* :func:`shifted_cg` -- multi-shift CG (the :math:`\zeta` recurrence),
  ``variant="classic"`` (2 reductions per iteration), ``"1r"``
  (Chronopoulos-Gear: 1) or ``"auto"`` (``"1r"`` on a mesh of more than
  one rank where :func:`~krypy_tpu_torch.functional.policy.
  prefer_one_reduce` prices it so).

The JAX package's ``lax.while_loop``\ s are host loops: the Arnoldi
build reads its invariance flag once per step, a seed cycle reads its
breakdown test and its statistics once each, and a multi-shift CG
iteration reads the family's stop flag and the seed residual in one
transfer; the scalar recurrences stay on the device.  Under an active
mesh (:mod:`krypy_tpu_torch.parallel`) ``b`` and the iterates are the
rank's blocks, every reduction over N is a local partial plus one
all-reduce, and the small problems are replicated.

Limitations (inherent to shift invariance): no preconditioning,
Euclidean inner product, zero initial guess.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..parallel import active_mesh_size
from . import _short, policy
from .arnoldi import arnoldi
from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    global_length,
    host_vectors,
    mesh_sum,
    safe_div,
    system_dtype,
)

__all__ = [
    "shifted_cg",
    "shifted_gmres",
    "restarted_shifted_gmres",
    "ShiftedResult",
]


class ShiftedResult(NamedTuple):
    """Result of the multi-shift solvers."""

    #: solutions, shape ``(n_shifts, N)`` (row i solves ``(A + shifts[i]
    #: I) x = b``)
    X: torch.Tensor
    #: final relative residual per shift, shape ``(n_shifts,)``
    resnorms: torch.Tensor
    #: Krylov steps built, shared by all shifts (the TOTAL over cycles for
    #: :func:`restarted_shifted_gmres`)
    niter: torch.Tensor
    #: CONVERGED / MAXITER per shift, shape ``(n_shifts,)``
    status: torch.Tensor

    @property
    def converged(self):
        return self.status == CONVERGED


def _shifts(shifts, device):
    """The shifts as a flat tensor on ``device`` (numpy's dtype for
    Python numbers: float64 or complex128, as the JAX package's
    ``jnp.asarray``)."""
    if not isinstance(shifts, torch.Tensor):
        shifts = torch.from_numpy(np.array(shifts))
    return shifts.reshape(-1).to(device)


def _small_ls_parts(m, dtype, device):
    """The masked least squares' fixed parts: the unit columns that
    replace the columns past the achieved dimension (``sub_diag``), the
    shift pattern ``I`` of ``H + sigma I`` (``shift_rows``) and ``e1``."""
    j = torch.arange(m, device=device)
    sub_diag = torch.zeros((m + 1, m), dtype=dtype, device=device)
    sub_diag[j + 1, j] = 1
    shift_rows = torch.zeros((m + 1, m), dtype=dtype, device=device)
    shift_rows[j, j] = 1
    e1 = torch.zeros(m + 1, dtype=dtype, device=device)
    e1[0] = 1
    return sub_diag, shift_rows, e1


def _masked(Hs, sigma, k, sub_diag, shift_rows):
    """``H + sigma I`` for each shift, columns ``>= k`` replaced by
    orthonormal unit columns (their solution entries vanish)."""
    m = Hs.shape[1]
    col_mask = torch.arange(m, device=Hs.device) < k
    return torch.where(col_mask[None, None, :],
                       Hs[None] + sigma[:, None, None] * shift_rows[None],
                       sub_diag[None])


def _lstsq(Hm, rhs):
    """Least squares of each ``(m + 1, c)`` matrix by its reduced QR:
    ``(y, ||rhs - Hm y||)``, batched over the leading axis."""
    q, r = torch.linalg.qr(Hm)
    y = torch.linalg.solve_triangular(
        r, (q.conj().transpose(-2, -1) @ rhs[..., None]), upper=True)[..., 0]
    res = torch.linalg.vector_norm(rhs - (Hm @ y[..., None])[..., 0], dim=-1)
    return y, res


def shifted_gmres(A, b, shifts, *, maxiter=50, tol=1e-8, ortho="cgs2"):
    r"""Solve the shifted family ``(A + shifts[i] I) x_i = b`` with one
    Krylov basis.

    :param A: operator (matvec / matrix); the family member for shift 0.
    :param shifts: shifts ``(n_shifts,)``; complex shifts on a real
      operator promote the small solves (and the solutions) to complex
      while the basis build stays real.
    :param maxiter: Krylov dimension m (single cycle).
    :param tol: per-shift relative residual target.
    :return: :class:`ShiftedResult`.
    """
    (b,) = host_vectors(b)
    bv = b.reshape(-1)
    dev = bv.device
    m = min(int(maxiter), global_length(bv))
    shifts = _shifts(shifts, dev)

    A_mv = as_matvec(A)
    dtype = system_dtype(bv)
    small_dtype = torch.promote_types(dtype, shifts.dtype)
    shifts = shifts.to(small_dtype)

    rel = arnoldi(A_mv, bv, maxiter=m, ortho=ortho)
    V, H, k = rel.V, rel.H, rel.niter
    beta = _short.norm(bv.to(dtype))

    sub_diag, shift_rows, _ = _small_ls_parts(m, small_dtype, dev)
    rhs = torch.zeros(m + 1, dtype=small_dtype, device=dev)
    rhs[0] = beta.to(small_dtype)
    Hm = _masked(H.to(small_dtype), shifts, k, sub_diag, shift_rows)
    Y, res = _lstsq(Hm, rhs)                      # (s, m), (s,)

    # all solutions in ONE basis product
    X = Y @ V[:m].to(small_dtype)                 # (s, N)

    rel_res = safe_div(res, beta.to(res.dtype))
    status = torch.where(rel_res <= tol, CONVERGED, MAXITER)
    return ShiftedResult(X=X, resnorms=rel_res, niter=k, status=status)


#: seed-cycle cache (the JAX package's compiled-cycle cache, keyed
#: alike): a sequence of calls on the same operator, shift count and
#: options reuses one set of cycle, check and rescue functions
_SEED_CYCLE_CACHE = {}
_SEED_CYCLE_CACHE_MAX = 16


def _seed_cycle_functions(A, A_mv, m, ortho, max_restarts, tol):
    """``(cycle, check, rescue)`` of :func:`restarted_shifted_gmres` for
    the operator ``A``."""

    def cycle(r_dir, betas, X, sh, seed_idx):
        """One seed cycle: ``r_dir`` the shared unit residual direction,
        ``betas`` the per-shift collinearity factors (r_i = betas[i] *
        r_dir), ``X`` the iterates ``(ns, N)``.  Returns the new
        ``(r_dir, betas, X)`` and the host statistics ``(max |beta|,
        Krylov steps, hardest shift)``."""
        small = r_dir.dtype
        dev = r_dir.device
        rel = arnoldi(A_mv, r_dir, maxiter=m, ortho=ortho)
        V, H, k = rel.V, rel.H, rel.niter
        sub_diag, shift_rows, e1 = _small_ls_parts(m, small, dev)
        Hs = H.to(small)
        # z is in the e1-normalized small coordinates, so the happy-
        # breakdown test is relative to 1
        brk = float(breakdown_threshold(small))

        # seed: masked least squares at its shift
        Hseed = _masked(Hs, sh[seed_idx: seed_idx + 1], k, sub_diag,
                        shift_rows)[0]
        y_seed, _ = _lstsq(Hseed, e1)
        z = e1 - Hseed @ y_seed                  # (m+1,) small residual
        znorm = torch.linalg.vector_norm(z)
        Hm = _masked(Hs, sh, k, sub_diag, shift_rows)
        rhs = betas[:, None] * e1[None, :]

        # z ~ 0 (invariance of the Krylov space, the seed being the
        # hardest shift) would make the augmented system singular: there
        # the plain per-shift least squares is exact for every shift
        if bool(znorm > brk):
            Msq = torch.cat([Hm, z[None, :, None].expand(Hm.shape[0], -1,
                                                         1)], dim=2)
            w, _ = _lstsq(Msq, rhs)
            Ys, zetas = w[:, :m].clone(), w[:, m].clone()
            # the seed's own row: r_seed_new = beta_seed * z
            Ys[seed_idx] = betas[seed_idx] * y_seed
            zetas[seed_idx] = betas[seed_idx]
            betas_new = zetas * znorm
            r_dir_new = (z @ V.to(small)) * safe_div(torch.ones_like(znorm),
                                                      znorm)
        else:
            Ys, resn = _lstsq(Hm, rhs)
            betas_new, r_dir_new = resn.to(small), r_dir
        X = X + Ys @ V[:m].to(small)
        absb = betas_new.abs()
        stats = _short.read(absb.max(), k.to(absb.dtype),
                            torch.argmax(absb).to(absb.dtype))
        return r_dir_new, betas_new, X, stats

    def check(XX, ss, bb):
        """The explicit residual norm of each shift's iterate."""
        return torch.stack([_short.norm(bb - (A_mv(x) + s * x))
                            for x, s in zip(XX, ss)])

    def rescue(bb, x0, sg):
        from .gmres import restarted_gmres

        return restarted_gmres(
            lambda v: A_mv(v) + sg * v, bb, x0=x0, maxiter=m,
            max_restarts=int(max_restarts), tol=float(tol), compiled=True)

    cycle._keepalive = (A,)
    return cycle, check, rescue


def restarted_shifted_gmres(
    A, b, shifts, *, maxiter=50, max_restarts=10, tol=1e-8,
    ortho="cgs2", seed=0, stagnation_window=3,
):
    r"""Restarted multi-shift GMRES with COLLINEAR residuals (the
    seed-system scheme of Frommer & Glässner, SIAM J. Sci. Comput.
    19(1), 1998).

    The seed shift runs ordinary restarted GMRES; every other shift
    solves the square augmented system :math:`[\bar H + \sigma_i \bar I
    \,|\, z] [y_i; \zeta_i] = \beta_i e_1` with ``z`` the seed's
    small-coordinate residual, which keeps all residuals parallel.
    Final per-shift relative residuals are recomputed explicitly, and
    shifts left unconverged finish by per-shift restarted GMRES from
    their iterates.

    :param seed: index into ``shifts`` of the initial seed system; after
      every cycle the seed moves to the shift with the largest implied
      residual.
    :param stagnation_window: stop after this many cycles without
      improvement in the family's max implied residual and return the
      best snapshot; 0 disables.
    :return: :class:`ShiftedResult` with ``niter`` = total Krylov steps.
    """
    (b,) = host_vectors(b)
    bv = b.reshape(-1)
    dev = bv.device
    N = bv.shape[0]
    m = min(int(maxiter), global_length(bv))
    shifts = _shifts(shifts, dev)
    ns = shifts.shape[0]
    seed = int(seed)
    if not 0 <= seed < ns:
        raise ValueError(f"seed index {seed} outside [0, {ns})")

    dtype = system_dtype(bv)
    small_dtype = torch.promote_types(dtype, shifts.dtype)
    shifts = shifts.to(small_dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    # after the first cycle the shared residual direction lives in the
    # promoted dtype (complex for complex shifts), so the basis build
    # runs there too
    A_mv = cast_matvec(as_matvec(A), small_dtype)

    ckey = (id(A), m, ortho, ns, str(small_dtype), N, float(tol),
            int(max_restarts))
    cached = _SEED_CYCLE_CACHE.get(ckey)
    if cached is None:
        cached = _seed_cycle_functions(A, A_mv, m, ortho, max_restarts, tol)
        if len(_SEED_CYCLE_CACHE) >= _SEED_CYCLE_CACHE_MAX:
            _SEED_CYCLE_CACHE.pop(next(iter(_SEED_CYCLE_CACHE)))
        _SEED_CYCLE_CACHE[ckey] = cached
    cycle, check, rescue = cached

    bnorm = _short.norm(bv.to(dtype))
    r_dir = (bv * safe_div(torch.ones_like(bnorm), bnorm)).to(small_dtype)
    betas = torch.full((ns,), 0, dtype=small_dtype, device=dev) + \
        bnorm.to(small_dtype)
    X = torch.zeros((ns, N), dtype=small_dtype, device=dev)
    total_k = 0
    # float32 floor guard: keep the best-X snapshot and stop after
    # `stagnation_window` cycles without improvement
    best = float("inf")
    X_best = X
    stall = 0
    bnorm_f = float(bnorm)
    seed_idx = seed
    for _ in range(int(max_restarts) + 1):
        r_dir, betas, X, stats = cycle(r_dir, betas, X, shifts, seed_idx)
        absmax, k = float(np_real(stats[0])), int(stats[1])
        total_k += k
        if absmax < best:
            best, X_best, stall = absmax, X, 0
        else:
            stall += 1
        if absmax <= tol * bnorm_f:
            break
        if stagnation_window and stall >= stagnation_window:
            break
        # re-seed on the hardest shift (Frommer-Glassner)
        seed_idx = int(stats[2])
    X = X_best

    bb = bv.to(small_dtype)
    floor = torch.clamp(bnorm, min=torch.finfo(real_dtype).tiny)

    def rel_residuals(X):
        return (check(X, shifts, bb) / floor).real.to(real_dtype).cpu() \
            .numpy()

    rel_res = rel_residuals(X)
    # rescue pass: finish shifts the collinear scheme left unconverged
    for i in np.nonzero(rel_res > tol)[0]:
        ri = rescue(bb, X[i], shifts[i])
        total_k += int(ri.niter)
        X = X.clone()
        X[i] = ri.x.to(small_dtype)
    if bool(np.any(rel_res > tol)):
        rel_res = rel_residuals(X)
    rel_res = torch.from_numpy(rel_res).to(dev)
    status = torch.where(rel_res <= tol, CONVERGED, MAXITER)
    return ShiftedResult(
        X=X, resnorms=rel_res,
        niter=torch.tensor(total_k, dtype=torch.int64, device=dev),
        status=status,
    )


def shifted_cg(A, b, shifts, *, maxiter=None, tol=1e-8,
               stagnation_window=None, variant="classic"):
    r"""Solve the SPD shifted family ``(A + shifts[i] I) x_i = b`` by
    multi-shift CG.

    The seed system (shift 0) drives an ordinary CG recurrence; every
    shifted system rides it through the :math:`\zeta` scalar recurrence
    (Jegerlehner 1996): its residual is :math:`r_k^\sigma = \zeta_k^\sigma
    r_k`, so per iteration the whole family costs ONE matvec, the base
    system's reductions and rank-1 updates of the ``(n_shifts, N)``
    iterate and direction blocks.  Requires SPD ``A`` and real ``shifts
    >= 0``.  Final statuses are verified against explicitly recomputed
    per-shift true residuals.

    :param stagnation_window: float32 guard on the SEED residual: after
      this many iterations without a new minimum the solve stops and
      returns the iterates snapshotted at the best seed residual.
      Defaults to ``max(50, maxiter // 10)``; 0 disables.
    :param variant: ``"classic"`` (2 reductions per iteration),
      ``"1r"`` (Chronopoulos-Gear rearrangement of the seed recurrence:
      ONE stacked product, one all-reduce per iteration on a mesh), or
      ``"auto"`` (``"1r"`` where a mesh of more than one rank is active
      and :func:`~krypy_tpu_torch.functional.policy.prefer_one_reduce`
      prices it so).
    :return: :class:`ShiftedResult` (``resnorms`` holds the final TRUE
      relative residual per shift).
    """
    (b,) = host_vectors(b)
    bv = b.reshape(-1)
    dev = bv.device
    n_glob = global_length(bv)
    maxiter = n_glob if maxiter is None else int(maxiter)
    if stagnation_window is None:
        stagnation_window = max(50, maxiter // 10)
    shifts = _shifts(shifts, dev)
    s = shifts.shape[0]

    dtype = system_dtype(bv)
    bv = bv.to(dtype)
    A_mv = cast_matvec(as_matvec(A), dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    sig = shifts.to(real_dtype)

    def real_dot(x, y):
        return mesh_sum(torch.vdot(x, y)).real.to(real_dtype)

    bnorm = _short.norm(bv)
    inv_bnorm = safe_div(torch.ones_like(bnorm), bnorm)
    rho = real_dot(bv, bv)

    if variant == "auto":
        # priced selection (the shared model of functional/policy.py)
        mesh_n = active_mesh_size()
        variant = (
            "1r"
            if mesh_n > 1 and policy.prefer_one_reduce(
                "shifted_cg", n_glob // mesh_n,
                torch.empty(0, dtype=dtype).element_size(), device=dev)
            else "classic"
        )
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown shifted_cg variant {variant!r}")
    one_reduce = variant == "1r"

    def scalar(v):
        return torch.tensor(v, dtype=real_dtype, device=dev)

    x = torch.zeros((s, bv.shape[0]), dtype=dtype, device=dev)
    ps = bv.expand(s, -1).clone()
    r, p = bv, bv
    zeta = torch.ones(s, dtype=real_dtype, device=dev)
    zeta_old = zeta
    alpha_old, beta_old = scalar(1.0), scalar(0.0)
    x_best = torch.zeros_like(x)
    best_rel = np_real(np.inf)
    stall, done, k = 0, False, 0
    if one_reduce:
        s_dir = A_mv(bv)  # s_0 = A p_0 = A r_0
        delta = real_dot(bv, s_dir)

    def going():
        go = not done and k < maxiter
        if stagnation_window > 0:
            go = go and stall < stagnation_window
        return go

    while going():
        if one_reduce:
            # Chronopoulos-Gear on the seed: alpha from the gamma/delta
            # recurrence, the coupled s = A p direction, and ONE stacked
            # product for gamma_new/delta_new
            pAp = delta - beta_old / torch.where(
                alpha_old == 0, 1.0, alpha_old) * rho
            alpha = safe_div(rho, pAp)
            r_new = r - alpha.to(dtype) * s_dir
            w_new = A_mv(r_new)
            both = mesh_sum(torch.stack([r_new, w_new]).conj() @ r_new) \
                .real.to(real_dtype)
            rho_new = torch.clamp(both[0], min=0.0)
            delta_new = both[1]
            beta = safe_div(rho_new, rho)
            s_new = w_new + beta.to(dtype) * s_dir
        else:
            Ap = A_mv(p)
            pAp = real_dot(p, Ap)
            alpha = safe_div(rho, pAp)
            r_new = r - alpha.to(dtype) * Ap
            rho_new = real_dot(r_new, r_new)
            beta = safe_div(rho_new, rho)

        # zeta recurrence (a vanishing denominator marks the shift as
        # stalled, not NaN)
        den = (alpha * beta_old * (zeta_old - zeta)
               + zeta_old * alpha_old * (1.0 + sig * alpha))
        zeta_new = safe_div(zeta * zeta_old * alpha_old, den)
        ratio = safe_div(zeta_new, zeta)
        alpha_s = alpha * ratio
        beta_s = beta * ratio ** 2

        x = x + alpha_s[:, None].to(dtype) * ps
        ps = (zeta_new[:, None].to(dtype) * r_new[None, :]
              + beta_s[:, None].to(dtype) * ps)
        # the base direction p only feeds <p, Ap>, which the 1r
        # recurrence replaces
        if not one_reduce:
            p = r_new + beta.to(dtype) * p

        # stop when every shifted residual |zeta| ||r|| meets tol
        root = torch.sqrt(torch.clamp(rho_new, min=0.0))
        rel = zeta_new.abs() * root * inv_bnorm
        seed_rel = root * inv_bnorm
        seed_rel, all_ok = _short.read(seed_rel, torch.all(rel <= tol))
        done = bool(all_ok)
        seed_rel = np_real(seed_rel)

        # seed-residual stagnation guard with best-iterate snapshots
        if seed_rel < best_rel:
            best_rel, stall, x_best = seed_rel, 0, x
        else:
            stall += 1
        r, rho = r_new, rho_new
        zeta_old, zeta = zeta, zeta_new
        alpha_old, beta_old = alpha, beta
        if one_reduce:
            s_dir, delta = s_new, delta_new
        k += 1

    if stagnation_window > 0:
        # a CONVERGED exit keeps the final iterate; the best-seed snapshot
        # replaces it on a stagnation exit
        X = x if done else x_best
    else:
        X = x

    # explicit per-shift true residuals
    AX = torch.stack([A_mv(row) for row in X])
    R = bv[None, :] - AX - sig[:, None].to(dtype) * X
    res = torch.sqrt(mesh_sum((R.abs() ** 2).sum(dim=1)))
    rel = safe_div(res, bnorm.expand_as(res))
    status = torch.where(rel <= tol, CONVERGED, MAXITER)
    return ShiftedResult(
        X=X, resnorms=rel,
        niter=torch.tensor(k, dtype=torch.int64, device=dev),
        status=status,
    )
