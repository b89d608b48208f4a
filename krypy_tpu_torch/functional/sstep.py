r"""Communication-avoiding s-step solvers, CA-CG and CA-GMRES (counterpart
of :mod:`krypy_tpu.functional.sstep`).

Both advance ``s`` Krylov steps per block: ``s`` operator applications
with no reduction between them (the matrix powers), then a few block
reductions over the whole panel.  The JAX package runs the blocks as a
``lax.while_loop``.  Here the blocks are a host loop that reads one
scalar per block, the explicit relative residual (CA-GMRES reads with it
whether the panel's factor stayed finite), and makes every stop-rule
comparison in the system's real dtype (``np_real``), as the compiled
loop does.

Under an active mesh (:mod:`krypy_tpu_torch.parallel`) vectors and basis
rows are the rank's blocks and each reduction over N is a local partial
and one all-reduce (:func:`~krypy_tpu_torch.functional.common.mesh_sum`):

* ``ca_cg``: the conjugation ``AP^H V``, the fused Gram ``P^H [AP, r]``
  and the residual's M-norm, three per block;
* ``ca_gmres``: two block Gram-Schmidt passes (one per 32-row panel of
  the active basis, the JAX package's panel sweep), the two CholQR2
  Grams and the explicit residual's norm, five per block while the basis
  fits one panel, plus ``s`` norms for the Newton and Chebyshev bases.

The JAX package's ``jax.pure_callback`` for the Newton shifts is one host
read of the warm-up's small Hessenberg here, and its compiled restart
cycle cache has no counterpart: :func:`restarted_ca_gmres` calls
:func:`ca_gmres` per cycle with the shifts as host arrays or tensors
alike.
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

__all__ = ["ca_cg", "ca_gmres", "modified_leja", "newton_shifts",
           "restarted_ca_gmres"]


def _real_dtypes(dtype):
    """The real dtype of ``dtype`` and its host (numpy) mirror."""
    real = torch.empty(0, dtype=dtype).real.dtype
    return real, torch.empty(0, dtype=real).numpy().dtype.type


def _inv(t):
    return safe_div(torch.ones_like(t), t)


def _stop_status(rel, tol_r, broken):
    return CONVERGED if rel <= tol_r else (BREAKDOWN if broken else MAXITER)


def _result(x, flat, resnorms, blocks, real_dtype, np_real, niter, status):
    dev = x.device
    res = torch.full((blocks + 1,), float("nan"), dtype=real_dtype,
                     device=dev)
    res[: len(resnorms)] = torch.tensor(
        np.asarray(resnorms, dtype=np_real), dtype=real_dtype).to(dev)
    return SolveResult(x=x if flat else x[:, None], resnorms=res,
                       niter=torch.tensor(niter, device=dev),
                       status=torch.tensor(status, device=dev))


def _conjugate(V, AV, P, AP, W):
    """``(V, AV)`` A-conjugated against the previous direction block ``P``
    (``AP = A P``, ``W = P^H A P``): one ``(s, N) x (N, s)``
    contraction."""
    cross = mesh_sum(AP.conj().T @ V)
    Bc = -torch.linalg.solve_ex(W, cross)[0]
    return V + P @ Bc, AV + AP @ Bc


def ca_cg(
    A,
    b,
    *,
    s=4,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    lam_est=None,
    power_iters=8,
    stagnation_window=20,
    explicit_residual=True,
):
    """Solve SPD ``A x = b`` (optionally with SPD preconditioner ``M``) by
    s-step CG: per block a monomial basis ``[Mr, (MA) Mr, ...]`` scaled
    by a one-time spectral estimate, its A-conjugation against the
    previous block in one ``(s, N) x (N, s)`` contraction, and the fused
    Gram ``P^H [AP, r]`` in one ``(s, N) x (N, s+1)`` contraction.

    :param s: CG steps per block (keep small, <= 8).
    :param lam_est: the basis powers' scale; ``power_iters`` power
      iterations on ``M A`` estimate it when not given.
    :param maxiter: CG-iteration budget (rounded up to blocks).
    :param stagnation_window: stop after this many blocks without
      improvement of the residual; 0 disables the guard.
    :param explicit_residual: recompute ``b - A x`` once per block.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      ``resnorms`` holds one relative M-norm residual per block,
      ``niter`` counts CG iterations (blocks * s).
    """
    b, x0 = host_vectors(b, x0)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    dev = bv.device
    s = int(s)
    maxiter = global_length(bv) if maxiter is None else int(maxiter)
    blocks = -(-maxiter // s)

    dtype = system_dtype(bv, x0)
    bv = bv.to(dtype)
    A_mv, M_mv = (cast_matvec(as_matvec(f), dtype) for f in (A, M))
    real_dtype, np_real = _real_dtypes(dtype)
    tol_r = np_real(tol)
    x = (torch.zeros(N, dtype=dtype, device=dev) if x0 is None
         else x0.reshape(-1).to(dtype))

    def m_norm(r, Mr):
        # the M-weighted residual norm of classic preconditioned CG
        return torch.sqrt(torch.clamp(mesh_sum(torch.vdot(r, Mr)).real,
                                      min=0.0))

    bnorm = m_norm(bv, apply(M_mv, bv))
    r = bv - A_mv(x)
    Mr = apply(M_mv, r)
    rel0 = safe_div(m_norm(r, Mr), bnorm)

    if lam_est is None:
        u = r / torch.clamp(_norm(r), min=1e-30)
        for _ in range(int(power_iters)):
            w = apply(M_mv, A_mv(u))
            u = w / torch.clamp(_norm(w), min=1e-30)
        lam = torch.clamp(_norm(apply(M_mv, A_mv(u))), min=1e-30).to(
            real_dtype)
    else:
        lam = torch.tensor(lam_est, dtype=real_dtype, device=dev)

    P = torch.zeros((N, s), dtype=dtype, device=dev)
    AP = torch.zeros((N, s), dtype=dtype, device=dev)
    W = torch.eye(s, dtype=dtype, device=dev)
    rel = np_real(rel0.item())
    resnorms = [rel]
    best, stall, broken, j = rel, 0, False, 0

    def going():
        go = rel > tol_r and j < blocks and not broken
        if stagnation_window > 0:
            go = go and stall < stagnation_window
        return go

    while going():
        # 1. the monomial basis (its seed M r came with the last check)
        v = Mr
        Vcols, AVcols = [v], [A_mv(v)]
        for _ in range(s - 1):
            v = apply(M_mv, AVcols[-1]) / lam
            Vcols.append(v)
            AVcols.append(A_mv(v))
        V = torch.stack(Vcols, dim=1)
        AV = torch.stack(AVcols, dim=1)
        # 2. A-conjugation against the previous block: one contraction
        P, AP = _conjugate(V, AV, P, AP, W)
        # 3. the fused block Gram and projection: one contraction
        G = mesh_sum(P.conj().T @ torch.cat([AP, r[:, None]], dim=1))
        W = G[:, :s]
        a = torch.linalg.solve_ex(W, G[:, s])[0]
        x = x + P @ a
        r = bv - A_mv(x) if explicit_residual else r - AP @ a
        # 4. the check: one reduction, one host read
        Mr = apply(M_mv, r)
        rel = np_real(safe_div(m_norm(r, Mr), bnorm).item())
        broken = not np.isfinite(rel)
        stall = 0 if rel < best else stall + 1
        best = np.minimum(rel, best)
        j += 1
        resnorms.append(rel)

    return _result(x, flat, resnorms, blocks, real_dtype, np_real, j * s,
                   _stop_status(rel, tol_r, broken))


def modified_leja(ev):
    """Order points by the modified Leja ordering, conjugate pairs kept
    adjacent with the Im>0 member first (each next point maximizes the
    product of distances to the points already chosen, which keeps the
    Newton basis polynomial bounded on the spectrum)."""
    ev = np.asarray(ev, complex).ravel()
    remaining = list(range(ev.size))
    order = []

    def pick(idx):
        # Im>0 member of a conjugate pair goes first
        if ev[idx].imag < 0:
            tgt = ev[idx].conjugate()
            close = [
                r for r in remaining
                if abs(ev[r] - tgt) <= 1e-10 * max(1.0, abs(tgt))
            ]
            if close:
                idx = close[0]
        order.append(idx)
        remaining.remove(idx)
        if ev[idx].imag > 0:
            tgt = ev[idx].conjugate()
            if remaining:
                j = min(remaining, key=lambda r: abs(ev[r] - tgt))
                order.append(j)
                remaining.remove(j)

    while remaining:
        if not order:
            idx = max(remaining, key=lambda r: abs(ev[r]))
        else:
            chosen = ev[order]
            idx = max(
                remaining,
                key=lambda r: float(
                    np.sum(np.log(np.abs(ev[r] - chosen) + 1e-300))
                ),
            )
        pick(idx)
    return ev[order]


def _leja_head(ev, s):
    """First ``s`` Leja-ordered shifts, never splitting a conjugate pair:
    an Im>0 opener whose conjugate falls outside the window collapses to
    its real part."""
    head = np.asarray(ev, complex)[:s].copy()
    if s >= 1 and head[-1].imag > 0:
        head[-1] = head[-1].real
    return head


def _ordered_shift_arrays(ev, s, real_np):
    """Leja-ordered ``(theta_re, theta_im)`` host arrays of length ``s``
    from eigenvalue estimates; fewer than ``s`` estimates are padded by
    repeating the last (real-collapsed) shift."""
    ev = _leja_head(modified_leja(np.asarray(ev)), s)
    if ev.size < s:
        pad_val = ev[-1].real if ev.size else 1.0
        ev = np.concatenate([ev, np.full(s - ev.size, pad_val)])
    return ev.real.astype(real_np), ev.imag.astype(real_np)


def _arnoldi_warmup(MlAMr, seed, s, dtype):
    """``s`` steps of CGS2 Arnoldi from ``seed``; the ``(s+1, s)``
    Hessenberg, on the device, whose eigenvalues seed the shifts."""
    Hw = torch.zeros((s + 1, s), dtype=dtype, device=seed.device)
    vs = [seed]
    for j in range(s):
        w = MlAMr(vs[j])
        Vj = torch.stack(vs)
        for _ in range(2):
            c = mesh_sum(Vj.conj() @ w)
            w = w - c @ Vj
            Hw[: j + 1, j] += c
        hj = _norm(w)
        Hw[j + 1, j] = hj.to(dtype)
        vs.append(w * _inv(hj))
    return Hw


def _host_ritz(Hw, wu):
    """The eigenvalues of the warm-up's leading ``wu x wu`` block, the
    one host read of the shifts."""
    return np.linalg.eigvals(Hw[:wu, :wu].cpu().numpy())


def _operators(A, Ml, Mr, dtype):
    A_mv, Ml_mv, Mr_mv = (cast_matvec(as_matvec(f), dtype)
                          for f in (A, Ml, Mr))

    def MlAMr(v):
        return apply(Ml_mv, A_mv(apply(Mr_mv, v)))

    return A_mv, Ml_mv, Mr_mv, MlAMr


def newton_shifts(A, b, s, *, Ml=None, Mr=None, x0=None, warmup=None):
    """Leja-ordered Ritz estimates for the Newton basis of
    :func:`ca_gmres`: a ``warmup``-step Arnoldi (default ``max(s, 8)``)
    on the device, then the small nonsymmetric eigenproblem and the
    ordering on the host.  Returns a complex ndarray; pass it as
    ``ca_gmres(..., shifts=...)`` to skip the warm-up."""
    w_steps = max(int(s), 8) if warmup is None else max(int(warmup), int(s))
    b, x0 = host_vectors(b, x0)
    bv = b.reshape(-1)
    dtype = system_dtype(bv, x0)
    bv = bv.to(dtype)
    A_mv, Ml_mv, _, MlAMr = _operators(A, Ml, Mr, dtype)
    x0v = (torch.zeros_like(bv) if x0 is None
           else x0.reshape(-1).to(dtype))
    r0 = apply(Ml_mv, bv - A_mv(x0v))
    seed = r0 * _inv(_norm(r0))
    Hw = _arnoldi_warmup(MlAMr, seed, w_steps, dtype)
    return modified_leja(_host_ritz(Hw, w_steps))


def _gs_pass(V, Z, C, k, rows, proj, upd):
    """One pass of block classical Gram-Schmidt of the panel ``Z`` against
    the basis rows ``0..k``, ``rows`` at a time (the JAX package's row
    panels: one reduction each); the coefficients accumulate into ``C``.
    Returns the projected panel."""
    for p in range(k // rows + 1):
        lo, hi = p * rows, min((p + 1) * rows, k + 1)
        Vp = V[lo:hi]
        coeffs = mesh_sum(proj(Vp, Z))
        Z = Z - upd(coeffs.T, Vp)
        C[lo:hi] += coeffs
    return Z


def _panel_solve(L, Z):
    """``conj(L)^{-1} Z`` for the panel ``Z`` (s, N) by forward
    substitution, one row of the panel at a time: ``s`` products over N
    on every device (a library triangular solve with N right-hand sides
    is the slow form on the card)."""
    Lc = L.conj()
    Q = torch.empty_like(Z)
    for i in range(Z.shape[0]):
        row = Z[i] - Lc[i, :i] @ Q[:i] if i else Z[i]
        Q[i] = row / Lc[i, i]
    return Q


def _shifted_chol(G, s, eye_s, eps):
    """Cholesky factor of ``G + 64 eps tr(G)/s I`` (shifted CholeskyQR);
    NaN where the factorization fails, as the JAX package's, with no
    host read."""
    scale = torch.real(torch.trace(G)) / s
    L, info = torch.linalg.cholesky_ex(G + ((64.0 * eps) * scale).to(
        G.dtype) * eye_s)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def ca_gmres(
    A,
    b,
    *,
    s=4,
    basis="monomial",
    shifts=None,
    shift_warmup=None,
    Ml=None,
    Mr=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    lam_est=None,
    power_iters=8,
    stagnation_window=20,
    return_internal=False,
    basis_dtype=None,
):
    r"""Communication-avoiding s-step GMRES (after Hoemmen's CA-GMRES):
    per block ``s`` applications of :math:`M_l A M_r` with no reduction
    between them, two passes of block classical Gram-Schmidt of the
    ``(s, N)`` panel against the whole basis, CholQR2 of the panel, the
    new Hessenberg columns recovered from C, R and the previous H, and
    one explicit residual.  In exact arithmetic the iterates equal
    GMRES's at block boundaries; ``resnorms`` has one entry per block,
    ``niter`` counts Arnoldi steps (blocks * s).

    :param basis: ``"monomial"`` (scaled powers, by ``lam_est`` or
      ``power_iters`` power iterations), ``"newton"`` (Leja-ordered
      shifts, conjugate pairs in real arithmetic, a norm per step) or
      ``"chebyshev"`` (the three-term recurrence on the ellipse around
      the Ritz estimates, its center ``c`` and ``e^2/4``, which may be
      negative, a norm per step).
    :param shifts: for ``"newton"``/``"chebyshev"``: eigenvalue
      estimates (at least ``s``; Leja-ordered here), or a pre-ordered
      pair ``(theta_re, theta_im)`` of length ``s`` each (host arrays or
      tensors); by default a ``shift_warmup``-step Arnoldi (default
      ``max(s, 8)``) and one host read of its Hessenberg.
    :param basis_dtype: storage dtype of the basis (e.g.
      ``torch.bfloat16``): the Gram-Schmidt products read it narrow and
      accumulate in the system dtype; real systems only.
    :param return_internal: also return ``{"V", "H", "lam"}`` and
      ``"shifts"`` (Newton) or ``"ellipse"`` (Chebyshev).
    """
    b, x0 = host_vectors(b, x0)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    dev = bv.device
    s = int(s)
    maxiter = global_length(bv) if maxiter is None else int(maxiter)
    blocks = -(-maxiter // s)
    m = blocks * s

    dtype = system_dtype(bv, x0)
    bdt = dtype if basis_dtype is None else basis_dtype
    mixed = bdt != dtype
    is_complex = dtype.is_complex
    if mixed and is_complex:
        raise ValueError("basis_dtype supports real systems only")
    bv = bv.to(dtype)
    A_mv, Ml_mv, Mr_mv, MlAMr = _operators(A, Ml, Mr, dtype)
    real_dtype, np_real = _real_dtypes(dtype)
    tol_r = np_real(tol)
    x0v = (torch.zeros(N, dtype=dtype, device=dev) if x0 is None
           else x0.reshape(-1).to(dtype))

    Mlb_norm = _norm(apply(Ml_mv, bv))
    Mlr0 = apply(Ml_mv, bv - A_mv(x0v))
    beta = _norm(Mlr0)
    rel0 = safe_div(beta, Mlb_norm)

    if basis not in ("monomial", "newton", "chebyshev"):
        raise ValueError(f"unknown s-step basis {basis!r}")
    use_newton = basis == "newton"
    use_cheb = basis == "chebyshev"

    if use_newton or use_cheb:
        lam = torch.ones((), dtype=real_dtype, device=dev)
    elif lam_est is None:
        u = Mlr0 / torch.clamp(beta, min=1e-30)
        for _ in range(int(power_iters)):
            w = MlAMr(u)
            u = w / torch.clamp(_norm(w), min=1e-30)
        lam = torch.clamp(_norm(MlAMr(u)), min=1e-30).to(real_dtype)
    else:
        lam = torch.tensor(lam_est, dtype=real_dtype, device=dev)
    inv_lam = (1.0 / lam).to(real_dtype)

    v0 = (beta > 0).to(real_dtype) * _inv(beta)
    V = torch.zeros((m + 1, N), dtype=bdt, device=dev)
    V[0] = (Mlr0 * v0).to(bdt)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    eye_s = torch.eye(s, dtype=dtype, device=dev)
    eps = float(torch.finfo(real_dtype).eps)

    if mixed:
        # read the basis at its storage width, accumulate wide (the port's
        # gmres convention: the other operand rounded to the basis dtype)
        def narrow(t):
            return t.to(bdt).to(dtype)

        def _proj(Vp, Z):
            return Vp.to(dtype).conj() @ narrow(Z).T

        def _upd(coeffs, Vp):
            return narrow(coeffs) @ Vp.to(dtype)

        def _assemble(yrow, Vp):
            return yrow @ Vp.to(dtype)
    else:
        def _proj(Vp, Z):
            return Vp.conj() @ Z.T

        def _upd(coeffs, Vp):
            return coeffs @ Vp

        _assemble = _upd
    # the JAX package's row panels of the basis sweeps
    _pr = max(1, min(32, m + 1))
    _pra = max(1, min(32, m))

    if use_newton or use_cheb:
        if isinstance(shifts, tuple):
            # pre-ordered shift arrays of length s (host arrays or tensors)
            theta_re, theta_im = (
                torch.as_tensor(t).to(device=dev, dtype=real_dtype)
                for t in shifts)
            if theta_re.shape != (s,) or theta_im.shape != (s,):
                raise ValueError(
                    f"traced shifts need shape ({s},) each, got "
                    f"{tuple(theta_re.shape)}/{tuple(theta_im.shape)}")
        else:
            if shifts is not None:
                ev = _leja_head(modified_leja(np.asarray(shifts)), s)
                if ev.size < s:
                    raise ValueError(f"need >= {s} shifts, got {ev.size}")
            else:
                wu = (max(s, 8) if shift_warmup is None
                      else max(int(shift_warmup), s))
                Hw = _arnoldi_warmup(MlAMr, V[0].to(dtype), wu, dtype)
                ev = _leja_head(modified_leja(_host_ritz(Hw, wu)), s)
            theta_re = torch.tensor(ev.real, device=dev).to(real_dtype)
            theta_im = torch.tensor(ev.imag, device=dev).to(real_dtype)
        if use_cheb:
            # the axis-aligned enclosing ellipse (5% margin): its center
            # and squared quarter-focal distance e2q = (a^2 - b^2) / 4
            a_semi = 0.5 * (theta_re.max() - theta_re.min()) * 1.05
            if is_complex:
                c_im = 0.5 * (theta_im.max() + theta_im.min())
                b_semi = 0.5 * (theta_im.max() - theta_im.min()) * 1.05
                ccen = torch.complex(0.5 * (theta_re.max() + theta_re.min()),
                                     c_im).to(dtype)
            else:
                b_semi = theta_im.abs().max() * 1.05
                ccen = (0.5 * (theta_re.max() + theta_re.min())).to(dtype)
            e2q = ((a_semi ** 2 - b_semi ** 2) / 4.0).to(dtype)
        elif is_complex:
            theta = torch.complex(theta_re, theta_im).to(dtype)
            b2 = torch.zeros(s, dtype=real_dtype, device=dev)
        else:
            theta = theta_re.to(dtype)
            # conjugate-pair correction: u_{i+2} gets +(Im^2/sigma_i) u_i
            b2 = torch.where(theta_im > 0, theta_im ** 2,
                             torch.zeros_like(theta_im))

    rel = np_real(rel0.item())
    resnorms = [rel]
    x = x0v
    best, stall, broken, j = rel, 0, False, 0
    sidx = torch.arange(s, device=dev)

    def going():
        go = rel > tol_r and j < blocks and not broken
        if stagnation_window > 0:
            go = go and stall < stagnation_window
        return go

    while going():
        k = j * s
        # 1. the s-step basis
        u = V[k].to(dtype)
        cols, sigs = [], []
        if use_newton or use_cheb:
            uprev = torch.zeros_like(u)
            for i in range(s):
                if use_newton:
                    w = MlAMr(u) - theta[i] * u
                    if i >= 1:
                        w = w + (b2[i - 1] * _inv(sigs[i - 1])).to(
                            dtype) * uprev
                else:
                    w = MlAMr(u) - ccen * u
                    if i >= 1:
                        w = w - (e2q * _inv(sigs[i - 1]).to(dtype)) * uprev
                sig = _norm(w)
                uprev = u
                u = w * _inv(sig)
                sigs.append(sig)
                cols.append(u)
            sig_arr = torch.stack(sigs).to(real_dtype)
        else:
            for _ in range(s):
                u = MlAMr(u) * inv_lam
                cols.append(u)
            sig_arr = lam.expand(s)
        Z = torch.stack(cols)

        # the basis-generation matrix T: (MlAMr)[u_0..u_{s-1}] = [u_0..u_s] T
        Td = torch.zeros((s + 1, s), dtype=dtype, device=dev)
        Td[sidx + 1, sidx] = sig_arr.to(dtype)
        if use_newton:
            Td[sidx, sidx] = theta
            if s > 1:
                Td[sidx[:-1], sidx[1:]] = -(b2[: s - 1] * _inv(
                    sig_arr[: s - 1])).to(dtype)
        elif use_cheb:
            Td[sidx, sidx] = ccen
            if s > 1:
                Td[sidx[:-1], sidx[1:]] = e2q * _inv(
                    sig_arr[: s - 1]).to(dtype)

        # 2. block Gram-Schmidt twice against rows 0..k, panel by panel
        C = torch.zeros((m + 1, s), dtype=dtype, device=dev)
        for _ in range(2):
            Z = _gs_pass(V, Z, C, k, _pr, _proj, _upd)

        # 3. shifted CholQR2 of the panel: Z = conj(L1 L2) Q, R = L2^H L1^H
        L1 = _shifted_chol(mesh_sum(Z.conj() @ Z.T), s, eye_s, eps)
        Q1 = _panel_solve(L1, Z)
        L2 = _shifted_chol(mesh_sum(Q1.conj() @ Q1.T), s, eye_s, eps)
        Qp = _panel_solve(L2, Q1)
        Rt = L2.conj().T @ L1.conj().T
        V[k + 1: k + 1 + s] = Qp.to(bdt)

        # 4. the Hessenberg columns k..k+s-1 from C, R and the previous H
        Zc = C.clone()
        Zc[k + 1: k + 1 + s] += Rt
        AU = Zc @ Td[1:, :]
        AU[k] += Td[0, :]
        H[:, k] = AU[:, 0]
        if s > 1:
            M2 = H @ C[:m, :]
            M1p = torch.cat([AU[:, 1:], torch.zeros((m + 1, 1), dtype=dtype,
                                                    device=dev)], dim=1)
            Rinv = torch.linalg.solve_triangular(Rt, eye_s, upper=True)
            H[:, k + 1: k + s] = (M1p - M2) @ Rinv[:, : s - 1]

        # 5. least squares on the leading (K+1, K) block and the iterate
        K = k + s
        qm, rm = torch.linalg.qr(H[: K + 1, :K])
        y = torch.linalg.solve_triangular(
            rm, qm[0].conj()[:, None] * beta.to(dtype), upper=True)[:, 0]
        yk = torch.zeros(N, dtype=dtype, device=dev)
        for p in range((K - 1) // _pra + 1):
            lo, hi = p * _pra, min((p + 1) * _pra, K)
            yk = yk + _assemble(y[lo:hi], V[lo:hi])
        xk = x0v + apply(Mr_mv, yk)

        # 6. the explicit residual, and the one host read of the block
        rel_new = safe_div(_norm(apply(Ml_mv, bv - A_mv(xk))), Mlb_norm)
        finite = torch.isfinite(Rt).all() & torch.isfinite(rel_new)
        rel_new, fin = torch.stack([rel_new, finite.to(real_dtype)]).tolist()
        broken = not fin
        if not broken:
            rel, x = np_real(rel_new), xk
        stall = 0 if rel < best else stall + 1
        best = np.minimum(rel, best)
        j += 1
        resnorms.append(rel)

    result = _result(x, flat, resnorms, blocks, real_dtype, np_real, j * s,
                     _stop_status(rel, tol_r, broken))
    if return_internal:
        internal = {"V": V, "H": H, "lam": lam}
        if use_newton:
            internal["shifts"] = theta
        elif use_cheb:
            internal["ellipse"] = (ccen, e2q)
        return result, internal
    return result


#: Newton shifts per operator (an operator property, so sequences of
#: right-hand sides skip the warm-up), keyed by id() and keeping the
#: keyed objects alive; a small FIFO bounds it
_CA_SHIFTS_CACHE = {}
_CA_SHIFTS_KEEPALIVE = {}
_CA_SHIFTS_MAX = 16


def restarted_ca_gmres(
    A,
    b,
    *,
    max_restarts=0,
    maxiter=None,
    tol=1e-5,
    s=4,
    basis="newton",
    shifts=None,
    shift_warmup=None,
    refresh_shifts=True,
    **kwargs,
):
    """Restarted CA-GMRES: a host loop of :func:`ca_gmres` cycles, each
    from the last iterate.  The first shifts come from
    :func:`newton_shifts`, cached per operator; with ``refresh_shifts``
    each restart re-seeds them from the Leja-ordered Ritz values of the
    cycle that just finished (a host eig of its small Hessenberg).  The
    histories of the cycles are concatenated, one entry per block."""
    b = host_vectors(b)[0]
    x = kwargs.pop("x0", None)
    if x is None:
        x = torch.zeros(b.reshape(-1).shape[0], dtype=b.dtype,
                        device=b.device)
        if b.ndim > 1:
            x = x[:, None]
    else:
        x = host_vectors(x)[0].to(b.device)
    _, real_np = _real_dtypes(b.dtype)

    needs_shifts = basis in ("newton", "chebyshev")
    tre = tim = None
    if needs_shifts:
        if shifts is None:
            sk = (id(A), int(s), id(kwargs.get("Ml")), id(kwargs.get("Mr")),
                  b.reshape(-1).shape[0], shift_warmup)
            shifts = _CA_SHIFTS_CACHE.get(sk)
            if shifts is None:
                shifts = newton_shifts(
                    A, b, s, Ml=kwargs.get("Ml"), Mr=kwargs.get("Mr"), x0=x,
                    warmup=shift_warmup)
                if len(_CA_SHIFTS_CACHE) >= _CA_SHIFTS_MAX:
                    old = next(iter(_CA_SHIFTS_CACHE))
                    _CA_SHIFTS_CACHE.pop(old)
                    _CA_SHIFTS_KEEPALIVE.pop(old, None)
                _CA_SHIFTS_CACHE[sk] = shifts
                _CA_SHIFTS_KEEPALIVE[sk] = (A, kwargs.get("Ml"),
                                            kwargs.get("Mr"))
        if isinstance(shifts, tuple):
            tre, tim = shifts
        else:
            tre, tim = _ordered_shift_arrays(shifts, int(s), real_np)

    resnorms = []
    result = None
    for _ in range(max_restarts + 1):
        result, internal = ca_gmres(
            A, b, x0=x, tol=tol, maxiter=maxiter, s=s, basis=basis,
            shifts=(tre, tim) if needs_shifts else None,
            return_internal=True, **kwargs)
        nsteps = int(result.niter)
        nblocks = nsteps // max(int(s), 1)
        chunk = result.resnorms[: nblocks + 1].tolist()
        resnorms = resnorms[:-1] + chunk if resnorms else chunk
        x = result.x
        if int(result.status) in (CONVERGED, BREAKDOWN):
            break
        if needs_shifts and refresh_shifts and nsteps >= s:
            # re-seed from this cycle's Ritz values
            Hs = internal["H"][:nsteps, :nsteps].cpu().numpy()
            ev = np.linalg.eigvals(Hs)
            ev = ev[np.isfinite(ev)]
            if ev.size:
                tre, tim = _ordered_shift_arrays(ev, int(s), real_np)

    return result._replace(
        resnorms=torch.tensor(resnorms, dtype=result.resnorms.dtype,
                              device=result.x.device),
        x=x)
