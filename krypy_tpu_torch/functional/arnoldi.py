"""Arnoldi/Lanczos relation builder (counterpart of
:mod:`krypy_tpu.functional.arnoldi`).

Builds :math:`A V_n = V_{n+1}\\underline{H}_n` with fixed-shape buffers
and returns the basis, the Hessenberg matrix, the achieved dimension and
the invariance flag, for every ``ortho`` of the JAX function: ``cgs`` and
``cgs2`` (batched classical Gram-Schmidt over the active rows), ``mgs``
and ``dmgs`` (a row at a time), ``lanczos`` (the three-term recurrence),
``house`` (Householder reflectors stored as full-length rows) and
``cgs2_1r`` (one-reduce lagged CGS2, DCGS-2: one fused product per
iteration).  ``M`` keeps a dual basis ``V = M P``; ``ip`` is ``None``, a
matrix ``B`` or a scalar callable, as in the JAX package.

The JAX package's ``lax.while_loop`` is a host loop that reads one flag
per iteration, the invariance test.  Under an active mesh
(:mod:`krypy_tpu_torch.parallel`) ``v`` and the basis rows are the rank's
blocks and every reduction over N is a local partial plus one all-reduce
(``cgs2_1r``: one per iteration); the Householder scheme, whose
reflectors pivot at global positions, raises there.
"""

from typing import NamedTuple

import torch

from ..parallel import active_mesh
from .common import (
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    global_length,
    is_scalar_ip,
    make_inner,
    mesh_sum,
    norm_from_pair,
    safe_div,
    system_dtype,
)

__all__ = ["arnoldi", "ArnoldiResult"]

_PASSES = {"cgs": 1, "cgs2": 2, "mgs": 1, "dmgs": 2, "lanczos": 1}


class ArnoldiResult(NamedTuple):
    #: basis rows, shape ``(maxiter+1, N)``; rows beyond ``niter(+1)`` are 0
    V: torch.Tensor
    #: Hessenberg buffer ``(maxiter+1, maxiter)``
    H: torch.Tensor
    #: dual basis rows (``V = M P``) or None
    P: torch.Tensor
    #: number of completed iterations n
    niter: torch.Tensor
    #: True if the Krylov subspace became invariant (then
    #: :math:`A V_n = V_n H_n` with the leading n x n block)
    invariant: torch.Tensor


def _inv(x):
    return safe_div(torch.ones_like(x), x)


def _result(V, H, P, k, invariant):
    dev = V.device
    return ArnoldiResult(
        V=V, H=H, P=P,
        niter=torch.tensor(k, dtype=torch.int64, device=dev),
        invariant=torch.tensor(bool(invariant), device=dev),
    )


def arnoldi(A, v, *, maxiter=None, ortho="cgs2", M=None, ip=None):
    """Build the Arnoldi (or Lanczos, with ``ortho='lanczos'``) relation.

    :param A: matvec callable, 2-D tensor or numpy array.
    :param v: initial vector ``(N,)``.
    :param ortho: ``'cgs'``/``'cgs2'`` (batched), ``'mgs'``/``'dmgs'``
      (sequential), ``'lanczos'``, ``'house'`` (Euclidean, no ``M``) or
      ``'cgs2_1r'`` (one reduction per iteration).
    :param M: optional SPD preconditioner; a dual basis P with ``V = M P``
      is maintained.
    :param ip: inner product (None / matrix / scalar callable).
    """
    v = v.reshape(-1)
    N = v.shape[0]
    m = global_length(v) if maxiter is None else int(maxiter)

    if ortho == "house":
        if M is not None or ip is not None:
            raise ValueError(
                "Householder orthogonalization requires the Euclidean "
                "inner product and no preconditioner M"
            )
        if active_mesh() is not None:
            raise NotImplementedError(
                "ortho='house' on a mesh: its reflectors pivot at global "
                "positions; use ortho='cgs2' or 'dmgs'")
        return _arnoldi_house(A, v, m)

    if ortho == "cgs2_1r":
        if M is not None and ip is not None:
            raise ValueError(
                "ortho='cgs2_1r' with M supports the Euclidean base "
                "inner product only; use ortho='cgs2' for ip + M"
            )
        if is_scalar_ip(ip):
            raise ValueError(
                "ortho='cgs2_1r' supports the Euclidean or operator-weighted "
                "inner product only (the one-reduce fusion needs the raw "
                "B-application, not a scalar callable)"
            )
        return _arnoldi_1r(A, v, m, ip, M)

    if ortho not in _PASSES:
        raise KeyError(ortho)
    pair, rows = make_inner(ip)
    with_M = M is not None
    lanczos = ortho == "lanczos"
    passes = _PASSES[ortho]
    sequential = ortho in ("mgs", "dmgs")

    dtype = system_dtype(v)
    v = v.to(dtype)
    A_mv = cast_matvec(as_matvec(A), dtype)
    M_mv = cast_matvec(as_matvec(M), dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    brk = breakdown_threshold(dtype)
    dev = v.device

    V = torch.zeros((m + 1, N), dtype=dtype, device=dev)
    P = torch.zeros((m + 1, N), dtype=dtype, device=dev) if with_M else None
    if with_M:
        Mv = M_mv(v)
        vnorm = norm_from_pair(pair, v, Mv)
        V[0] = Mv * _inv(vnorm)
        P[0] = v * _inv(vnorm)
    else:
        vnorm = norm_from_pair(pair, v)
        V[0] = v * _inv(vnorm)
    basis = P if with_M else V
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    hsq = torch.zeros((), dtype=real_dtype, device=dev)

    def orthogonalize(w, k):
        h = torch.zeros(m + 1, dtype=dtype, device=dev)
        if lanczos:
            # three-term recurrence: project on rows k-1 and k only
            lo = max(k - 1, 0)
            coeffs = rows(V[lo: k + 1], w).real.to(dtype)
            w = w - coeffs @ basis[lo: k + 1]
            h[lo: k + 1] += coeffs
        elif sequential:
            for _ in range(passes):
                for j in range(k + 1):
                    coeff = rows(V[j][None, :], w)[0]
                    w = w - coeff * basis[j]
                    h[j] += coeff
        else:
            for _ in range(passes):
                coeffs = rows(V[: k + 1], w)
                w = w - coeffs @ basis[: k + 1]
                h[: k + 1] += coeffs
        return w, h

    invariant = bool(vnorm == 0)
    k = 0
    while k < m and not invariant:
        w = A_mv(V[k])
        w, h = orthogonalize(w, k)
        if lanczos and k > 0:
            # symmetrize: H[k-1, k] = H[k, k-1]
            h[k - 1] = H[k, k - 1]

        if with_M:
            Mw = M_mv(w)
            hnew = norm_from_pair(pair, w, Mw)
        else:
            hnew = norm_from_pair(pair, w)

        hsq = hsq + torch.sum(h.abs() ** 2) + hnew ** 2
        inv_t = hnew <= brk * torch.sqrt(hsq)
        h[k + 1] = hnew.to(dtype)
        H[:, k] = h

        inv_h = torch.where(inv_t, 0.0, _inv(hnew))
        if with_M:
            P[k + 1] = w * inv_h
            V[k + 1] = Mw * inv_h
        else:
            V[k + 1] = w * inv_h
        invariant = bool(inv_t)
        k += 1

    return _result(V, H, P, k, invariant)


def _arnoldi_1r(A, v, m, ip, M=None):
    r"""One-reduce lagged CGS-2 Arnoldi (DCGS-2; Świrydowicz, Langou,
    Ananthan, Yamazaki & Thomas, NLAA 2021).

    Each iteration makes exactly ONE reduction, the fused product of the
    active rows with ``[u, w]``: the reorthogonalization coefficients
    ``r = V^H u`` of the previous candidate (its delayed second pass), its
    norm by the Pythagorean identity :math:`\sigma^2 = \|u\|^2 -
    \|r\|^2`, and the first pass ``c = V^H w`` of ``w = A u``.  The
    Hessenberg column picks up the lag correction ``g = H (r/\sigma)``.
    The build makes m + 1 operator applications for m columns.  With
    ``M`` both buffers carry the trailing candidate (``u_v = M u_p``) and
    the new v-candidate is a fresh M application."""
    Bmv = None if ip is None else as_matvec(ip)
    N = v.shape[0]
    dtype = system_dtype(v)
    v = v.to(dtype)
    A_mv = cast_matvec(as_matvec(A), dtype)
    M_mv = cast_matvec(as_matvec(M), dtype)
    with_M = M_mv is not None
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    brk = breakdown_threshold(dtype)
    dev = v.device
    pair, _ = make_inner(ip)

    def prep(x):
        return x if Bmv is None else Bmv(x).to(dtype)

    # row m+1 holds the trailing once-projected candidate; column m of H
    # its first-pass coefficients -- both sliced off the result
    V = torch.zeros((m + 2, N), dtype=dtype, device=dev)
    P = torch.zeros((m + 2, N), dtype=dtype, device=dev) if with_M else None
    if with_M:
        Mv = M_mv(v)
        vnorm = norm_from_pair(pair, v, Mv)
        V[0] = Mv * _inv(vnorm)
        P[0] = v * _inv(vnorm)
    else:
        vnorm = norm_from_pair(pair, v)
        V[0] = v * _inv(vnorm)
    H = torch.zeros((m + 2, m + 1), dtype=dtype, device=dev)

    # peeled step 0: the first projection pass of A v0 (one reduce)
    w0 = A_mv(V[0])
    if with_M:
        chat0 = mesh_sum(V[0].conj() @ w0)
        H[0, 0] = chat0
        up0 = w0 - chat0 * P[0]
        P[1] = up0
        V[1] = M_mv(up0)
    else:
        chat0 = mesh_sum(V[0].conj() @ prep(w0))
        H[0, 0] = chat0
        V[1] = w0 - chat0 * V[0]

    hsq = torch.zeros((), dtype=real_dtype, device=dev)
    invariant = bool(vnorm == 0)
    k = 1
    while k < m + 1 and not invariant:
        u = V[k]
        w = A_mv(u)

        # THE one fused reduction of the iteration, over the active rows
        right0 = P[k] if with_M else prep(u)
        right1 = w if with_M else prep(w)
        Z = mesh_sum(V[: k + 1].conj() @ torch.stack([right0, right1],
                                                      dim=1))
        r = Z[:k, 0]
        s = Z[k, 0].real
        c = Z[:k, 1]
        t = Z[k, 1]

        sig2 = torch.clamp(s - torch.sum(r.abs() ** 2), min=0.0)
        sigma = torch.sqrt(sig2).to(real_dtype)

        # complete Hessenberg column k-1: reortho corrections + subdiag
        completed = H[:, k - 1].clone()
        completed[:k] += r
        completed[k] = sigma.to(dtype)
        hsq = hsq + torch.sum(completed.abs() ** 2)
        inv_t = sigma <= brk * torch.sqrt(hsq)
        H[:, k - 1] = completed

        inv_s = torch.where(inv_t, 0.0, _inv(sigma))
        V[k] = (u - r @ V[:k]) * inv_s
        if with_M:
            P[k] = (P[k] - r @ P[:k]) * inv_s

        # first-pass column k with the lag correction g = H (r/sigma)
        rt = r * inv_s
        g = H[:, :k] @ rt
        chat = torch.zeros(m + 2, dtype=dtype, device=dev)
        chat[:k] = c * inv_s
        chat[k] = (t - torch.vdot(r, c)) * inv_s * inv_s
        if with_M:
            up_next = w * inv_s - chat[: k + 1] @ P[: k + 1]
            P[k + 1] = up_next
            V[k + 1] = M_mv(up_next)
        else:
            V[k + 1] = w * inv_s - chat[: k + 1] @ V[: k + 1]
        H[:, k] = chat - g
        invariant = bool(inv_t)
        k += 1

    return _result(V[: m + 1], H[: m + 1, :m],
                   P[: m + 1] if with_M else None, k - 1, invariant)


def _house_masked(w, pos, dtype):
    """Householder data for the tail ``w[pos:]`` of a full-length vector:
    the full-length normalized reflector v (zeros before ``pos``), beta,
    alpha, xnorm."""
    n = w.shape[0]
    idx = torch.arange(n, device=w.device)
    tail = torch.where(idx >= pos, w, 0.0)
    gamma = w[pos] if pos < n else torch.zeros((), dtype=dtype,
                                                device=w.device)
    abs_gamma = gamma.abs()
    sigma = torch.sqrt(torch.clamp(
        torch.sum(torch.where(idx > pos, w.abs() ** 2, 0.0)), min=0.0))
    xnorm = torch.sqrt(abs_gamma ** 2 + sigma ** 2)

    one = torch.ones((), dtype=dtype, device=w.device)
    direction = safe_div(gamma, abs_gamma.to(dtype))
    sign_pos = torch.where(abs_gamma == 0, one, direction)
    sign_neg = torch.where(abs_gamma == 0, -one, direction)

    tail_zero = sigma == 0
    beta = torch.where(tail_zero, 0.0, 2.0).to(abs_gamma.dtype)
    alpha = torch.where(tail_zero, sign_pos, -sign_neg)
    v0 = torch.where(tail_zero, one, gamma + sign_neg * xnorm.to(dtype))
    v = torch.where(idx == pos, v0, tail)
    vnorm = torch.sqrt(v0.abs() ** 2 + sigma ** 2)
    v = v * _inv(vnorm)
    return v, beta, alpha, torch.where(tail_zero, abs_gamma, xnorm)


def _arnoldi_house(A, v, m):
    """Householder-orthogonalized Arnoldi.  Reflectors are stored as
    full-length rows with zeros before their pivot, so 'apply to the
    subvector x[j:]' is the plain full-length reflection."""
    N = v.shape[0]
    dtype = system_dtype(v)
    v = v.to(dtype)
    A_mv = cast_matvec(as_matvec(A), dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    brk = breakdown_threshold(dtype)
    dev = v.device
    idx = torch.arange(N, device=dev)

    v0h, beta0, alpha0, vnorm = _house_masked(v, 0, dtype)
    V = torch.zeros((m + 1, N), dtype=dtype, device=dev)
    V[0] = v * _inv(vnorm.to(real_dtype))
    Vh = torch.zeros((m + 1, N), dtype=dtype, device=dev)
    Vh[0] = v0h
    beta = torch.zeros(m + 1, dtype=real_dtype, device=dev)
    beta[0] = beta0
    alpha = torch.ones(m + 1, dtype=dtype, device=dev)
    alpha[0] = alpha0
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    hsq = torch.zeros((), dtype=real_dtype, device=dev)

    def reflect(w, j):
        vj = Vh[j]
        return w - beta[j] * vj * torch.vdot(vj, w)

    invariant = bool(vnorm == 0)
    k = 0
    while k < m and not invariant:
        w = A_mv(V[k])

        # forward sweep: reflect and phase-fix positions 0..k
        for j in range(k + 1):
            w = reflect(w, j)
            w = torch.where(idx == j, w * torch.conj(alpha[j]), w)

        # new reflector at position k+1
        vh, beta_new, alpha_new, _ = _house_masked(w, k + 1, dtype)
        w = w - beta_new * vh * torch.vdot(vh, w)
        w = torch.where(idx == k + 1, w * torch.conj(alpha_new), w)

        # Hessenberg column: entries 0..k+1, with a real non-negative
        # subdiagonal
        col = torch.where(idx <= k + 1, w, 0.0)
        col = (col[: m + 1] if N >= m + 1
               else torch.nn.functional.pad(col, (0, m + 1 - N)))
        subdiag = col[k + 1].abs() if k + 1 < m + 1 else \
            torch.zeros((), dtype=real_dtype, device=dev)
        col[k + 1] = subdiag.to(dtype)
        H[:, k] = col

        hsq = hsq + torch.sum(col.abs() ** 2)
        inv_t = subdiag <= brk * torch.sqrt(hsq)

        Vh[k + 1] = vh
        beta[k + 1] = beta_new
        alpha[k + 1] = alpha_new

        # reconstruct the next basis vector: e_{k+1} through the
        # reflectors in reverse, scaled by the newest phase
        vnew = torch.where(idx == k + 1, torch.ones((), dtype=dtype,
                                                    device=dev), 0.0)
        for j in range(k + 1, -1, -1):
            vnew = reflect(vnew, j)
        vnew = vnew * alpha_new
        invariant = bool(inv_t)
        if not invariant:
            V[k + 1] = vnew
        k += 1

    return _result(V, H, None, k, invariant)
