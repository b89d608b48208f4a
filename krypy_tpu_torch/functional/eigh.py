r"""Thick-restart Lanczos eigensolver for Hermitian operators
(counterpart of :mod:`krypy_tpu.functional.eigh`).

Computes k extremal eigenpairs of a Hermitian :math:`A` with the
thick-restart Lanczos method (after Wu & Simon 2000): build an
m-dimensional Krylov basis, compress it to the l best Ritz pairs plus
the residual direction, and continue.  Every option of the JAX
signature is here: ``which``, ``maxdim``, ``thick``, shift-invert
(``sigma`` + ``inv``, verified against ``A``), generalized pencils
(``B``/``Binv``), block Lanczos (``block_size``) and the one-reduce
sweep (``ortho="cgs2_1r"``).

The JAX package runs the whole solve as one ``lax.while_loop``; here it
is a host loop over restart cycles whose sweeps and compressions stay on
the device and read nothing back: the Lanczos steps (CGS2 with both
passes accumulated into ``H``, or the lagged one-reduce sweep) decide
deflation with ``torch.where``, and the loop reads one flag per restart
cycle, the convergence test.  The ``(m, m)`` Hermitian eigendecomposition
runs on the device (``torch.linalg.eigh``, in the system dtype, as the
JAX package's ``jnp.linalg.eigh``): it sits between the sweeps, and a
host round trip of ``H`` would add a read per cycle for no gain.  Its
eigenvectors differ from the JAX package's by signs (and by the basis
picked inside a degenerate eigenspace), so the compressed bases differ
by those signs; eigenvalues, counts and subspaces agree.

Under an active mesh (:func:`krypy_tpu_torch.parallel.active_mesh`) the
vectors are the ranks' blocks: each inner product and norm over N is the
local partial plus one all-reduce, and the small matrices are the same
bits on every rank.  The start vector, the starting block and the power
iteration's vector are the JAX package's deterministic ``cos`` vectors,
computed in float64 on the device (this rank's block of them under a
mesh).  They live on ``v0``'s device, else the active mesh's, else
``A``'s (a tensor's device, an operator's ``device`` attribute or the
device of its ``diag``), else ``"cuda"`` (a numpy ``A`` too), which
raises where torch sees no card.
"""

from typing import NamedTuple

import torch

from ..core.dtypes import asarray, torch_dtype
from ..parallel import active_mesh, block_of
from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    global_length,
    mesh_sum,
    safe_div,
    system_dtype,
)

__all__ = ["eigsh", "EigshResult"]


class EigshResult(NamedTuple):
    """Result of :func:`eigsh`; every field is a tensor."""

    #: converged eigenvalue estimates, shape ``(k,)``, sorted by the
    #: selection criterion (``which``)
    theta: torch.Tensor
    #: Ritz vectors as columns, shape ``(N, k)`` (the deflation-basis
    #: convention)
    U: torch.Tensor
    #: max relative residual of the k wanted pairs per restart cycle
    resnorms: torch.Tensor
    #: total Lanczos steps (matvecs)
    niter: torch.Tensor
    #: CONVERGED / MAXITER
    status: torch.Tensor
    #: final per-pair residuals, shape ``(k,)``: Lanczos border residuals
    #: in general, pencil residuals for generalized problems, backward
    #: errors against A for shift-invert
    pair_resnorms: torch.Tensor = None

    @property
    def converged(self):
        return bool(self.status == CONVERGED)


# ---------------------------------------------------------------------------
# what the eigensolvers share (eigs, lobpcg and filtered import these)
# ---------------------------------------------------------------------------


def _dots(V, w):
    """``V^H w`` over the whole vector: one all-reduce on a mesh."""
    return mesh_sum(V.conj() @ w)


def _norm(w):
    """``||w||_2`` over the whole vector."""
    return torch.sqrt(mesh_sum(torch.sum(torch.abs(w) ** 2)))


def _row_norms(Z):
    """The 2-norms of the rows of ``Z`` over the whole vectors."""
    return torch.sqrt(mesh_sum(torch.sum(torch.abs(Z) ** 2, dim=1)))


def _gram(L, R):
    """``G[i, j] = <L_i, R_j>`` for row bundles: one all-reduce."""
    return mesh_sum(L.conj() @ R.T)


def _block_matvec(op, dtype):
    """``op`` lifted to ``(p, N)`` row blocks in ``dtype`` (the JAX
    package's ``jax.vmap`` of the matvec): a matrix (a 2-D tensor or
    numpy array) in one product, any other operator one row at a time
    (the port's kernel wrappers take one vector per launch)."""
    if _is_matrix(op):
        on = {}

        def blk(Z):
            mat = on.get(Z.device)
            if mat is None:
                mat = on[Z.device] = torch.as_tensor(op, device=Z.device)
            dt = torch.promote_types(mat.dtype, Z.dtype)
            return (Z.to(dt) @ mat.to(dt).T).to(dtype)

        return blk
    mv = cast_matvec(as_matvec(op), dtype)
    return lambda Z: torch.stack([mv(z) for z in Z])


def _operator_dtype(A):
    """A matrix's or an operator's ``dtype`` (None for bare callables)."""
    if isinstance(A, torch.Tensor):
        return A.dtype
    dt = getattr(A, "dtype", None)
    if dt is None:
        return None
    try:
        return torch_dtype(dt)
    except TypeError:
        return None


def _is_matrix(A):
    """A 2-D tensor or numpy array (the JAX package's ``hasattr(A,
    "ndim")``), as opposed to a matvec callable."""
    return isinstance(A, torch.Tensor) or (hasattr(A, "ndim")
                                          and not callable(A))


def _start_device(A, *given):
    """Where a solve's default start lives (module docstring)."""
    for t in given:
        if isinstance(t, torch.Tensor):
            return t.device
    mesh = active_mesh()
    if mesh is not None:
        return mesh.device
    if isinstance(A, torch.Tensor):
        return A.device
    if not _is_matrix(A):
        # a numpy array (numpy 2's ``ndarray.device`` is "cpu") goes to the
        # default device, as ``common.host_vectors`` sends a numpy ``b``
        dev = getattr(A, "device", None)
        if dev is not None:
            return torch.device(dev)
        diag = getattr(A, "diag", None)
        if isinstance(diag, torch.Tensor):
            return diag.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the start vector goes to 'cuda' (no v0=/X0= and no device on "
            "the operator), but torch sees no CUDA device; pass v0=/X0= "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _cos_start(N, device, a=0.7391, b=0.01):
    """The JAX package's deterministic start ``cos(idx * a) + b``, idx =
    0..N-1, in float64 (this rank's block of it under a mesh)."""
    idx = torch.arange(N, dtype=torch.float64, device=device)
    mesh = active_mesh()
    if mesh is not None:
        idx = idx[block_of(N, mesh)]
    return torch.cos(idx * a) + b


def _cos_block(N, p, device):
    """The deterministic ``(p, N)`` start block of lobpcg and
    eigsh_window: row ``i`` is ``cos(idx * (0.7391 + 0.1137 i)) + 0.01
    (i + 1)``."""
    return torch.stack([_cos_start(N, device, 0.7391 + 0.1137 * i,
                                   0.01 * (i + 1)) for i in range(p)])


def _default_float(dtype):
    """``dtype``, or the default float64 where it is neither floating nor
    complex."""
    if dtype is None or not (dtype.is_floating_point or dtype.is_complex):
        return torch.float64
    return dtype


def _real(dtype):
    return torch.empty(0, dtype=dtype).real.dtype


def _eps_floor(real_dtype, device):
    return torch.tensor(torch.finfo(real_dtype).tiny ** 0.5,
                        dtype=real_dtype, device=device)


def _opnorm(mv, N, dtype, device):
    """8-step power-iteration ``||.||_2`` estimate from the deterministic
    ``cos(idx * 0.3571) + 0.01`` start."""
    one = torch.ones((), dtype=_real(dtype), device=device)
    z = _cos_start(N, device, 0.3571).to(dtype)
    z = z * safe_div(one, _norm(z))
    for _ in range(8):
        w = mv(z)
        z = w * safe_div(one, _norm(w))
    return _norm(mv(z))


def _svqb_transform(G, eps, real_dtype, dtype, alive=None):
    """``(T, keep)`` of an SVQB pass on the Hermitian ``(j, j)`` Gram
    ``G``: diagonal scaling of the live rows (``alive``, default all),
    ``eigh`` of the scaled Gram, eigenvalues at or below ``j eps
    lambda_max`` dropped, and the row transform ``T = diag(lam^-1/2)
    S^T diag(scale)``."""
    j = G.shape[0]
    d = torch.clamp(torch.diagonal(G).real, min=0.0)
    if alive is None:
        scale = safe_div(torch.ones_like(d), torch.sqrt(d))
    else:
        a = alive.to(real_dtype)
        scale = safe_div(torch.ones_like(d), torch.sqrt(d * a)) * a
    Gh = G * (scale[:, None] * scale[None, :]).to(dtype)
    lam, S = torch.linalg.eigh(Gh)
    keep = lam > (j * eps) * torch.clamp(lam[-1], min=0.0)
    inv = torch.where(keep, safe_div(torch.ones_like(lam), torch.sqrt(
        torch.clamp(lam, min=0.0))), 0.0)
    T = inv[:, None].to(dtype) * S.T * scale[None, :].to(dtype)
    return T, keep


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------


def lanczos_cgs2_sweep(
    A_mv, V, H, j0, m, dtype, real_dtype, B_mv=None, W=None
):
    """Full-reorthogonalization Lanczos steps j0..m-1 (CGS2; both passes
    accumulated into H's column, so H stays V^H A V), in place on the
    row-major basis ``V`` and ``H``.  A round-off-sized residual
    (invariant subspace found) deflates to a ZERO row.  Shared by
    :func:`eigsh`, :mod:`~krypy_tpu_torch.functional.eigs` and
    :func:`~krypy_tpu_torch.functional.filtered.estimate_spectrum_bounds`.

    With ``B_mv``/``W`` (generalized eigenproblems) the sweep runs in
    the B-inner product: ``V`` is B-orthonormal, ``W = B V`` is the dual
    basis used for the projections, ``A_mv`` must apply the composite
    operator :math:`B^{-1} A`, and the return value is ``(V, W, H)``.
    Returns ``(V, H)`` otherwise.  Nothing is read back to the host.
    """
    brk = breakdown_threshold(dtype)
    generalized = B_mv is not None
    dual = W if generalized else V
    one = torch.ones((), dtype=real_dtype, device=V.device)
    for j in range(int(j0), int(m)):
        w = A_mv(V[j])
        for _ in range(2):
            c = _dots(dual[: j + 1], w)
            w = w - c @ V[: j + 1]
            H[: j + 1, j] += c
        if generalized:
            Bw = B_mv(w)
            beta = torch.sqrt(torch.clamp(
                mesh_sum(torch.vdot(w, Bw)).real, min=0.0))
        else:
            beta = _norm(w)
        alive = beta > brk * torch.linalg.vector_norm(H[: j + 1, j])
        live = alive.to(real_dtype)
        H[j + 1, j] = torch.where(alive, beta, 0.0).to(dtype)
        inv = safe_div(one, beta)
        V[j + 1] = live * w * inv
        if generalized:
            W[j + 1] = live * Bw * inv
    if generalized:
        return V, W, H
    return V, H


def lanczos_1r_sweep(A_mv, V, H, j0, m, dtype, real_dtype):
    """One-reduce lagged DCGS-2 sweep: steps ``j0..m-1`` at exactly ONE
    all-reduce per step, in place (the JAX package's
    ``lanczos_1r_sweep``, term for term).

    Row ``j`` is stored unnormalized; one fused contraction per step
    yields its reorthogonalization coefficients ``r = V^H u`` (the
    delayed second pass), its Pythagorean norm ``sigma^2 = <u,u> -
    ||r||^2``, and the first projection pass of ``w = A u``; the
    recorded column takes the lag correction ``g = H (r/sigma)``, so
    ``H`` stays ``V^H A V``.  A peeled first projection opens the sweep
    and a seal contraction (no matvec) closes it.  The algebra never
    assumes Hermitian ``H`` (:mod:`~krypy_tpu_torch.functional.eigs`
    uses it too).
    """
    brk = breakdown_threshold(dtype)
    one = torch.ones((), dtype=real_dtype, device=V.device)
    j0, m = int(j0), int(m)

    w0 = A_mv(V[j0])
    c0 = _dots(V[: j0 + 1], w0)
    H[: j0 + 1, j0] += c0
    V[j0 + 1] = w0 - c0 @ V[: j0 + 1]

    for j in range(j0 + 1, m):
        u = V[j].clone()
        w = A_mv(u)
        # THE one fused reduction of the step
        Z = mesh_sum(V[: j + 1].conj() @ torch.stack([u, w], dim=1))
        r, s = Z[:j, 0], Z[j, 0].real
        c, t = Z[:j, 1], Z[j, 1]
        sig2 = torch.clamp(s - torch.sum(torch.abs(r) ** 2), min=0.0)
        sigma = torch.sqrt(sig2).to(real_dtype)

        # complete column j-1: delayed reorthogonalization + subdiagonal
        H[:j, j - 1] += r
        alive = sigma > brk * torch.linalg.vector_norm(H[:, j - 1])
        live = alive.to(real_dtype)
        H[j, j - 1] = torch.where(alive, sigma, 0.0).to(dtype)
        inv_s = live * safe_div(one, sigma)
        V[j] = (u - r @ V[:j]) * inv_s

        # first-pass column j with the lag correction g = H (r/sigma)
        rt = r * inv_s
        g = H[:, :j] @ rt
        tk = (t - torch.vdot(r, c)) * inv_s * inv_s
        chat = torch.cat([c * inv_s, tk.reshape(1)])
        V[j + 1] = w * inv_s - chat @ V[: j + 1]
        upd = -g
        upd[: j + 1] += chat
        H[:, j] += upd

    # seal the final candidate (one reduce, no matvec)
    u = V[m].clone()
    Zs = _dots(V[: m + 1], u)
    r, s = Zs[:m], Zs[m].real
    sig2 = torch.clamp(s - torch.sum(torch.abs(r) ** 2), min=0.0)
    sigma = torch.sqrt(sig2).to(real_dtype)
    H[:m, m - 1] += r
    alive = sigma > brk * torch.linalg.vector_norm(H[:, m - 1])
    live = alive.to(real_dtype)
    H[m, m - 1] = torch.where(alive, sigma, 0.0).to(dtype)
    V[m] = (u - r @ V[:m]) * live * safe_div(one, sigma)
    return V, H


def spurious_ritz_mask(V_rows, S):
    """Eigenpairs of the projected matrix living in the DEAD block left
    by sweep deflation: an eigenvector whose mass sits on rows whose
    basis vector vanished (over the whole vector, on a mesh) is
    spurious."""
    live_row = mesh_sum(torch.sum(torch.abs(V_rows) ** 2, dim=1)) > 0
    dead_mass = torch.sum(
        torch.abs(S) ** 2 * (~live_row)[:, None].to(S.real.dtype), dim=0)
    return dead_mass > 0.5


def _selection_key(theta, which):
    if which == "sa":
        return theta
    if which == "la":
        return -theta
    if which == "lm":
        return -torch.abs(theta)
    if which == "sm":
        return torch.abs(theta)
    raise ValueError(f"unknown which={which!r}")


def _hermitian_eigh(G):
    """``eigh`` of the Hermitian part of a small matrix, on its
    device."""
    return torch.linalg.eigh(0.5 * (G + G.conj().T))


# ---------------------------------------------------------------------------
# eigsh
# ---------------------------------------------------------------------------


def eigsh(
    A,
    k=6,
    *,
    v0=None,
    n=None,
    which="sa",
    maxdim=None,
    thick=None,
    tol=1e-8,
    max_restarts=200,
    sigma=None,
    inv=None,
    B=None,
    Binv=None,
    block_size=1,
    ortho="cgs2",
):
    r"""k extremal eigenpairs of Hermitian ``A`` by thick-restart Lanczos.

    :param A: Hermitian operator (matvec callable, 2-D tensor or numpy
      array).
    :param k: number of wanted pairs.
    :param v0: starting vector; defaults to the deterministic
      quasi-random ``cos(idx * 0.7391) + 0.01`` (module docstring for
      its device).
    :param n: problem size when ``A`` has no ``.shape`` and no ``v0``.
    :param which: ``'sa'`` (default), ``'la'``, ``'lm'`` or ``'sm'``.
    :param maxdim: Krylov dimension m per cycle (default
      ``min(N, max(2k + 8, 24))``).
    :param thick: Ritz pairs kept at each restart (default
      ``min(2k, maxdim - 2)``).
    :param tol: per-pair convergence test
      :math:`|\beta_m s_{m,i}| \le \mathrm{tol}\cdot\max(|\theta_i|,
      \epsilon)` for all k wanted pairs.
    :param sigma: shift-invert target: the k eigenvalues NEAREST
      ``sigma``, by Lanczos on :math:`(A - \sigma I)^{-1}`; requires
      ``inv``.  ``which`` is then ignored and the pairs are verified
      against ``A`` by the backward error
      :math:`\|A u - \lambda u\| / (\|A\|\,\|u\|)` (``||A||`` by an
      8-step power iteration).
    :param inv: matvec applying :math:`(A - \sigma I)^{-1}` (or
      :math:`(A - \sigma B)^{-1}` with ``B=``); its solves must be
      accurate well below ``tol``.
    :param B,Binv: generalized problem :math:`A x = \lambda B x`, SPD
      ``B``: Lanczos in the B-inner product on :math:`B^{-1} A`; the
      pairs are verified against the pencil.  With ``sigma`` Lanczos
      runs on :math:`(A - \sigma B)^{-1} B` and ``Binv`` is optional.
    :param block_size: Lanczos vectors advanced per step (block
      thick-restart Lanczos); a block at least as wide as an eigenvalue's
      multiplicity captures its whole eigenspace.  Not with ``B``.
    :param ortho: ``"cgs2"`` (default: 3 all-reduces per step on a mesh)
      or ``"cgs2_1r"`` (:func:`lanczos_1r_sweep`: one); ``"cgs2_1r"``
      requires ``block_size=1`` and no ``B=``.
    :return: :class:`EigshResult`.
    """
    A_mv = as_matvec(A)
    shift_invert = sigma is not None
    generalized = B is not None or Binv is not None
    if generalized:
        if B is None or (Binv is None and not shift_invert):
            raise ValueError(
                "generalized mode needs BOTH B= and Binv= (Binv is "
                "unused -- optional -- under sigma= shift-invert)")
        B_mv = as_matvec(B)
        pencil_A_mv = A_mv
        if not shift_invert:
            Binv_mv = as_matvec(Binv)
            A_mv = lambda v: Binv_mv(pencil_A_mv(v))  # noqa: E731
    if shift_invert:
        if inv is None:
            raise ValueError(
                "sigma= (shift-invert) requires inv=, a matvec applying "
                "(A - sigma I)^{-1} (or (A - sigma B)^{-1} with B=)")
        orig_A_mv = A_mv
        inv_mv = as_matvec(inv)
        if generalized:
            A_mv = lambda v: inv_mv(B_mv(v))  # noqa: E731
        else:
            A_mv = inv_mv
        which = "lm"  # largest of the inverted spectrum = nearest sigma
    _selection_key(torch.zeros(1), which)  # validate early
    if v0 is not None:
        v0 = asarray(v0, device=_start_device(A)).reshape(-1)
        N = global_length(v0)
        dev = v0.device
    else:
        if n is None:
            shape = getattr(A, "shape", None)
            if shape is None:
                raise ValueError("n= or v0= required when A has no .shape")
            n = shape[0]
        N = int(n)
        dev = _start_device(A)
        v0 = _cos_start(N, dev)
        # the operator's dtype must win over the (real) default start
        op_dt = _operator_dtype(A)
        if op_dt is not None and op_dt.is_complex:
            v0 = v0.to(op_dt)

    dtype = _default_float(system_dtype(v0))
    v0 = v0.to(dtype)
    A_mv = cast_matvec(A_mv, dtype)
    if shift_invert:
        orig_A_mv = cast_matvec(orig_A_mv, dtype)
    if generalized:
        B_mv = cast_matvec(B_mv, dtype)
        pencil_A_mv = cast_matvec(pencil_A_mv, dtype)
    else:
        B_mv = None
    real_dtype = _real(dtype)
    one = torch.ones((), dtype=real_dtype, device=dev)

    k = int(k)
    bs = int(block_size)
    if bs < 1:
        raise ValueError(f"block_size must be >= 1, got {bs}")
    if bs > 1 and generalized:
        raise ValueError(
            "block_size > 1 is not supported with generalized pencils; "
            "for clustered/degenerate generalized problems use "
            "functional.lobpcg(A, k, B=...), whose block width covers "
            "clusters natively (and needs no Binv)")

    m = (min(N, max(2 * k + 8, 24)) if maxdim is None
         else min(int(maxdim), N))
    if bs > 1:
        m = max((m // bs) * bs, 2 * bs)
    if k >= m - 1:
        raise ValueError(f"k={k} needs maxdim > k + 1 (have {m})")
    l = min(2 * k, m - 2) if thick is None else min(int(thick), m - 2)
    l = max(l, k)
    if bs > 1:
        l = min(-(-l // bs) * bs, m - bs)

    eps_floor = _eps_floor(real_dtype, dev)
    brk = breakdown_threshold(dtype)
    Nl = v0.shape[0]
    if bs > 1:
        A_blk = _block_matvec(inv if shift_invert else A, dtype)

    def block_cgs2_sweep(V, H, j0):
        """Block Lanczos steps j0, j0+bs, ..., m-bs: one global CGS2
        projection of the bs-wide block per step, then a two-pass
        intra-block MGS whose round-off rows deflate to ZERO rows."""
        for j in range(j0, m, bs):
            Wblk = A_blk(V[j:j + bs])
            Cacc = torch.zeros((j + bs, bs), dtype=dtype, device=dev)
            for _ in range(2):
                C = mesh_sum(V[: j + bs].conj() @ Wblk.T)
                Wblk = Wblk - C.T @ V[: j + bs]
                Cacc = Cacc + C
            H[: j + bs, j:j + bs] += Cacc

            qs = []
            Rblk = torch.zeros((bs, bs), dtype=dtype, device=dev)
            for i in range(bs):
                w = Wblk[i]
                for _ in range(2):
                    for p in range(i):
                        c = mesh_sum(torch.vdot(qs[p], w))
                        w = w - c * qs[p]
                        Rblk[p, i] += c
                nrm = _norm(w)
                scale = torch.sqrt(torch.sum(torch.abs(Cacc[:, i]) ** 2)
                                   + torch.sum(torch.abs(Rblk[:i, i]) ** 2))
                alive = nrm > brk * scale
                Rblk[i, i] = torch.where(alive, nrm, 0.0).to(dtype)
                qs.append(alive.to(real_dtype) * w * safe_div(one, nrm))
            V[j + bs:j + 2 * bs] = torch.stack(qs)
            H[j + bs:j + 2 * bs, j:j + bs] += Rblk
        return V, H

    if ortho not in ("cgs2", "cgs2_1r"):
        raise ValueError(f"unknown eigsh ortho {ortho!r}")
    if ortho == "cgs2_1r" and (bs > 1 or generalized):
        raise ValueError(
            "ortho='cgs2_1r' supports the standard single-vector sweep "
            "only (block_size=1, no B=); the block/generalized sweeps "
            "stay on classic cgs2")

    def lanczos_sweep(V, W, H, j0):
        if generalized:
            return lanczos_cgs2_sweep(A_mv, V, H, j0, m, dtype, real_dtype,
                                      B_mv=B_mv, W=W)
        if bs > 1:
            V, H = block_cgs2_sweep(V, H, j0)
        elif ortho == "cgs2_1r":
            V, H = lanczos_1r_sweep(A_mv, V, H, j0, m, dtype, real_dtype)
        else:
            V, H = lanczos_cgs2_sweep(A_mv, V, H, j0, m, dtype, real_dtype)
        return V, W, H

    def ritz(V, H):
        """Device eigh of the Hermitian projection + selection; pairs of
        the dead (deflated) block sort last."""
        theta, S = _hermitian_eigh(H[:m, :m])
        spurious = spurious_ritz_mask(V[:m], S)
        key = torch.where(spurious, torch.inf, _selection_key(theta, which))
        order = torch.argsort(key, stable=True)
        return theta[order], S[:, order], spurious[order]

    def cycle_stats(H, theta, S, spurious):
        # border block of A V_m = V_m H_m + Q Bord: per-pair residual
        # ||Bord S[:, i]||
        BS = H[m:m + bs, :m] @ S
        res = torch.sqrt(torch.sum(torch.abs(BS[:, :k]) ** 2, dim=0))
        res = res / torch.maximum(torch.abs(theta[:k]), eps_floor)
        res = torch.where(spurious[:k], torch.inf, res)
        return BS, res, torch.max(res)

    V = torch.zeros((m + bs, Nl), dtype=dtype, device=dev)
    if generalized:
        Bv0 = B_mv(v0)
        beta0 = torch.sqrt(torch.clamp(
            mesh_sum(torch.vdot(v0, Bv0)).real, min=0.0))
        W = torch.zeros((m + bs, Nl), dtype=dtype, device=dev)
        W[0] = Bv0 * safe_div(one, beta0)
    else:
        beta0 = _norm(v0)
        W = None
    V[0] = v0 * safe_div(one, beta0)
    if bs > 1:
        # the starting block: orthonormalized deterministic directions
        for i in range(1, bs):
            u = _cos_start(N, dev, 0.7391 + 0.1137 * i,
                           0.01 * (i + 1)).to(dtype)
            for _ in range(2):
                c = _dots(V[:i], u)
                u = u - c @ V[:i]
            V[i] = u * safe_div(one, _norm(u))
    H = torch.zeros((m + bs, m + bs), dtype=dtype, device=dev)
    V, W, H = lanczos_sweep(V, W, H, 0)

    resnorms = torch.full((max_restarts + 1,), float("nan"),
                          dtype=real_dtype, device=dev)
    tol_t = torch.tensor(tol, dtype=real_dtype, device=dev)
    cycles, niter, conv = 0, m, False
    while not conv and cycles < max_restarts:
        theta, S, spurious = ritz(V, H)
        b, _, wres = cycle_stats(H, theta, S, spurious)
        resnorms[cycles] = wres
        conv = bool(wres <= tol_t)  # the cycle's one host read
        if not conv:
            Sl = S[:, :l]
            Vn = torch.zeros_like(V)
            Vn[:l] = Sl.T @ V[:m]
            Vn[l:l + bs] = V[m:m + bs]                # residual block
            if generalized:
                # the dual basis transforms linearly: B Y = Sl^T (B V)
                Wn = torch.zeros_like(W)
                Wn[:l] = Sl.T @ W[:m]
                Wn[l:l + bs] = W[m:m + bs]
            else:
                Wn = None
            # arrowhead: diag(theta_l) + border rows only (the first
            # sweep step recomputes the column border itself)
            Hn = torch.zeros_like(H)
            Hn[:l, :l] = torch.diag(theta[:l].to(dtype))
            Hn[l:l + bs, :l] = b[:, :l].to(dtype)
            del V, W, H
            V, W, H = lanczos_sweep(Vn, Wn, Hn, l)
            niter += m - l
        cycles += 1

    # final extraction (also records the last cycle's residual when the
    # loop exited on max_restarts)
    theta, S, spurious = ritz(V, H)
    _, pair_res, wres = cycle_stats(H, theta, S, spurious)
    U = (S[:, :k].T @ V[:m]).T                        # (N, k)
    theta_k = theta[:k]

    sig = None if sigma is None else torch.tensor(
        sigma, dtype=real_dtype, device=dev)
    if generalized and shift_invert:
        # back-transform lambda = sigma + 1/nu; backward error against
        # the pencil, ||A u - lam B u|| / ((||A|| + |lam| ||B||) ||u||)
        lam = sig + 1.0 / theta_k
        AU = torch.stack([pencil_A_mv(U[:, i]) for i in range(k)], dim=1)
        BU = torch.stack([B_mv(U[:, i]) for i in range(k)], dim=1)
        anorm = _opnorm(pencil_A_mv, N, dtype, dev)
        bnorm = _opnorm(B_mv, N, dtype, dev)
        res = _row_norms((AU - BU * lam[None, :].to(dtype)).T) / \
            torch.maximum((anorm + torch.abs(lam) * bnorm) * _row_norms(U.T),
                          eps_floor)
        pair_res, wres, theta_k = res, torch.max(res), lam
    elif generalized:
        # verify against the pencil: ||A u - theta B u|| / (|theta| ||B u||)
        AU = torch.stack([pencil_A_mv(U[:, i]) for i in range(k)], dim=1)
        BU = torch.stack([B_mv(U[:, i]) for i in range(k)], dim=1)
        res = _row_norms((AU - theta_k.to(dtype)[None, :] * BU).T) / \
            torch.maximum(torch.abs(theta_k) * _row_norms(BU.T), eps_floor)
        pair_res, wres = res, torch.max(res)
    elif shift_invert:
        # back-transform and verify against A itself by the backward
        # error ||A u - lam u|| / (||A|| ||u||)
        lam = sig + 1.0 / theta_k
        AU = torch.stack([orig_A_mv(U[:, i]) for i in range(k)], dim=1)
        anorm = _opnorm(orig_A_mv, N, dtype, dev)
        res = _row_norms((AU - U * lam[None, :].to(dtype)).T) / \
            torch.maximum(anorm * _row_norms(U.T), eps_floor)
        pair_res, wres, theta_k = res, torch.max(res), lam
    resnorms[min(cycles, max_restarts)] = wres
    status = torch.where(wres <= tol_t, CONVERGED, MAXITER).to(torch.int64)
    return EigshResult(
        theta=theta_k,
        U=U,
        resnorms=resnorms,
        niter=torch.tensor(niter, dtype=torch.int64, device=dev),
        status=status,
        pair_resnorms=pair_res,
    )
