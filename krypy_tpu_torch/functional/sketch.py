r"""Randomized sketching lane: sketched GMRES and sketched Rayleigh-Ritz
(counterpart of :mod:`krypy_tpu.functional.sketch`; Nakatsukasa & Tropp,
SIMAX 2024).

sGMRES builds a basis that is only *locally* orthogonalized (a
``k_ortho``-row truncated Arnoldi window: ``O(k N)`` traffic per
iteration), pushes each new column through a random subspace embedding
``S`` with ``d = O(m)`` rows, and minimizes the *sketched* residual
``||S r0 - S(A Z) y||``, a small ``d x m`` least-squares problem solved by
an incremental Householder QR.  The loop stops on the sketched residual;
the status is decided by the explicit TRUE residual of the assembled
iterate (the best of three least-squares solves), and ``distortion``,
the true over the sketched residual at exit, certifies the embedding.

The sketch is the JAX package's Kronecker-factored Gaussian map with a
Rademacher pre-mask, :class:`KronSketch`: ``x`` is sign-masked,
zero-padded to ``n1 n2`` and reshaped to ``(n1, n2)``; the embedding is
``S1 X S2^T``.  The port draws it from a ``torch.Generator``: ``seed`` is
an int, or a generator whose device the sketch is drawn on.  A sketch
drawn for a solve lives on the right-hand side's device; one drawn by
:func:`kron_sketch` with an int seed goes to ``"cuda"`` (raises where
torch sees no card).  The JAX package's draws cannot be reproduced by
torch; :func:`krypy_tpu_torch.interop.kron_sketch_from_numpy` carries
one across.

The JAX package runs the iteration as one ``lax.while_loop``.  Here it is
a host loop: each iteration's sketched column (``d`` numbers) is read to
the host, where the Householder update runs in the system's dtype on CPU
tensors (``j`` sequential reflections of a ``d``-vector would otherwise
be ``3 j`` launches per iteration on the card); the basis, the operator
and the sketch application stay on the device.  The three candidate
solves of the assembly run on the host too; their iterates and true
residuals on the device.

Under an active mesh the vectors are the ranks' blocks.  The sketch is
global (every rank draws the same bits): a rank's block of the masked,
padded vector covers a band of rows of the ``(n1, n2)`` reshape, partial
at both ends, and the rank computes ``S1[:, band] X_band S2^T`` and
all-reduces the ``d``-vector, once per sketch application.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..parallel import active_mesh, block_of
from .common import (
    CONVERGED,
    MAXITER,
    apply,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    global_length,
    host_vectors,
    mesh_sum,
    safe_div,
    system_dtype,
)
from .eigh import (
    _cos_start,
    _default_float,
    _is_matrix,
    _norm,
    _operator_dtype,
    _start_device,
)
from .randomized import _generator as _seeded

__all__ = [
    "KronSketch",
    "SketchedSolveResult",
    "kron_sketch",
    "sketch_apply",
    "sketched_gmres",
    "restarted_sketched_gmres",
    "sketched_eigs",
]


class SketchedSolveResult(NamedTuple):
    """Result of a sketched solve: the fields of
    :class:`~krypy_tpu_torch.functional.common.SolveResult` plus the
    embedding-quality certificate ``distortion``, the true over the
    sketched relative residual at exit (near 1 on a healthy embedding;
    well above 1: the sketch under-estimated the residual on this
    operator's subspace, and :func:`restarted_sketched_gmres` escalates),
    and the live embedding dimension ``sketch_d``."""

    #: approximate solution, shape ``(N,)``
    x: torch.Tensor
    #: sketched per-iteration estimates; final entry = true residual
    resnorms: torch.Tensor
    #: number of iterations performed
    niter: torch.Tensor
    #: CONVERGED / MAXITER
    status: torch.Tensor
    #: posterior embedding certificate
    distortion: torch.Tensor = 1.0
    #: realized (live) embedding dimension d of the sketch used
    sketch_d: int = 0

    @property
    def converged(self):
        return bool(self.status == CONVERGED)


class KronSketch(NamedTuple):
    """Kronecker-factored Gaussian sketch ``x -> (S1 (x) S2) (signs *
    x)_pad`` (the global ``1/sqrt(d)`` folded into ``S1``).

    The Rademacher pre-mask is load-bearing: a vector smooth on the
    ``(n1, n2)`` grid is near-rank-1 as a matrix, and the raw Kronecker
    map keeps its rank, collapsing the embedding on exactly the subspaces
    a PDE solve produces."""

    S1: torch.Tensor     # (d1, n1)
    S2: torch.Tensor     # (d2, n2)
    signs: torch.Tensor  # (N,) Rademacher pre-mask
    N: int

    @property
    def d(self):
        return self.S1.shape[0] * self.S2.shape[0]


def _split_even(n):
    """n1 >= n2 with n1 * n2 >= n, both near sqrt(n)."""
    n2 = max(1, int(math.isqrt(n)))
    n1 = -(-n // n2)
    return n1, n2


def _generator(seed, device):
    """``seed`` itself where it is a ``torch.Generator``, else a generator
    on ``device`` seeded by it (``device`` None: ``"cuda"``, which raises
    where torch sees no card)."""
    if device is None and not isinstance(seed, torch.Generator):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the sketch goes to 'cuda' (an int seed and no operand to "
                "follow), but torch sees no CUDA device; pass a "
                "torch.Generator on the CPU as seed=")
        device = torch.device("cuda", torch.cuda.current_device())
    return _seeded(seed, device)


def _draw(N, d_rows, d2_of, d_active, seed, dtype, device):
    """The factors of a sketch of R^N: ``S1`` ``(d1, n1)`` with its rows
    past ``d_active`` (in units of ``d2`` coordinates) zero and the scale
    ``1/sqrt(live rows * d2)`` folded in, ``S2`` ``(d2, n2)``, ``signs``."""
    gen = _generator(seed, device)
    d1, d2 = d_rows, d2_of
    n1, n2 = _split_even(int(N))
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    dev = gen.device
    rows = max(1, min(d1, -(-int(d_active) // d2)))
    S1 = torch.randn((d1, n1), generator=gen, dtype=real_dtype, device=dev)
    S1 *= 1.0 / math.sqrt(rows * d2)
    S1[rows:] = 0.0
    S2 = torch.randn((d2, n2), generator=gen, dtype=real_dtype, device=dev)
    signs = torch.randint(0, 2, (int(N),), generator=gen, device=dev)
    signs = (2 * signs - 1).to(real_dtype)
    return KronSketch(S1=S1, S2=S2, signs=signs, N=int(N))


def kron_sketch(N, d, *, seed=0, dtype=torch.float32):
    """Draw a :class:`KronSketch` embedding R^N -> R^(>=d) (the factor
    dimensions are the integer splits nearest sqrt, so the realized
    ``d1 * d2`` may slightly exceed ``d``).  ``seed``: an int (the sketch
    goes to ``"cuda"``) or a ``torch.Generator`` (its device)."""
    d1, d2 = _split_even(int(d))
    return _draw(N, d1, d2, d1 * d2, seed, dtype, None)


def padded_kron_sketch(N, d_active, d_max, *, seed=0, dtype=torch.float32):
    """A :class:`KronSketch` whose buffers are sized for ``d_max`` but
    whose live embedding has ~``d_active`` rows: the rest of ``S1`` is
    exactly zero, and the scale folded into ``S1`` is the ACTIVE row
    count's (an isometry in expectation at every level).  The restart
    driver escalates through these (the JAX package's single compiled
    program; the port keeps the shapes so the levels are one family)."""
    d1, d2 = _split_even(int(d_max))
    return _draw(N, d1, d2, d_active, seed, dtype, None)


def sketch_apply(S, x):
    """Apply the sketch to a vector: one sweep of ``x`` and two small
    products; on a mesh the rank's band of the reshape and one
    all-reduce of the ``d``-vector."""
    n1, n2 = S.S1.shape[1], S.S2.shape[1]
    xv = x.reshape(-1)
    mesh = active_mesh()
    if mesh is None:
        lo, signs = 0, S.signs
    else:
        blk = block_of(S.N, mesh)
        lo, signs = blk.start, S.signs[blk]
    hi = lo + xv.shape[0]
    xv = xv * signs.to(x.dtype)
    # the rows of the (n1, n2) reshape that [lo, hi) touches, zero-filled
    # outside it (the padding past N is zero too)
    r0 = lo // n2
    r1 = max(r0 + 1, -(-hi // n2))
    band = torch.zeros((r1 - r0) * n2, dtype=x.dtype, device=x.device)
    band[lo - r0 * n2:hi - r0 * n2] = xv
    X = band.reshape(r1 - r0, n2)
    S1 = S.S1[:, r0:r1].to(x.dtype)
    out = (S1 @ X @ S.S2.T.to(x.dtype)).reshape(-1)
    return out if mesh is None else mesh_sum(out)


def _house_vector(c, j, d):
    """Unit Householder vector zeroing ``c`` strictly below position j:
    ``(v, alpha)`` with ``(I - 2 v v^H) c = [c[:j], alpha, 0...]``,
    ``|alpha| = ||c[j:]||`` (complex-safe: the pivot keeps its phase)."""
    idx = torch.arange(d)
    tail = torch.where(idx >= j, c, 0)
    na = torch.linalg.vector_norm(tail)
    c_j = c[j]
    absj = torch.abs(c_j)
    phase = c_j / absj if absj > 0 else torch.ones((), dtype=c.dtype)
    alpha = -phase * na
    v = tail - alpha * (idx == j).to(c.dtype)
    nv = torch.linalg.vector_norm(v)
    if nv > 0:
        v = v / nv
    return v, alpha


def sketched_gmres(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=40,
    k_ortho=2,
    sketch_dim=None,
    seed=0,
    sketch=None,
    stagnation_window=0,
    sketch_safety=0.25,
):
    r"""Solve ``A x = b`` by sketched GMRES.

    Per iteration: one matvec (+ one preconditioner application), a
    ``k_ortho``-row orthogonalization window, one sketch application and
    an ``O(j d)`` update of the small QR.

    :param M: optional RIGHT preconditioner; the minimized residual is the
      true residual of the original system.
    :param k_ortho: truncated-Arnoldi window (2-4 typical).
    :param sketch_dim: embedding dimension ``d`` (default ``8
      (maxiter+1)``; must exceed ``maxiter``).
    :param seed: int or ``torch.Generator`` of the sketch drawn here (on
      ``b``'s device).
    :param sketch: a prebuilt :class:`KronSketch` (shared across solves).
    :param sketch_safety: the loop stops when the *sketched* relative
      residual falls below ``sketch_safety * tol`` (the margin absorbs the
      minimization bias of sketch-and-solve); the status is CONVERGED
      only if the explicit true residual meets ``tol``.
    :return: :class:`SketchedSolveResult`; ``resnorms[i]`` is the
      sketched estimate after ``i`` iterations, the final entry the true
      relative residual.
    """
    b, x0 = host_vectors(b, x0)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    dev = bv.device
    maxiter = int(maxiter)
    k_ortho = max(1, int(k_ortho))

    dtype = system_dtype(bv, x0)
    bv = bv.to(dtype)
    A_mv, M_mv = (cast_matvec(as_matvec(f), dtype) for f in (A, M))
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    host = torch.device("cpu")

    if sketch is None:
        sketch_dim = 8 * (maxiter + 1) if sketch_dim is None \
            else int(sketch_dim)
        d1, d2 = _split_even(sketch_dim)
        sketch = _draw(global_length(bv), d1, d2, d1 * d2,
                       _generator(seed, dev), real_dtype, dev)
    d = sketch.d
    if d <= maxiter:
        raise ValueError(
            f"sketch_dim (realized {d}) must exceed maxiter={maxiter}: the "
            "sketched LS problem needs more rows than columns")

    def sk(v):
        return sketch_apply(sketch, v).to(dtype)

    x0v = (torch.zeros(N, dtype=dtype, device=dev) if x0 is None
           else x0.reshape(-1).to(dtype))
    bnorm = _norm(bv)
    r0 = bv - A_mv(x0v)
    r0norm = _norm(r0)
    rel0_t = safe_div(r0norm, bnorm)
    sr0 = sk(r0).to(host)
    sbnorm = torch.linalg.vector_norm(sk(bv).to(host))
    rel0 = np_real(rel0_t.item())

    tiny = breakdown_threshold(dtype)
    idx_d = torch.arange(d)
    Bas = torch.zeros((maxiter + 1, N), dtype=dtype, device=dev)
    Bas[0] = torch.where(r0norm > 0, r0 / torch.where(r0norm > 0, r0norm,
                                                      1.0), r0)
    SW = torch.zeros((maxiter, d), dtype=dtype)
    Vh = torch.zeros((maxiter, d), dtype=dtype)
    R = torch.zeros((maxiter, maxiter), dtype=dtype)
    t = sr0.clone()
    resnorms = torch.full((maxiter + 1,), float("nan"), dtype=real_dtype)
    resnorms[0] = float(rel0)
    cur_rel = best = rel0
    stall, exhausted, j = 0, False, 0
    stop_at = np_real(sketch_safety * tol)

    def going():
        go = cur_rel > stop_at and j < maxiter and not exhausted
        if stagnation_window > 0:
            go = go and stall < stagnation_window
        return go

    while going():
        # extend: w = A M b_j, sketched BEFORE the local orthogonalization
        w = A_mv(apply(M_mv, Bas[j]))
        start = max(j - (k_ortho - 1), 0)
        W = Bas[start:start + k_ortho]
        h = mesh_sum(W.conj() @ w)
        u = w - h @ W
        nu, wnorm = _norm(u), _norm(w)
        Bas[j + 1] = torch.where(nu <= tiny * wnorm, 0.0,
                                 u / torch.where(nu > 0, nu, 1.0))
        # the one read of the iteration: the sketched column and the
        # window's two norms
        got = torch.cat([sk(w), torch.stack([nu, wnorm]).to(dtype)]).to(
            host)
        sw, nu_h, wnorm_h = got[:d], got[d].real, got[d + 1].real

        # incremental Householder QR of the sketched column
        c = sw
        for i in range(j):
            c = c - Vh[i] * (2.0 * torch.vdot(Vh[i], c))
        v, alpha = _house_vector(c, j, d)
        # a sketched column dependent on the previous ones: the basis
        # stopped producing new directions (the assembly drops it)
        dependent = bool(torch.abs(alpha) <= tiny *
                         torch.linalg.vector_norm(sw))
        rcol = torch.where(idx_d < j, c, 0)
        rcol[j] = alpha
        R[:, j] = rcol[:maxiter]
        Vh[j] = v
        t = t - v * (2.0 * torch.vdot(v, t))
        srel = np_real(safe_div(
            torch.linalg.vector_norm(torch.where(idx_d > j, t, 0)),
            sbnorm).item())

        stall = 0 if srel < np_real(0.99) * best else stall + 1
        best = min(srel, best)
        resnorms[j + 1] = float(srel)
        SW[j] = sw
        cur_rel = srel
        exhausted = bool(nu_h <= tiny * wnorm_h) or dependent or \
            not np.isfinite(srel)
        j += 1

    # assemble by the best of three sketched-LS solves, chosen by the
    # EXPLICIT true residual: the exact LS solution from the loop's QR,
    # and two spectrally truncated normal-equations solves (a raw
    # triangular solve through a near-dependent basis amplifies y at
    # reduced precision; a uniformly truncated one drops a healthy
    # basis's fine corrections)
    jf = j
    col = torch.arange(maxiter)
    active = col < jf
    SWm = torch.where(active[:, None], SW, 0)
    eps = torch.finfo(real_dtype).eps

    diag = torch.diagonal(R)
    ok_diag = torch.abs(diag) > tiny * torch.max(
        torch.cat([torch.abs(diag), torch.ones(1, dtype=real_dtype)]))
    act_qr = active & ok_diag
    Rm = torch.where(act_qr[None, :] & act_qr[:, None], R, 0)
    Rm = Rm + torch.diag(torch.where(act_qr, 0.0, 1.0).to(dtype))
    tm = torch.where(act_qr, t[:maxiter], 0)
    y_qr = torch.linalg.solve_triangular(Rm, tm[:, None], upper=True)[:, 0]
    y_qr = torch.where(act_qr, y_qr, 0)

    G = (SWm @ SWm.conj().T).conj()
    g = SWm.conj() @ sr0
    wg, Vg = torch.linalg.eigh(G)
    wmax = torch.clamp(wg[-1], min=torch.finfo(real_dtype).tiny)
    cvec = Vg.conj().T @ g

    def truncated(rcond):
        keep = wg > (rcond * rcond) * wmax
        inv_w = torch.where(keep, 1.0 / torch.where(keep, wg, 1.0), 0.0)
        return Vg @ (inv_w.to(dtype) * cvec)

    # the x0 fallback guards reduced-precision overruns past the
    # attainable floor: never return an iterate worse than x0
    x, true_rel = x0v, rel0_t
    for y in (y_qr, truncated(float(eps) ** 0.5),
              truncated(float(eps) ** 0.25)):
        y = torch.where(active, y, 0).to(dev)
        xc = x0v + apply(M_mv, y @ Bas[:maxiter])
        relc = safe_div(_norm(bv - A_mv(xc)), bnorm)
        better = relc < true_rel
        x = torch.where(better, xc, x)
        true_rel = torch.where(better, relc, true_rel)

    true_rel = true_rel.to(real_dtype)
    resnorms[jf] = true_rel.to(host)
    status = CONVERGED if np_real(true_rel.item()) <= np_real(tol) \
        else MAXITER
    # the posterior certificate, 1 at zero iterations
    sk_rel = max(cur_rel, np_real(tiny))
    distortion = (true_rel / float(sk_rel) if jf > 0
                  else torch.ones((), dtype=real_dtype, device=dev))
    live_rows = int(torch.sum(torch.any(sketch.S1 != 0, dim=1)))
    return SketchedSolveResult(
        x=x if flat else x[:, None],
        resnorms=resnorms.to(dev),
        niter=torch.tensor(jf, device=dev),
        status=torch.tensor(status, device=dev),
        distortion=distortion.to(real_dtype),
        sketch_d=live_rows * sketch.S2.shape[0],
    )


def restarted_sketched_gmres(
    A,
    b,
    *,
    max_restarts=0,
    maxiter=40,
    tol=1e-5,
    seed=0,
    sketch=None,
    distortion_limit=4.0,
    max_escalations=2,
    classic_fallback=True,
    **kwargs,
):
    """Restarted sketched GMRES: cycles of :func:`sketched_gmres` from the
    last iterate, sharing ONE embedding.

    Embedding quality is policed at each restart seam: when a cycle's
    ``distortion`` exceeds ``distortion_limit`` and the cycle did not
    converge, the sketch is redrawn with DOUBLE the live embedding
    dimension and the seed ``seed + 7919 * escalations`` (up to
    ``max_escalations`` times; without an explicit ``sketch`` every level
    is a :func:`padded_kron_sketch` of the same shapes); past the last
    escalation, with ``classic_fallback``, the remaining iteration budget
    runs as classic GMRES with ``M`` as its RIGHT preconditioner.  Pass
    ``distortion_limit=float('inf')`` to never escalate.  ``resnorms``
    stitches every cycle's estimates at the explicit cycle boundaries.
    """
    from .gmres import gmres as _classic_gmres

    (b,) = host_vectors(b)
    bv = b.reshape(-1)
    dev = bv.device
    x = kwargs.pop("x0", None)
    real_dtype = torch.empty(0, dtype=system_dtype(bv)).real.dtype
    N = global_length(bv)

    def draw(make, *args, seed_l):
        # module-level lookup: a caller may substitute the draws
        return make(N, *args, seed=torch.Generator(device=dev).manual_seed(
            int(seed_l)), dtype=real_dtype)

    if sketch is None:
        sd = kwargs.pop("sketch_dim", None)
        sd = 8 * (int(maxiter) + 1) if sd is None else int(sd)
        if sd <= int(maxiter):
            raise ValueError(f"sketch_dim={sd} must exceed maxiter={maxiter}")
        d_max = sd * (2 ** max(0, int(max_escalations)))

        def level_sketch(level, seed_l):
            return draw(padded_kron_sketch, sd * (2 ** level), d_max,
                        seed_l=seed_l)

        sketch = level_sketch(0, seed)
    else:
        kwargs.pop("sketch_dim", None)
        level_sketch = None

    def cycle(xx):
        return sketched_gmres(A, bv, x0=xx, tol=tol, maxiter=maxiter,
                              sketch=sketch, **kwargs)

    x = torch.zeros_like(bv) if x is None else torch.as_tensor(
        x, device=dev).reshape(-1)
    resnorms = []
    result = None
    total = 0
    prev_rel = float("inf")
    escalations = 0
    cycles_left = int(max_restarts) + 1
    while cycles_left > 0:
        cycles_left -= 1
        result = cycle(x)
        niter = int(result.niter)
        total += niter
        chunk = result.resnorms[: niter + 1].cpu().tolist()
        resnorms = resnorms[:-1] + chunk if resnorms else chunk
        x = result.x
        cycle_rel = float(chunk[-1])
        if int(result.status) == CONVERGED or niter == 0:
            break
        distorted = float(result.distortion) > float(distortion_limit)
        if distorted and escalations < int(max_escalations):
            # bad embedding: double the live dimension, fresh seed, and
            # spend one of the remaining cycles re-trying
            escalations += 1
            if level_sketch is not None:
                sketch = level_sketch(escalations,
                                      seed + 7919 * escalations)
            else:
                sketch = draw(kron_sketch, 2 * sketch.d,
                              seed_l=seed + 7919 * escalations)
            prev_rel = cycle_rel if cycle_rel < prev_rel else prev_rel
            continue
        if distorted and classic_fallback:
            # the certificate still fails at the escalation cap: the
            # remaining budget goes to classic GMRES, M as its RIGHT
            # preconditioner (as sketched_gmres applies it)
            budget = max(1, cycles_left + 1) * int(maxiter)
            cres = _classic_gmres(A, bv, x0=x, tol=tol, maxiter=budget,
                                  Mr=kwargs.get("M"))
            cn = int(cres.niter)
            total += cn
            chunk = cres.resnorms[: cn + 1].cpu().tolist()
            resnorms = resnorms[:-1] + chunk
            x = cres.x.reshape(-1)
            result = result._replace(status=cres.status)
            break
        # stop at the attainable floor: the cycle's explicit residual no
        # longer improves
        if cycle_rel >= 0.999 * prev_rel:
            break
        prev_rel = cycle_rel

    return result._replace(
        x=x if b.ndim == 1 else x[:, None],
        resnorms=torch.tensor(resnorms, dtype=real_dtype, device=dev),
        niter=torch.tensor(total, device=dev),
    )


def sketched_eigs(
    A,
    k=6,
    *,
    v0=None,
    n=None,
    which="lm",
    maxiter=80,
    k_ortho=2,
    sketch_dim=None,
    seed=0,
    sketch=None,
    tol=1e-6,
):
    r"""Sketched Rayleigh-Ritz: ``k`` eigenpair estimates of a general
    operator from ONE pass of truncated Arnoldi.

    Builds an m-step ``k_ortho``-locally-orthogonalized basis, embeds
    basis and images through the sketch, whitens by a truncated SVD of
    the small ``(d, m)`` sketched basis, and solves the ``r x r``
    projected eigenproblem on the host.  Every returned pair is certified
    explicitly: ``pair_resnorms[i] = ||A u_i - theta_i u_i|| /
    max(|theta_i|, tiny)``.

    :param v0: start vector; default the JAX package's ``cos(idx *
      0.7391) + 0.01`` (float64; its device as
      :mod:`~krypy_tpu_torch.functional.eigh`'s start).
    :param maxiter: Arnoldi steps m (the trial-space dimension).
    :param tol: certification threshold for CONVERGED status.
    :return: :class:`~krypy_tpu_torch.functional.eigs.EigsResult`.
    """
    from .eigs import EigsResult, _selection_key

    A_mv = as_matvec(A)
    if v0 is not None:
        (v0,) = host_vectors(v0)
        v0 = v0.reshape(-1)
        N = global_length(v0)
        base = v0.dtype
        if _is_matrix(A):
            base = torch.promote_types(base, torch.as_tensor(A).dtype)
    else:
        if n is None:
            shape = getattr(A, "shape", None)
            if shape is None:
                raise ValueError("n= or v0= required when A has no .shape")
            n = shape[0]
        N = int(n)
        v0 = _cos_start(N, _start_device(A))
        base = _operator_dtype(A) or v0.dtype
        if _is_matrix(A):
            base = torch.as_tensor(A).dtype
    dtype = _default_float(base)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    dev = v0.device

    m = min(int(maxiter), N)
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > m:
        raise ValueError(f"k={k} needs maxiter >= k (have {m})")
    k_ortho = max(1, int(k_ortho))

    if sketch is None:
        sketch_dim = 8 * (m + 1) if sketch_dim is None else int(sketch_dim)
        d1, d2 = _split_even(sketch_dim)
        sketch = _draw(N, d1, d2, d1 * d2, _generator(seed, dev), real_dtype,
                       dev)
    d = sketch.d
    if d <= m:
        raise ValueError(f"sketch_dim (realized {d}) must exceed maxiter={m}")

    A_c = cast_matvec(A_mv, dtype)
    v0 = v0.to(dtype)
    v0 = v0 / _norm(v0)
    tiny = breakdown_threshold(dtype)

    Bas = torch.zeros((m + 1, v0.shape[0]), dtype=dtype, device=dev)
    Bas[0] = v0
    SB = torch.zeros((m + 1, d), dtype=dtype, device=dev)
    SB[0] = sketch_apply(sketch, v0).to(dtype)
    SW = torch.zeros((m, d), dtype=dtype, device=dev)
    for j in range(m):
        w = A_c(Bas[j])
        SW[j] = sketch_apply(sketch, w).to(dtype)
        start = max(j - (k_ortho - 1), 0)
        W = Bas[start:start + k_ortho]
        h = mesh_sum(W.conj() @ w)
        u = w - h @ W
        nu = _norm(u)
        Bas[j + 1] = torch.where(nu <= tiny * _norm(w), 0.0,
                                 u / torch.where(nu > 0, nu, 1.0))
        SB[j + 1] = sketch_apply(sketch, Bas[j + 1]).to(dtype)

    # whitening: a truncated SVD of the sketched basis on the host
    # (exhausted zero rows fall out as zero singular values)
    SBh, SWh = SB[:m].cpu().numpy(), SW.cpu().numpy()
    U_s, sig, Vh_s = np.linalg.svd(SBh.T, full_matrices=False)
    finfo = np.finfo(sig.dtype)
    smax = max(float(sig[0]), float(finfo.tiny))
    r = max(int((sig > float(finfo.eps) ** 0.5 * smax).sum()), 1)
    Ur = U_s[:, :r]
    Vr = Vh_s.conj().T[:, :r]
    coords = Vr / sig[None, :r]
    M_small = Ur.conj().T @ SWh.T @ coords

    ev, Y = np.linalg.eig(M_small)
    order = np.argsort(_selection_key(ev, which), kind="stable")
    sel = order[:k]
    theta = ev[sel]
    y = coords @ Y[:, sel]

    cdtype = torch.from_numpy(y).dtype
    X = (torch.from_numpy(np.ascontiguousarray(y.T)).to(dev)
         @ Bas[:m].to(cdtype)).T
    nrm = torch.sqrt(mesh_sum(torch.sum(torch.abs(X) ** 2, dim=0)))
    X = X / torch.where(nrm > 0, nrm, 1.0)[None, :]
    if dtype.is_complex or not X.is_complex():
        # (real Ritz pairs: numpy's eig returns a real basis, and the JAX
        # package's second application, to the zero imaginary part, is
        # not made)
        def apply_col(c):
            return A_c(c)
    else:
        # a real operator on complex Ritz vectors: both parts
        def apply_col(c):
            return torch.complex(A_c(c.real.contiguous()),
                                 A_c(c.imag.contiguous()))

    AX = torch.stack([apply_col(X[:, i]) for i in range(X.shape[1])], dim=1)
    th = torch.from_numpy(np.ascontiguousarray(theta)).to(dev)
    diff = AX - X * th[None, :]
    pair_res = torch.sqrt(mesh_sum(torch.sum(torch.abs(diff) ** 2, dim=0))) \
        / torch.clamp(torch.abs(th), min=tiny)
    status = CONVERGED if bool(torch.all(pair_res <= tol)) else MAXITER
    return EigsResult(
        theta=th,
        U=X,
        resnorms=np.asarray([float(pair_res.max())]),
        niter=m,
        status=status,
        pair_resnorms=pair_res,
    )
