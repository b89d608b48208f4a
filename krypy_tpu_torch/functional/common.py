"""Shared infrastructure of the solver cores (counterpart of
:mod:`krypy_tpu.functional.common`, the subset CG and GMRES need).

Conventions follow the JAX package: vectors are 1-D ``(N,)`` tensors,
operators are plain matvec callables ``(N,) -> (N,)``, and status codes
replace exceptions.
"""

from typing import NamedTuple, Optional

import torch

from ..parallel import active_mesh, all_reduce_sum

#: solve reached the requested tolerance
CONVERGED = 0
#: maxiter reached without convergence
MAXITER = 1
#: the Krylov subspace became invariant (lucky breakdown)
BREAKDOWN = 2


class SolveResult(NamedTuple):
    """Result of a functional solve; every field is a tensor."""

    #: approximate solution, shape ``(N,)``
    x: torch.Tensor
    #: relative residual norms, shape ``(maxiter+1,)``; entries beyond
    #: ``niter`` are NaN
    resnorms: torch.Tensor
    #: number of iterations performed
    niter: torch.Tensor
    #: CONVERGED / MAXITER / BREAKDOWN
    status: torch.Tensor
    #: error norms if an exact solution was supplied, else None
    errnorms: Optional[torch.Tensor] = None

    @property
    def converged(self):
        return bool(self.status == CONVERGED)


def as_matvec(op):
    """Coerce ``op`` into a matvec callable ``(N,) -> (N,)``: ``None``
    (identity), a 2-D tensor, or a callable."""
    if op is None:
        return None
    if isinstance(op, torch.Tensor):
        if op.ndim != 2:
            raise ValueError("matrix operator must be 2-D")

        def mv(x):
            # jnp's promotion: a float32 matrix against a float64 vector
            # computes in float64
            dt = torch.promote_types(op.dtype, x.dtype)
            return op.to(dt) @ x.to(dt)

        return mv
    if callable(op):
        return op
    raise TypeError(f"cannot interpret operator of type {type(op)}")


def apply(mv, x):
    """Apply an optional matvec (None = identity)."""
    return x if mv is None else mv(x)


def cast_matvec(mv, dtype):
    """Pin a matvec's output to the system dtype.

    The right-hand side's dtype governs all solver state.  An operator
    that computes in a wider dtype (a float64 diagonal against a float32
    vector promotes to float64 under torch's rules too) is cast back
    here; the reverse case, a 0-dim float64 tensor times a float32 vector,
    stays float32 in torch where JAX would promote, and is a no-op."""
    if mv is None:
        return None
    return lambda x: mv(x).to(dtype)


def promote(*tensors):
    """The tensors in their promoted dtype (jnp's rule, which products in
    torch do not apply: a float32 vector against a float64 one, e.g. a
    Jacobi preconditioner's float64 diagonal, promotes as in the JAX
    package)."""
    dt = system_dtype(*tensors)
    return tuple(t.to(dt) for t in tensors)


def mesh_sum(t):
    """``t`` summed over the ranks of the active mesh (one all-reduce),
    or ``t`` itself where no mesh is active: the second half of every
    reduction over N, whose first half is the rank's local partial."""
    mesh = active_mesh()
    return t if mesh is None else all_reduce_sum(t, mesh)


def global_length(v):
    """The length of the vector whose block on this rank is ``v`` (one
    all-reduce under an active mesh; ``v``'s own length otherwise)."""
    mesh = active_mesh()
    if mesh is None:
        return v.shape[0]
    return int(all_reduce_sum(torch.tensor(v.shape[0], device=v.device),
                              mesh))


def make_inner(ip):
    """Build the inner-product forms used by the cores.

    :param ip: ``None`` (Euclidean), a matrix ``B`` (2-D tensor or
      matvec callable exposing ``.shape``) for :math:`x^* B y`, or a
      scalar callable ``ip(x, y)`` on 1-D vectors.
    :return: ``(pair, rows)``: ``pair(x, y) -> 0-dim tensor`` and
      ``rows(V, w) -> (m,)`` for every row of ``V``.

    Under an active mesh (:func:`krypy_tpu_torch.parallel.active_mesh`)
    vectors are the rank's blocks, and each form is the local partial
    plus one all-reduce.  A matrix ``B`` must then be rank-local: an
    operator built with ``mesh=`` that mesh, or a 2-D tensor acting on
    the rank's block; a scalar callable, or any other ``B``, raises
    ``NotImplementedError``.
    """
    mesh = active_mesh()
    if ip is None:
        def pair(x, y):
            return mesh_sum(torch.vdot(*promote(x, y)))

        def rows(V, w):
            V, w = promote(V, w)
            return mesh_sum(V.conj() @ w)

        return pair, rows

    if is_matrix_ip(ip):
        local = _local_matvec(ip, mesh)

        def pair(x, y):
            return mesh_sum(torch.vdot(*promote(x, local(y))))

        def rows(V, w):
            V, Bw = promote(V, local(w))
            return mesh_sum(V.conj() @ Bw)

        return pair, rows

    if mesh is not None and callable(ip):
        raise NotImplementedError(
            "a scalar-callable inner product on a mesh is not ported (the "
            "port cannot tell a rank's partial from the whole product; "
            "ROADMAP.md queue A, slice 5)")

    if callable(ip):
        def pair(x, y):
            return ip(x, y)

        def rows(V, w):
            return torch.stack([ip(v, w) for v in V])

        return pair, rows

    raise TypeError(f"cannot interpret inner product of type {type(ip)}")


def is_matrix_ip(ip):
    """Is ``ip`` an inner-product matrix ``B`` (a 2-D tensor or an
    operator exposing ``.shape``), as opposed to ``None`` or a scalar
    callable?"""
    return isinstance(ip, torch.Tensor) or hasattr(ip, "shape")


def is_scalar_ip(ip):
    """Is ``ip`` a scalar-callable inner product ``ip(x, y)``, which the
    one-reduce fusions cannot batch into one contraction?"""
    return ip is not None and not is_matrix_ip(ip)


def _local_matvec(ip, mesh):
    """The matvec of an inner-product matrix ``B``; under a mesh ``B``
    must be rank-local (an operator built with ``mesh=`` that mesh, or a
    2-D tensor on the rank's block), else ``NotImplementedError``."""
    if mesh is not None and not isinstance(ip, torch.Tensor) and \
            getattr(ip, "mesh", None) is not mesh:
        raise NotImplementedError(
            "an inner-product matrix on a mesh must be rank-local (an "
            "operator built with mesh= the active mesh, or a 2-D "
            "tensor on the rank's block; ROADMAP.md queue A, slice 5)")
    Bmv = as_matvec(ip)

    def local(y):
        if mesh is not None and isinstance(ip, torch.Tensor) and \
                ip.shape != (y.shape[0], y.shape[0]):
            raise NotImplementedError(
                f"inner-product matrix of shape {tuple(ip.shape)} on "
                f"a rank block of {y.shape[0]}: a mesh takes a "
                "rank-local B only")
        return Bmv(y)

    return local


def ip_matvec(ip):
    """``B``'s local matvec for the one-reduce fusions, which apply ``B``
    themselves and reduce once (``None`` for the Euclidean product); a
    scalar callable raises ``TypeError``."""
    if ip is None:
        return None
    if not is_matrix_ip(ip):
        raise TypeError(
            "one-reduce fusion needs the Euclidean or operator-weighted "
            f"inner product, got {type(ip)}")
    return _local_matvec(ip, active_mesh())


def make_gram(ip):
    """Build a fused cross-Gram form for the one-reduce rearrangements.

    ``gram(L, R) -> (k, l)`` computes :math:`G_{ij} = \\langle L_i,
    R_j\\rangle` for bundles of vectors ``L`` (``k`` of them) and ``R``
    (``l``), each a 2-D tensor of rows or a sequence of vectors: local
    products and a single all-reduce under an active mesh, however many
    scalars are read off ``G``.  Nothing is stacked: where one bundle is
    a 2-D tensor (a persistent buffer) each vector of the other meets it
    in one matrix-vector product, else each pair in one dot product.
    ``ip`` is ``None`` or a matrix ``B`` (applied to each vector of
    ``R``, locally); a scalar callable raises ``TypeError``, as in the
    JAX package (the one-reduce variants raise ``ValueError`` before they
    get here)."""
    Bmv = ip_matvec(ip)

    def gram(L, R):
        if Bmv is not None:
            R = [Bmv(r) for r in R]
        if isinstance(R, torch.Tensor):
            G = torch.stack([torch.mv(*promote(R, l.conj())) for l in L])
        elif isinstance(L, torch.Tensor):
            G = torch.stack([torch.mv(*promote(L.conj(), r)) for r in R],
                            dim=1)
        else:
            G = torch.stack([torch.stack([torch.vdot(*promote(l, r))
                                          for r in R]) for l in L])
        return mesh_sum(G)

    return gram


def twice_solver(G):
    """``cap -> G^{-1} cap`` applied twice (Stewart's "twice is
    enough": ``q1 = G^{-1} cap``, ``q2 = G^{-1} (cap - G q1)``, returns
    ``q1 + q2``), through ONE LU factorization of the small ``G``, taken
    now; neither the factorization nor the solves read anything back to
    the host."""
    LU, piv, _ = torch.linalg.lu_factor_ex(G)

    def solve(c):
        return torch.linalg.lu_solve(LU, piv, c[:, None])[:, 0]

    def coeffs(cap):
        cap = cap.to(G.dtype)
        q1 = solve(cap)
        return q1 + solve(cap - G @ q1)

    return coeffs


def norm_from_pair(pair, x, y=None):
    """sqrt(Re <x, y>) with the given pair product."""
    val = pair(x, x if y is None else y)
    return torch.sqrt(torch.clamp(val.real, min=0.0))


def safe_div(a, b):
    """a / b with b == 0 mapped to 0 (relative norms of a zero rhs)."""
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a), a / torch.where(
        zero, torch.ones_like(b), b))


def breakdown_threshold(dtype):
    """Relative subdiagonal threshold for invariance detection: 45 eps
    of ``dtype`` (float64 eps for non-float dtypes)."""
    if dtype.is_floating_point or dtype.is_complex:
        eps = torch.finfo(dtype).eps
    else:
        eps = torch.finfo(torch.float64).eps
    return float(45 * eps)


def system_dtype(*tensors):
    """Promoted dtype of the given tensors (``None`` entries skipped)."""
    dt = None
    for t in tensors:
        if t is None:
            continue
        dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return dt


def givens(a, b):
    """Branch-free complex-safe Givens coefficients ``(c, s, r)`` of two
    0-dim tensors, with real ``c >= 0``, such that ``[[c, s], [-conj(s),
    c]] @ [a, b] = [r, 0]``; computed on the tensors' device with no host
    read.  Counterpart of ``krypy_tpu.functional.common.givens_traced``,
    term for term."""
    abs_a = a.abs()
    abs_b = b.abs()
    denom = torch.sqrt(abs_a ** 2 + abs_b ** 2)
    safe = torch.where(denom == 0, 1.0, denom)
    sign_a = torch.where(
        abs_a == 0, 1.0 + 0.0 * a,
        a / torch.where(abs_a == 0, 1.0, abs_a).to(a.dtype),
    )
    c = torch.where(abs_b == 0, 1.0,
                    torch.where(abs_a == 0, 0.0, abs_a / safe))
    s = torch.where(
        abs_b == 0,
        0.0 * a,
        torch.where(
            abs_a == 0,
            b.conj() / torch.where(abs_b == 0, 1.0, abs_b).to(b.dtype),
            sign_a * b.conj() / safe.to(a.dtype),
        ),
    )
    r = torch.where(
        abs_b == 0,
        a,
        torch.where(abs_a == 0, abs_b.to(a.dtype), sign_a * denom.to(a.dtype)),
    )
    return c, s, r
