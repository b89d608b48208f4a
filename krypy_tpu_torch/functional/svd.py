r"""Partial SVD: the k largest singular triplets of a (possibly
rectangular) operator (counterpart of :mod:`krypy_tpu.functional.svd`).

``svds`` runs :func:`~krypy_tpu_torch.functional.lobpcg.lobpcg` on the
Gram operator :math:`C = A^H A` with ``which='la'``, then recovers
:math:`\sigma_i = \sqrt{\theta_i}` and the left vectors :math:`u_i = A
v_i / \sigma_i`.  Squaring the spectrum is benign for the LARGEST
singular values, which is all this routine serves.

Every returned triplet is certified explicitly: the reported residuals
are :math:`\|A^H u_i - \sigma_i v_i\| / \sigma_1` (the :math:`\|A v_i -
\sigma_i u_i\|` half is zero by construction of ``u``), computed on the
final vectors.

The Gram operator carries the start device of ``A`` (its tensor's
device, a callable's ``.device`` or its ``.diag``'s, else the default
card), where LOBPCG puts its default start block; ``A`` and ``A^H`` are
applied to the ``k`` right vectors one column at a time (the JAX
package's ``jax.vmap``) or, for a matrix, in one product.
"""

from typing import NamedTuple

import torch

from ..core.dtypes import asarray
from .common import CONVERGED, MAXITER, cast_matvec
from .eigh import _cos_block, _operator_dtype, _start_device
from .lobpcg import lobpcg
from .lsq import _setup
from .randomized import _columns

__all__ = ["svds", "SvdsResult"]


class SvdsResult(NamedTuple):
    """Result of :func:`svds`."""

    #: left singular vectors as columns, shape ``(m, k)``
    U: torch.Tensor
    #: singular values, shape ``(k,)``, descending
    s: torch.Tensor
    #: right singular vectors as rows, shape ``(k, n)`` (scipy's
    #: ``svds`` convention)
    Vh: torch.Tensor
    #: the inner eigensolve's residual history
    resnorms: torch.Tensor
    #: inner Rayleigh-Ritz iterations
    niter: torch.Tensor
    #: CONVERGED / MAXITER -- from the EXPLICIT triplet residuals
    status: torch.Tensor
    #: certified per-triplet residuals ||A^H u - sigma v|| / sigma_1
    pair_resnorms: torch.Tensor = None

    @property
    def converged(self):
        return bool(self.status == CONVERGED)


def svds(
    A,
    k=6,
    *,
    Ah=None,
    n=None,
    X0=None,
    M=None,
    tol=1e-8,
    maxiter=500,
):
    r"""k LARGEST singular triplets of ``A`` by preconditioned LOBPCG on
    the Gram operator.

    :param A: operator, shape ``(m, n)`` (matrix, or matvec callable with
      ``Ah``).  May be rectangular.
    :param k: number of triplets.
    :param Ah: conjugate-transpose matvec ``y -> A^H y``; derived
      automatically for matrices and operators exposing ``.adj``.
    :param n: column dimension when ``A`` has no ``.shape`` and no
      ``X0``.
    :param X0: starting right-vector block, shape ``(n, k)``; REQUIRED
      (complex-typed) for complex callable operators.
    :param M: optional SPD preconditioner for :math:`A^H A`.
    :param tol: certified-triplet test :math:`\|A^H u_i - \sigma_i v_i\|
      \le \mathrm{tol}\,\sigma_1` for all k triplets; the inner
      eigensolve (backward-error criterion) is driven 20x tighter.
    :param maxiter: inner Rayleigh-Ritz iterations.
    :return: :class:`SvdsResult`.
    """
    A_mv, Ah_mv = _setup(A, Ah)

    if X0 is not None:
        X0 = asarray(X0, device=_start_device(A))
        if X0.ndim != 2:
            raise ValueError(f"X0 must be (n, k), got shape "
                             f"{tuple(X0.shape)}")
        # the block width IS the triplet count
        k = int(X0.shape[1])

    if X0 is None and n is None:
        shape = getattr(A, "shape", None)
        if shape is None or len(shape) != 2:
            raise ValueError(
                "n= or X0= required when A has no 2-D .shape"
            )
        n = int(shape[1])

    if X0 is None:
        # the DTYPE must be pinned here: a real default start would make
        # the complex Gram operator's cast project it onto its real part
        op_dt = _operator_dtype(A)
        if op_dt is not None and op_dt.is_complex:
            X0 = _cos_block(int(n), int(k), _start_device(A)).T.to(op_dt)

    def gram(v):
        return Ah_mv(A_mv(v))

    # where lobpcg puts its start block: X0's device, else A's
    gram.device = X0.device if X0 is not None else _start_device(A)

    r = lobpcg(
        gram,
        k,
        X0=X0,
        n=n,
        M=M,
        which="la",
        tol=0.05 * tol,
        maxiter=maxiter,
        criterion="backward",
    )

    theta = torch.clamp(r.theta.real, min=0.0)
    s = torch.sqrt(theta)
    V = r.U                                             # (n, k) columns
    dtype = V.dtype
    AV = _columns(cast_matvec(A_mv, dtype))(V)
    # u_i = A v_i / sigma_i; an exactly-zero sigma (rank < k) yields a
    # zero left vector, reported honestly through its residual
    s_safe = torch.where(s > 0, s, 1.0).to(dtype)
    U = AV / s_safe[None, :] * (s > 0)[None, :].to(V.real.dtype)
    # explicit certification: ||A^H u - sigma v|| / sigma_1
    AhU = _columns(cast_matvec(Ah_mv, dtype))(U)
    res = torch.linalg.vector_norm(AhU - V * s[None, :].to(dtype), dim=0)
    eps_floor = torch.tensor(torch.finfo(s.dtype).tiny ** 0.5,
                             dtype=s.dtype, device=s.device)
    pair_res = res / torch.maximum(s[0], eps_floor)
    status = torch.where(pair_res.max() <= tol, CONVERGED, MAXITER)
    return SvdsResult(
        U=U,
        s=s,
        Vh=V.conj().T.resolve_conj(),
        resnorms=r.resnorms,
        niter=r.niter,
        status=status.to(torch.int64),
        pair_resnorms=pair_res,
    )
