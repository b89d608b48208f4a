r"""Randomized low-rank primitives: randomized SVD, the Nystrom
preconditioner and the Hutch++ trace estimate (counterpart of
:mod:`krypy_tpu.functional.randomized`).

All three are block algorithms (Halko-Martinsson-Tropp range finding):
a fixed number of operator applications to ``(N, l)`` panels, QR
factorizations of tall panels and small dense eigendecompositions, on
the device of the operands.

* :func:`rsvd` -- fixed-rank approximate SVD with subspace (power)
  iteration; for matvec-only operators the adjoint comes from ``Ah=``,
  an ``.adj`` attribute, or :func:`~krypy_tpu_torch.functional.qmr.
  transpose_matvec` (reverse mode; the port's K1 has none, so a kernel
  operator takes ``Ah=``).
* :func:`nystrom_preconditioner` -- the randomized Nystrom preconditioner
  for SPD systems (Frangella, Tropp & Udell, SIAM J. Sci. Comput. 2023):
  one block of ``rank + p`` matvecs at construction, then each
  application is two small panel contractions and no operator
  application.
* :func:`hutchpp` -- Hutch++ (Meyer, Musco, Musco & Woodruff 2021).

The JAX package maps the matvec over the panel's columns with
``jax.vmap``; the port applies a matrix in one product and any other
operator one column at a time (the kernel wrappers take one vector per
launch).  The JAX package draws with ``jax.random``; the port draws from
a ``torch.Generator`` on the operands' device seeded by ``seed``/``key``
(the draws differ, so each function is a draw and a private core that
takes the Gaussian block: ``_rsvd_core``, ``_nystrom_core``,
``_hutchpp_core``).
"""

import math
from typing import NamedTuple

import torch

from ..core.dtypes import torch_dtype
from .common import as_matvec, cast_matvec
from .eigh import _is_matrix, _start_device
from .qmr import transpose_matvec

__all__ = ["RsvdResult", "rsvd", "nystrom_preconditioner", "hutchpp"]


class RsvdResult(NamedTuple):
    """Result of :func:`rsvd`."""

    #: left singular vectors as columns, shape ``(m, k)``
    U: torch.Tensor
    #: singular values, shape ``(k,)``, descending
    s: torch.Tensor
    #: right singular vectors as rows, shape ``(k, n)`` (scipy
    #: convention)
    Vh: torch.Tensor
    #: certified residuals ``max(||A v_i - s_i u_i||,
    #: ||A^H u_i - s_i v_i||) / s_1`` per triplet
    resnorms: torch.Tensor


def _generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded by ``seed``, or ``seed``
    itself where it is a generator."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _gaussian(gen, shape, dtype, device):
    """Standard normal entries of ``dtype`` (complex: real and imaginary
    parts each of variance 1/2)."""
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    if dtype.is_complex:
        re = torch.randn(shape, generator=gen, dtype=real_dtype,
                         device=device)
        im = torch.randn(shape, generator=gen, dtype=real_dtype,
                         device=device)
        return torch.complex(re, im) / math.sqrt(2.0)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _rademacher(gen, shape, dtype, device):
    """Entries +-1 of ``dtype``, each with probability 1/2."""
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    signs = torch.randint(0, 2, shape, generator=gen, device=device)
    return (2 * signs - 1).to(real_dtype).to(dtype)


def _dtype_of(A, dtype):
    """The working dtype: ``dtype``, else a matrix's own, else float32
    (the JAX package's default for callables)."""
    if dtype is not None:
        return torch_dtype(dtype)
    if _is_matrix(A):
        return torch_dtype(A.dtype)
    return torch.float32


def _columns(mv):
    """``mv`` applied to each column of an ``(n, l)`` panel."""
    return lambda X: torch.stack([mv(X[:, j].contiguous())
                                  for j in range(X.shape[1])], dim=1)


def _block_ops(A, Ah, n, dtype, device):
    """``(block_A, block_Ah)`` applying the operator and its adjoint to
    column panels in ``dtype``."""
    if _is_matrix(A):
        mat = torch.as_tensor(A, device=device).to(dtype)
        return (lambda X: mat @ X), (lambda Y: mat.conj().T @ Y)
    raw_mv = as_matvec(A)
    # pin the function's dtype so the derived transpose's cotangent type
    # matches even when the matvec computes wider
    A_mv = cast_matvec(lambda v: raw_mv(v.to(dtype)), dtype)
    if Ah is None:
        if hasattr(A, "adj"):
            Ah_mv = cast_matvec(as_matvec(A.adj), dtype)
        else:
            if n is None:
                raise ValueError(
                    "n= (the operator's input dimension) is required "
                    "for callable operators"
                )
            # built at the first adjoint application (its construction
            # applies A once; hutchpp never applies the adjoint)
            built = []

            def Ah_mv(y):
                if not built:
                    built.append(transpose_matvec(A_mv, int(n), dtype,
                                                  device=device))
                return torch.conj(built[0](torch.conj(y.to(dtype))))
    else:
        Ah_mv = cast_matvec(as_matvec(Ah), dtype)
    return _columns(A_mv), _columns(Ah_mv)


def _qr(X):
    return torch.linalg.qr(X)[0]


def _gram_svd(B):
    """Economy SVD of a tall panel via the small Gram eigendecomposition:
    ``(U, s, W)`` with ``B ~ U diag(s) W^H``; columns beyond the
    numerical rank get zero singular values and zero columns."""
    G = B.conj().T @ B
    w, W = torch.linalg.eigh(G)  # ascending
    w = w.flip(0)
    W = W.flip(1)
    s = torch.sqrt(torch.clamp(w.real, min=0.0))
    smax = torch.clamp(s[0], min=torch.finfo(s.dtype).tiny)
    keep = s > torch.finfo(s.dtype).eps ** 0.5 * smax
    inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    U = (B @ W) * inv[None, :].to(B.dtype)
    return U, s, W


def rsvd(A, k, *, Ah=None, n=None, p=10, q=2, seed=0, dtype=None):
    r"""Randomized SVD: the ``k`` dominant singular triplets.

    :param A: matrix (2-D tensor or numpy array), or matvec callable
      ``(n,) -> (m,)``.
    :param Ah: conjugate-transpose matvec; derived by reverse mode
      (:func:`~krypy_tpu_torch.functional.qmr.transpose_matvec`) for
      differentiable callables (pass ``n=``).
    :param n: input dimension (callables).
    :param p: oversampling columns (the sketch has ``k + p`` columns).
    :param q: subspace-iteration count; each step is one ``A`` and one
      ``A^H`` panel application with a QR in between.
    :param seed: seed of the sketch's ``torch.Generator`` on the
      operator's device (or a generator).
    :param dtype: working dtype (default: a matrix's own, else float32).
    :return: :class:`RsvdResult` with certified per-triplet residuals.
    """
    dtype = _dtype_of(A, dtype)
    if _is_matrix(A) and n is None:
        n = int(A.shape[1])
    device = _start_device(A)
    blocks = _block_ops(A, Ah, n, dtype, device)
    l = int(k) + int(p)
    Om = _gaussian(_generator(seed, device), (int(n), l), dtype, device)
    return _rsvd_core(blocks, k, Om, q)


def _rsvd_core(blocks, k, Om, q):
    """:func:`rsvd` on the Gaussian sketch ``Om`` ``(n, k + p)``."""
    blk, blk_h = blocks
    k = int(k)
    Q = _qr(blk(Om))
    for _ in range(int(q)):
        Z = _qr(blk_h(Q))
        Q = _qr(blk(Z))

    B = blk_h(Q)  # (n, l) = A^H Q
    # B^H = Q^H A ~ (U_small) diag(s) V^H: SVD via the small Gram
    V, s, W = _gram_svd(B)
    U = Q @ W

    U, s, V = U[:, :k], s[:k], V[:, :k]
    smax = torch.clamp(s[0], min=torch.finfo(s.dtype).tiny)
    sd = s[None, :].to(U.dtype)
    r1 = blk(V) - U * sd
    r2 = blk_h(U) - V * sd
    res = torch.maximum(torch.linalg.vector_norm(r1, dim=0),
                        torch.linalg.vector_norm(r2, dim=0)) / smax
    return RsvdResult(U=U, s=s, Vh=V.conj().T.resolve_conj(), resnorms=res)


def nystrom_preconditioner(
    A, rank, n, *, p=10, mu=0.0, seed=0, dtype=torch.float32,
    return_factors=False,
):
    r"""Randomized Nystrom preconditioner for SPD ``A + mu I``.

    Construction (Frangella-Tropp-Udell): ONE block of ``rank + p``
    matvecs ``Y = A Omega``, a stabilizing shift ``nu = eps ||Y||_F``, a
    small Cholesky and the Gram-trick SVD give the Nystrom approximation
    :math:`\hat A = U \hat\Lambda U^H`.  The returned matvec applies

    .. math:: P^{-1} = (\hat\lambda_r + \mu)\, U (\hat\Lambda + \mu I)^{-1} U^H
              + (I - U U^H)

    -- two ``(rank, N)`` panel contractions, no operator application.

    :param mu: the shift of the system being solved (``A + mu I``); 0
      for plain SPD ``A``.
    :param seed: seed of the sketch's ``torch.Generator`` on the
      operator's device (or a generator).
    :param return_factors: also return ``(U, lambdas)``.
    :return: a matvec callable (and optionally the factors).
    """
    dtype = torch_dtype(dtype)
    device = _start_device(A)
    l = int(rank) + int(p)
    Om = _gaussian(_generator(seed, device), (int(n), l), dtype, device)
    return _nystrom_core(A, rank, Om, mu, return_factors)


def _nystrom_core(A, rank, Om, mu=0.0, return_factors=False):
    """:func:`nystrom_preconditioner` on the Gaussian sketch ``Om``
    ``(n, rank + p)`` (its dtype the working dtype)."""
    dtype = Om.dtype
    rank = int(rank)
    Om = _qr(Om)
    if _is_matrix(A):
        mat = torch.as_tensor(A, device=Om.device)
        Y = (mat.to(torch.promote_types(mat.dtype, dtype))
             @ Om.to(torch.promote_types(mat.dtype, dtype))).to(dtype)
    else:
        Y = _columns(cast_matvec(as_matvec(A), dtype))(Om)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    nu = torch.finfo(real_dtype).eps * torch.linalg.vector_norm(Y)
    Ynu = Y + nu.to(dtype) * Om
    G = Om.conj().T @ Ynu
    # symmetrize against roundoff before the Cholesky
    C = torch.linalg.cholesky(0.5 * (G + G.conj().T))
    # B = Ynu C^{-H}, (n, l), with B B^H = Ynu G^{-1} Ynu^H: the JAX
    # package's solve of C B^H = Ynu^H, taken from the right (the left
    # solve with n right-hand sides takes ~12 s at n = 4095^2 on the H100)
    B = torch.linalg.solve_triangular(C.conj().T, Ynu, upper=True,
                                      left=False)
    U, sB, _ = _gram_svd(B)
    lam = torch.clamp(sB * sB - nu, min=0.0)[:rank]
    U = U[:, :rank]

    lam_r = lam[-1]
    scale = lam_r + mu
    denom = lam + mu
    denom = torch.where(denom > 0, denom, 1.0)
    ratio = (scale / denom).to(dtype)
    Uh = U.conj().T

    def P_inv(x):
        xd = x.to(dtype)
        c = Uh @ xd
        inside = U @ (c * ratio)
        return inside + (xd - U @ c)

    if return_factors:
        return P_inv, (U, lam)
    return P_inv


def hutchpp(A, key, *, n=None, k=32, n_probes=32, Ah=None, dtype=None):
    r"""Hutch++ trace estimate of an implicit square operator (Meyer,
    Musco, Musco & Woodruff 2021).

    Splits ``trace(A)`` into an EXACT low-rank head plus a Hutchinson
    estimate of the deflated tail: with ``Q = qr(A Omega)``,

    .. math:: \mathrm{tr}(A) = \mathrm{tr}(Q^H A Q)
              + \mathrm{E}[z^H (I - QQ^H) A (I - QQ^H) z].

    :param key: seed of the ``torch.Generator`` (on the operator's device)
      that draws the sketch and then the probes, or a generator.
    :param k: head-sketch columns (the rank deflated exactly).
    :param n_probes: Rademacher probes on the deflated tail.
    :param Ah: accepted for the JAX package's signature (the estimate
      applies ``A`` only).
    :return: ``(estimate, stderr)`` -- stderr is the standard error of
      the tail term over probes (the head is exact).
    """
    dtype = _dtype_of(A, dtype)
    if _is_matrix(A) and n is None:
        n = int(A.shape[0])
    if n is None:
        raise ValueError("n= is required for callable operators")
    device = _start_device(A)
    blk, _ = _block_ops(A, Ah, n, dtype, device)
    N = int(n)
    gen = _generator(key, device)
    Om = _gaussian(gen, (N, int(k)), dtype, device)
    Z = _rademacher(gen, (N, int(n_probes)), dtype, device)
    return _hutchpp_core(blk, Om, Z)


def _hutchpp_core(blk, Om, Z):
    """:func:`hutchpp` on the sketch ``Om`` ``(N, k)`` and the probes
    ``Z`` ``(N, n_probes)``."""
    Q = _qr(blk(Om))

    # exact head: trace(Q^H A Q)
    AQ = blk(Q)
    head = torch.trace(Q.conj().T @ AQ)

    # Hutchinson on the deflated tail, all probes in one block
    Zd = Z - Q @ (Q.conj().T @ Z)        # (I - QQ^H) z
    AZd = blk(Zd)
    AZdd = AZd - Q @ (Q.conj().T @ AZd)  # (I - QQ^H) A (I - QQ^H) z
    quad = torch.sum(Zd.conj() * AZdd, dim=0)  # (n_probes,)
    tail = torch.mean(quad)
    stderr = torch.std(quad.real, correction=0) / math.sqrt(Z.shape[1])
    return head + tail, stderr
