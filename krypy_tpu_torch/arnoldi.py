"""Arnoldi / Lanczos relation builders (counterpart of
:mod:`krypy_tpu.arnoldi`).

The incremental :class:`Arnoldi` engine with the schemes of the JAX
package: modified Gram-Schmidt (``'mgs'``), doubly-reorthogonalized MGS
(``'dmgs'``), the Lanczos three-term recurrence (``'lanczos'``),
Householder (``'house'``), and classical Gram-Schmidt (``'cgs'``,
``'cgs2'``), which batches each pass into two matrix products.

Device/host split, as in the JAX package's eager lane: the small state
(the Hessenberg matrix and every scalar coefficient) lives on the host in
numpy, in the engine's dtype, every N-dimensional object (basis vectors,
operator applications) is a tensor on the operator's device.
"""

import warnings

import numpy as np
import torch

from .config import invariance_threshold
from .core.dtypes import asarray, find_common_dtype
from .core.operators import (IdentityLinearOperator, LinearOperator,
                             get_linearoperator)
from .core.products import _mm, inner, norm
from .core.rotations import House
from .errors import ArgumentError

__all__ = ["Arnoldi", "arnoldi", "arnoldi_res", "arnoldi_projected"]

_ORTHO_MODES = ("mgs", "dmgs", "lanczos", "house", "cgs", "cgs2")


def host_dtype(dtype):
    """The numpy dtype of torch ``dtype`` (the host-side small matrices
    of an engine or solver of that dtype)."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def host(x):
    """A tensor (or anything numpy takes) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def scalar(x, complex_ok):
    """A host scalar (numpy or 0-dim tensor) as a Python number; its real
    part where the basis is real."""
    val = complex(x.item() if isinstance(x, torch.Tensor) else x)
    return val if complex_ok else val.real


def device_of(*candidates):
    """The device of the first tensor, or operator with tensors of its
    own, among ``candidates``, else ``"cuda"`` (a numpy array's
    ``device`` names no torch device and is skipped)."""
    for c in candidates:
        if isinstance(c, torch.Tensor):
            return c.device
        if isinstance(c, LinearOperator) and c.device is not None:
            return c.device
    return "cuda"


def _append_stack(cache, cols, N, dtype, device):
    """Incrementally maintained column-stack of ``cols`` (a list of
    ``(N, 1)`` columns): only the columns beyond the cached prefix are
    concatenated, so a view access after one append is one concatenate,
    and a repeat access with no new column is free."""
    n = len(cols)
    if n == 0:
        return torch.zeros((N, 0), dtype=dtype, device=device)
    have = 0 if cache is None else cache.shape[1]
    if have == n:
        return cache
    new = torch.cat([c.reshape(N, 1) for c in cols[have:]], dim=1)
    return new if have == 0 else torch.cat([cache, new], dim=1)


class Arnoldi:
    r"""Incrementally build V and H with :math:`A V_n = V_{n+1}\underline{H}_n`.

    If the Krylov subspace becomes A-invariant, V and H are truncated so
    that :math:`A V_n = V_n H_n` and :attr:`invariant` is set.

    :param A: linear operator (coercible via ``get_linearoperator``).
    :param v: initial vector ``(N, 1)``.
    :param maxiter: maximal number of iterations (default N).
    :param ortho: one of ``'mgs'`` (default), ``'dmgs'``, ``'cgs'``,
      ``'cgs2'``, ``'lanczos'``, ``'house'``.
    :param M: (optional) self-adjoint positive definite preconditioner; a
      second basis :math:`P_n` with :math:`V_n = M P_n` is then
      maintained.  Must be ``None`` for ``ortho='house'``.
    :param ip_B: (optional) inner product; must be Euclidean for
      ``ortho='house'``.
    :param device: where numpy data go: ``None`` means the device of ``v``
      where it is a tensor (else of ``A``, else ``"cuda"``).
    """

    def __init__(
        self, A, v, maxiter=None, ortho="mgs", M=None, Mv=None, Mv_norm=None,
        ip_B=None, *, device=None,
    ):
        device = device_of(v, A) if device is None else device
        v = asarray(v, device=device)
        device = v.device
        N = v.shape[0]
        self.A = get_linearoperator((N, N), A, device=device)
        self.maxiter = N if maxiter is None else maxiter
        self.ortho = ortho
        self.M = get_linearoperator((N, N), M, device=device)
        if isinstance(self.M, IdentityLinearOperator):
            self.M = None
        self.ip_B = ip_B

        self.dtype = find_common_dtype(self.A, v, M)
        self._complex = self.dtype.is_complex
        self.device = device
        self.iter = 0
        self.invariant = False
        self._N = N
        # device-side basis columns (N, 1) each; host-side Hessenberg
        self._V = []
        self._P = [] if self.M is not None else None
        # cached column-stacks of the above (prefix reuse; append-only)
        self._Vstack = None
        self._Pstack = None
        self._H = np.zeros((self.maxiter + 1, self.maxiter),
                           dtype=host_dtype(self.dtype))
        self._breakdown_tol = invariance_threshold(self.dtype)

        if ortho == "house":
            if self.M is not None or (
                ip_B is not None
                and not isinstance(ip_B, IdentityLinearOperator)
            ):
                raise ArgumentError(
                    "Householder orthogonalization requires the Euclidean "
                    "inner product and no preconditioner M"
                )
            self.houses = [House(v)]
            self.vnorm = float(torch.linalg.vector_norm(v))
        elif ortho in ("mgs", "dmgs", "lanczos", "cgs", "cgs2"):
            self.reorthos = 1 if ortho in ("dmgs", "cgs2") else 0
            if self.M is not None:
                p = v
                v = self.M * p if Mv is None else asarray(Mv, device=device)
                self.vnorm = float(
                    norm(p, v, ip_B=ip_B) if Mv_norm is None else Mv_norm
                )
                if self.vnorm > 0:
                    self._P.append(p / self.vnorm)
            else:
                self.vnorm = float(
                    norm(v, ip_B=ip_B) if Mv_norm is None else Mv_norm
                )
        else:
            raise ArgumentError(
                f"Invalid value '{ortho}' for argument 'ortho'. "
                f"Valid are {', '.join(_ORTHO_MODES)}."
            )

        if self.vnorm > 0:
            self._V.append(v / self.vnorm)
        else:
            self.invariant = True

    # -- views ----------------------------------------------------------
    @property
    def V(self):
        """Device matrix of the basis vectors computed so far,
        ``(N, k+1)``."""
        self._Vstack = _append_stack(self._Vstack, self._V, self._N,
                                     self.dtype, self.device)
        return self._Vstack

    @property
    def P(self):
        """Device matrix of the preconditioned dual basis (``V = M P``)."""
        if self._P is None:
            return None
        self._Pstack = _append_stack(self._Pstack, self._P, self._N,
                                     self.dtype, self.device)
        return self._Pstack

    @property
    def H(self):
        """Host Hessenberg buffer, shape ``(maxiter+1, maxiter)``."""
        return self._H

    def basis_vector(self, k):
        """The k-th basis vector as a device ``(N, 1)`` column."""
        return self._V[k]

    # ------------------------------------------------------------------
    def advance(self):
        """Carry out one Arnoldi iteration."""
        if self.iter >= self.maxiter:
            raise ArgumentError("Maximum number of iterations reached.")
        if self.invariant:
            raise ArgumentError(
                "Krylov subspace was found to be invariant in the previous "
                "iteration."
            )

        k = self.iter
        Av = self.A * self._V[k]

        if self.ortho == "house":
            self._advance_house(Av, k)
        else:
            self._advance_gs(Av, k)
        self.iter += 1

    def _check_invariance(self, k):
        """Relative-subdiagonal breakdown test."""
        subdiag = abs(self._H[k + 1, k])
        hnorm = np.linalg.norm(self._H[: k + 2, : k + 1], 2)
        if subdiag / hnorm <= self._breakdown_tol:
            self.invariant = True
            return True
        return False

    def _alpha_scalar(self, alpha, conj=False):
        """Householder phase factor as a host scalar of the basis's kind."""
        val = complex(alpha.item())
        if conj:
            val = val.conjugate()
        return val if self._complex else val.real

    def _advance_house(self, Av, k):
        """Householder step."""
        N = self._N
        Av = Av.clone()
        for j in range(k + 1):
            house = self.houses[j]
            Av[j:] = house.apply(Av[j:])
            Av[j] *= self._alpha_scalar(house.alpha, conj=True)
        if k + 1 < N:
            house = House(Av[k + 1:])
            self.houses.append(house)
            Av[k + 1:] = (house.apply(Av[k + 1:])
                          * self._alpha_scalar(house.alpha, conj=True))
            col = host(Av[: k + 2, 0])
        else:
            col = host(Av[: k + 1, 0])
        self._H[: len(col), k] = col
        self._H[k + 1, k] = abs(self._H[k + 1, k])
        if not self._check_invariance(k):
            vnew = torch.zeros((N, 1), dtype=self.dtype, device=self.device)
            vnew[k + 1] = 1
            for j in range(k + 1, -1, -1):
                vnew[j:] = self.houses[j].apply(vnew[j:])
            self._V.append(vnew * self._alpha_scalar(self.houses[-1].alpha))

    def _advance_gs(self, Av, k):
        """Gram-Schmidt / Lanczos step."""
        start = 0
        if self.ortho == "lanczos":
            start = k
            if k > 0:
                self._H[k - 1, k] = self._H[k, k - 1]
                prev = (
                    self._P[k - 1] if self.M is not None else self._V[k - 1]
                )
                Av = Av - scalar(self._H[k, k - 1], self._complex) * prev

        basis = self._P if self.M is not None else self._V
        for _ in range(self.reorthos + 1):
            if self.ortho in ("cgs", "cgs2"):
                # classical (batched) Gram-Schmidt: one block inner
                # product and one block update (start == 0 here)
                Vk = self.V
                Bk = self.P if self.M is not None else Vk
                coeffs = inner(Vk, Av, ip_B=self.ip_B)
                Av = Av - _mm(Bk, coeffs)
                self._H[start: k + 1, k] += host(coeffs)[:, 0]
            else:
                for j in range(start, k + 1):
                    alpha = complex(
                        inner(self._V[j], Av, ip_B=self.ip_B)[0, 0].item()
                    )
                    if self.ortho == "lanczos":
                        if abs(alpha.imag) > 1e-10:
                            warnings.warn(
                                f"Iter {self.iter}: abs(alpha.imag) = "
                                f"{abs(alpha.imag)} > 1e-10. Is your "
                                "operator self-adjoint in the provided "
                                "inner product?"
                            )
                        alpha = alpha.real
                    if not self._complex:
                        alpha = alpha.real
                    self._H[j, k] += alpha
                    Av = Av - alpha * basis[j]

        if self.M is not None:
            MAv = self.M * Av
            hnew = float(norm(Av, MAv, ip_B=self.ip_B))
        else:
            hnew = float(norm(Av, ip_B=self.ip_B))
        self._H[k + 1, k] = hnew

        if not self._check_invariance(k):
            if self.M is not None:
                self._P.append(Av / hnew)
                self._V.append(MAv / hnew)
            else:
                self._V.append(Av / hnew)

    # ------------------------------------------------------------------
    def get(self):
        """Return ``(V, H)`` (plus ``P`` if M was given), truncated to the
        invariant relation if a breakdown occurred."""
        k = self.iter
        if self.invariant:
            V = self.V[:, :k]
            H = self._H[:k, :k]
            P = self.P[:, :k] if self.M is not None else None
        else:
            V = self.V[:, : k + 1]
            H = self._H[: k + 1, :k]
            P = self.P[:, : k + 1] if self.M is not None else None
        return (V, H, P) if self.M is not None else (V, H)

    def get_last(self):
        """Return the newest basis vector and Hessenberg column."""
        k = self.iter
        if self.invariant:
            V, H = None, self._H[:k, [k - 1]]
            P = None
        else:
            V, H = self._V[k], self._H[: k + 1, [k - 1]]
            P = self._P[k] if self.M is not None else None
        return (V, H, P) if self.M is not None else (V, H)


def arnoldi(*args, **kwargs):
    """One-shot Arnoldi: run to maxiter or invariance, return ``get()``."""
    eng = Arnoldi(*args, **kwargs)
    while eng.iter < eng.maxiter and not eng.invariant:
        eng.advance()
    return eng.get()


def arnoldi_res(A, V, H, ip_B=None):
    """Arnoldi residual
    :math:`\\|A V_n - V_{n+1}\\underline{H}_n\\|` (or the invariant
    variant)."""
    V = asarray(V, device=device_of(A))
    H = asarray(H, device=V.device)
    N = V.shape[0]
    A = get_linearoperator((N, N), A, device=V.device)
    invariant = H.shape[0] == H.shape[1]
    AV = A * (V if invariant else V[:, :-1])
    res = AV - _mm(V, H)
    return norm(res, ip_B=ip_B)


def arnoldi_projected(H, P, k, ortho="mgs", *, device=None):
    """Perturbed Arnoldi relation for a projected operator, computed purely
    from existing small-dimensional data (no new N-dim matvecs).

    Given :math:`\\underline{H}_n` and a projection P on coefficient space
    with a k-dimensional null space, computes U, G, F with
    :math:`(\\tilde P A + E_i) W_i = W_{i+1}\\underline{G}_i` where
    :math:`W_i = V_n U_i` and the error term is
    :math:`E_i x = v_{n+1} F_i\\langle W_i, x\\rangle`.  ``device`` (where
    ``H`` goes where it is numpy): ``None`` means ``H``'s device, else
    ``P``'s, else ``"cuda"``.
    """
    device = device_of(H, P) if device is None else device
    H = asarray(H, device=device)
    n = H.shape[1]
    dtype = find_common_dtype(H, P)
    invariant = H.shape[0] == n
    hlast = 0 if invariant else scalar(H[-1, -1], dtype.is_complex)
    H_sq = get_linearoperator((n, n), H if invariant else H[:-1, :],
                              device=H.device)
    P = get_linearoperator((n, n), P, device=H.device)
    v = P * torch.eye(n, 1, dtype=dtype, device=H.device)
    maxiter = n - k + 1
    F = np.zeros((1, maxiter), dtype=host_dtype(dtype))

    PH = LinearOperator((n, n), dtype, lambda x: P * (H_sq * x))
    PH.device = H.device
    eng = Arnoldi(PH, v, maxiter=maxiter, ortho=ortho)
    while eng.iter < eng.maxiter and not eng.invariant:
        u, _ = eng.get_last()
        val = hlast * complex(u[-1, 0].item())
        F[0, eng.iter] = val if dtype.is_complex else val.real
        eng.advance()
    U, G = eng.get()
    return U, G, F[[0], : eng.iter]
