"""QR factorization with a customizable inner product (counterpart of
:mod:`krypy_tpu.core.qr`).

The Euclidean case is the library QR (Householder, LAPACK on the CPU);
the B-inner-product case runs iterated modified Gram-Schmidt.
"""

import torch

from .dtypes import asarray
from .products import inner, norm

__all__ = ["qr"]


def qr(X, ip_B=None, reorthos=1):
    """Economic QR of an ``(N, k)`` block: ``X = Q R`` with
    :math:`\\langle Q, Q\\rangle_{B} = I_k` and R upper triangular.

    :param reorthos: number of reorthogonalization sweeps (default 1, i.e.
      two MGS passes -- "twice is enough").
    """
    X = asarray(X)
    (N, k) = X.shape
    if ip_B is None and k > 0:
        return torch.linalg.qr(X, mode="reduced")
    Q = X.clone()
    R = torch.zeros((k, k), dtype=X.dtype, device=X.device)
    for i in range(k):
        col = Q[:, [i]]
        for _ in range(reorthos + 1):
            for j in range(i):
                alpha = inner(Q[:, [j]], col, ip_B=ip_B)[0, 0]
                R[j, i] += alpha
                col = col - alpha * Q[:, [j]]
        rii = norm(col, ip_B=ip_B)
        R[i, i] = rii
        if rii >= 1e-15:
            col = col / rii
        Q[:, [i]] = col
    return Q, R
