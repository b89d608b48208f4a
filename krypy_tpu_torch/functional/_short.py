"""What the nonsymmetric short-recurrence solvers (``bicgstab``,
``tfqmr``, ``qmr``, ``idrs``, ``fgmres``) share: the system's set-up as
the JAX cores make it, the products they take (each a local partial and
one all-reduce under an active mesh), and the result.

Each solver runs the JAX package's ``lax.while_loop`` as a host loop
that reads one small tensor per iteration (the updated residual and the
breakdown flags), plus the explicit residual where the JAX body computes
it, and makes every stop-rule comparison in the system's real dtype
(``np_real``), so that its counts agree with the JAX package.
"""

import numpy as np
import torch

from .common import (
    SolveResult,
    as_matvec,
    cast_matvec,
    global_length,
    host_vectors,
    mesh_sum,
    safe_div,
    system_dtype,
)


class System:
    """``b``, ``x0`` and the operators of one solve, in the system dtype
    (``b``'s promoted with ``x0``'s), on ``b``'s device.

    :ivar bv: the right-hand side, flat; ``flat``: whether ``b`` was.
    :ivar x0v: the initial guess (zeros where none was given).
    :ivar np_real: the host mirror of the real dtype, for the stop rules.
    :ivar eps: the breakdown floor, ``tiny * 1e4`` of the real dtype, as
      a 0-dim tensor on the device.
    """

    def __init__(self, A, b, x0, *operators):
        b, x0 = host_vectors(b, x0)
        self.flat = b.ndim == 1
        bv = b.reshape(-1)
        self.N = bv.shape[0]
        self.dtype = dtype = system_dtype(bv, x0)
        self.dev = bv.device
        self.bv = bv.to(dtype)
        self.real_dtype = torch.empty(0, dtype=dtype).real.dtype
        self.np_real = torch.empty(
            0, dtype=self.real_dtype).numpy().dtype.type
        self.A_mv = cast_matvec(as_matvec(A), dtype)
        self.operators = [cast_matvec(as_matvec(f), dtype)
                          for f in operators]
        self.x0v = (self.zeros() if x0 is None
                    else x0.reshape(-1).to(dtype))
        self.eps = torch.tensor(
            np.finfo(self.np_real).tiny * self.np_real(1e4),
            dtype=self.real_dtype, device=self.dev)

    def n_global(self):
        """The length of the whole system (one all-reduce on a mesh)."""
        return global_length(self.bv)

    def zeros(self, *shape):
        return torch.zeros(shape or (self.N,), dtype=self.dtype,
                           device=self.dev)

    def scalar(self, value, real=False):
        return torch.tensor(value, device=self.dev,
                            dtype=self.real_dtype if real else self.dtype)

    def true_rel(self, x, bnorm):
        """The explicit relative residual ``||b - A x|| / ||b||`` of ``x``,
        read to the host in the real dtype."""
        return self.np_real(safe_div(norm(self.bv - self.A_mv(x)),
                                     bnorm).item())

    def finish(self, x, resnorms, length, niter, status):
        """The :class:`SolveResult`: ``resnorms`` (host values) NaN-padded
        to ``length`` entries, ``x`` shaped as ``b`` was."""
        res_t = torch.full((length,), float("nan"), dtype=self.real_dtype,
                           device=self.dev)
        res_t[: len(resnorms)] = torch.tensor(
            np.asarray(resnorms, dtype=self.np_real),
            dtype=self.real_dtype).to(self.dev)
        return SolveResult(
            x=x if self.flat else x[:, None],
            resnorms=res_t,
            niter=torch.tensor(niter, dtype=torch.int64, device=self.dev),
            status=torch.tensor(status, dtype=torch.int64, device=self.dev),
        )


def vdot(x, y):
    """``<x, y> = sum conj(x) y`` over the whole vector."""
    return mesh_sum(torch.vdot(x, y))


def bilinear(x, y):
    """``x^T y = sum x y``, unconjugated (QMR's Lanczos coupling)."""
    return mesh_sum(torch.dot(x, y))


def norm(x):
    """``||x||_2`` over the whole vector."""
    return torch.sqrt(torch.clamp(vdot(x, x).real, min=0.0))


def read(*values):
    """The one host read of an iteration: 0-dim tensors (flags as 0/1)
    in one transfer, as Python floats."""
    dt = values[0].dtype
    return torch.stack([v.to(dt) for v in values]).tolist()
