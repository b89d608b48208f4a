"""Moving state between the JAX package and the port.

A solver has no weights: the state that crosses between the two
packages is vectors (right-hand sides, initial guesses, residuals),
operator coefficients, and what one solve of a sequence hands to the
next: the ``return_internal`` dictionary of a GMRES solve and a deflation
basis.  Arrays cross as numpy arrays with their dtype kept.  Operators
cross by calling the port's constructor with the same arguments as the
JAX one (``nx``, ``pad_cols``, ``coarsest``, ``coarse_sweeps``, ...),
since the JAX operators are closures whose only state is those
arguments.

A Newton iterate is a vector (:func:`from_numpy`); the nonlinear
problem of BASELINE config 5 crosses as its root ``u*`` and its
manufactured source ``g`` (:func:`nls_to_numpy`); an
``AutoRecyclingGmres`` crosses as its timing table ``_tau``, its last
solve's internals and its records of chosen widths
(:func:`auto_state_to_numpy`, :func:`auto_state_from_numpy`), since it
chooses widths from measured walls, which two runs do not share.  The
data of a fused one-reduce deflation crosses as its numpy rows
(:func:`fused_deflation_from_numpy`).  A sketch of the sketched lane
crosses as its numpy factors ``S1``, ``S2`` and ``signs``
(:func:`kron_sketch_from_numpy`), since torch cannot redraw what
``jax.random`` drew.  The GMRES-polynomial preconditioner crosses as its
Leja-ordered roots (:func:`gmres_polynomial_from_numpy`), the DIA
operator as its ``(dia_data, offsets)`` (:func:`dia_from_numpy`), the
block-Jacobi preconditioner as its inverted blocks
(:func:`block_jacobi_from_numpy`, :func:`block_jacobi_to_numpy`) and a
sparse operator or SPAI inverse back as the scipy matrix it applies
(:func:`sparse_to_numpy`).  A solver of the
reference-compatible lane (``linsys``, ``deflation``) crosses back as its
results (:func:`compat_solver_to_numpy`): its inputs come as numpy
already, so nothing needs carrying in.

On a mesh the numpy value of a sharded JAX array crosses as the rank's
block (:func:`shard_from_numpy`, the layout of
:func:`krypy_tpu_torch.parallel.shard_vector`) and comes back whole
(:func:`gather_to_numpy`).
"""

import numpy as np
import torch

from . import parallel

__all__ = ["from_numpy", "to_numpy", "internals_from_numpy",
           "internals_to_numpy", "basis_from_numpy", "shard_from_numpy",
           "gather_to_numpy", "nls_to_numpy", "auto_state_to_numpy",
           "auto_state_from_numpy", "fused_deflation_from_numpy",
           "compat_solver_to_numpy", "kron_sketch_from_numpy",
           "gmres_polynomial_from_numpy", "dia_from_numpy",
           "block_jacobi_from_numpy", "block_jacobi_to_numpy",
           "sparse_to_numpy"]


def from_numpy(arr, device):
    """numpy array (or anything ``np.asarray`` takes) -> tensor on
    ``device``, same dtype."""
    return torch.tensor(np.asarray(arr), device=device)


def to_numpy(t):
    """Tensor -> numpy array on the host, same dtype."""
    return t.detach().cpu().resolve_conj().resolve_neg().numpy()


def internals_to_numpy(d):
    """A GMRES ``return_internal`` dictionary (with whatever a deflated
    solve or its caller added: ``E``, ``Uo``, ``AU``, ``niter``) as numpy
    arrays; ``None`` and plain Python numbers stay as they are.  The JAX
    package's ``ritz_deflation_vectors`` takes the result (it converts
    arrays itself)."""
    return {k: to_numpy(v) if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}


def internals_from_numpy(d, device):
    """The inverse: a dictionary of numpy (or JAX) arrays, e.g. the JAX
    solve's internals, as tensors on ``device`` for the port's
    ``ritz_deflation_vectors``.  The ``(N, d)`` bases ``Uo`` and ``AU``
    come out as views of contiguous ``(d, N)`` rows, the layout the port
    works in; ``None`` and plain Python numbers stay as they are."""
    out = {}
    for k, v in d.items():
        if v is None or isinstance(v, (bool, int, float)):
            out[k] = v
        elif k in ("Uo", "AU"):
            out[k] = basis_from_numpy(v, device)
        else:
            out[k] = from_numpy(v, device)
    return out


def basis_from_numpy(U, device):
    """A deflation basis ``(N, d)`` as a tensor on ``device``, same dtype
    and shape, stored as contiguous ``(d, N)`` rows (so that ``.T`` of it
    costs no copy)."""
    return from_numpy(np.ascontiguousarray(np.asarray(U).T), device).T


def shard_from_numpy(arr, mesh, axis=-1):
    """This rank's block of the numpy value of an array sharded along
    ``axis`` (the last by default: a vector or basis rows ``(m, N)``;
    ``axis=0`` for a deflation basis ``(N, d)``, which comes out as a view
    of contiguous ``(d, N/P)`` rows, as :func:`basis_from_numpy` lays it
    out), as a tensor on ``mesh.device``, same dtype."""
    rows = parallel.shard_vector(np.moveaxis(np.asarray(arr), axis, -1),
                                 mesh)
    return rows.movedim(-1, axis)


def gather_to_numpy(t, mesh, axis=-1):
    """The inverse of :func:`shard_from_numpy`: the whole array from every
    rank's block, as a numpy array.  Every rank must call it."""
    rows = t.movedim(axis, -1)
    flat = rows.reshape(-1, rows.shape[-1])
    whole = torch.stack([parallel.gather_vector(r.contiguous(), mesh)
                         for r in flat])
    return np.moveaxis(to_numpy(whole).reshape(*rows.shape[:-1], -1), -1,
                       axis)


def nls_to_numpy(F, ustar):
    """The state of the nonlinear-Schrödinger problem of
    ``ops.nls_residual_2d`` (the port's or the JAX package's) as numpy:
    ``{"ustar", "g"}``.  The source is read through ``F`` itself: ``F(0)
    = Lap 0 + kappa 0^3 - lam 0 - g`` is ``-g`` exactly."""
    def as_np(a):
        return to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)

    return {"ustar": as_np(ustar), "g": -as_np(F(ustar * 0))}


def auto_state_to_numpy(rec):
    """An ``AutoRecyclingGmres``'s (the port's or the JAX package's) state
    that decides its next width: ``{"tau", "internals", "selected_widths",
    "predicted_steps"}``, arrays as numpy."""
    ints = rec._last_internals
    if ints is not None:
        ints = {k: (to_numpy(v) if isinstance(v, torch.Tensor)
                    else v if v is None or isinstance(v, (bool, int, float))
                    else np.asarray(v))
                for k, v in ints.items()}
    return {"tau": dict(rec._tau), "internals": ints,
            "selected_widths": list(rec.selected_widths),
            "predicted_steps": list(rec.predicted_steps)}


def auto_state_from_numpy(rec, state, device, keys=("tau", "internals")):
    """Put ``state`` (:func:`auto_state_to_numpy`) into the port's
    ``AutoRecyclingGmres`` ``rec``, only the parts named in ``keys``;
    internals go to ``device``.  Returns ``rec``."""
    if "tau" in keys:
        rec._tau = dict(state["tau"])
    if "internals" in keys:
        ints = state["internals"]
        rec._last_internals = (None if ints is None
                               else internals_from_numpy(ints, device))
    if "selected_widths" in keys:
        rec.selected_widths = list(state["selected_widths"])
        rec.predicted_steps = list(state["predicted_steps"])
    return rec


def fused_deflation_from_numpy(UoT, W2T, G=None, *, device):
    """A :class:`~krypy_tpu_torch.functional.gmres.FusedDeflation` from
    the numpy values of its fields (the JAX package's ``FusedDeflation``
    carries the same three: ``(d, N)`` rows ``UoT`` and ``W2T``, the
    ``(d, d)`` coupling Gram ``G`` or None), as contiguous tensors on
    ``device``, same dtypes."""
    from .functional.gmres import FusedDeflation

    def rows(a):
        return from_numpy(np.ascontiguousarray(np.asarray(a)), device)

    return FusedDeflation(UoT=rows(UoT), W2T=rows(W2T),
                          G=None if G is None else rows(G))


#: the results of a compatibility-lane solver, as the JAX lane names them
COMPAT_RESULTS = ("xk", "resnorms", "errnorms", "V", "H", "P")


def compat_solver_to_numpy(solver):
    """The results of a ``linsys``/``deflation`` solver (plain, deflated or
    restarted) as numpy: ``xk``, ``resnorms``, ``errnorms``, ``V``, ``H``
    and ``P``; a result the solver does not carry (``errnorms`` without
    an exact solution, the Krylov data without ``store_arnoldi``) is
    ``None``.  The JAX lane's solver gives the same dictionary through
    ``np.asarray`` of each attribute."""
    out = {}
    for name in COMPAT_RESULTS:
        val = getattr(solver, name, None)
        if isinstance(val, torch.Tensor):
            val = to_numpy(val)
        elif val is not None:
            val = np.asarray(val)
        out[name] = val
    return out


def kron_sketch_from_numpy(S1, S2, signs, N=None, *, device):
    """A :class:`~krypy_tpu_torch.functional.sketch.KronSketch` from the
    JAX package's draw (its ``S1``, ``S2`` and ``signs`` as numpy; ``N``
    defaults to ``len(signs)``) on ``device``, same dtypes.  On a mesh the
    sketch stays whole on every rank."""
    from .functional.sketch import KronSketch

    signs = np.asarray(signs)
    return KronSketch(S1=from_numpy(S1, device), S2=from_numpy(S2, device),
                      signs=from_numpy(signs, device),
                      N=int(signs.shape[0] if N is None else N))


def gmres_polynomial_from_numpy(op, roots, complex_op=False):
    """The port's GMRES-polynomial preconditioner of ``op`` with the JAX
    preconditioner's ``.roots`` (Leja-ordered; ``complex_op`` as the JAX
    build decided it: a complex seed or basis)."""
    from .ops import _polynomial_from_roots

    return _polynomial_from_roots(op, np.asarray(roots),
                                  complex_op=complex_op,
                                  shape=getattr(op, "shape", None))


def dia_from_numpy(dia_data, offsets, scipy_matrix=None, *, device,
                   mesh=None):
    """The port's DIA operator from the JAX operator's ``.dia_data`` and
    ``.offsets`` (on ``device``, or the rank's block of ``mesh``)."""
    from .ops import _dia_from_numpy

    return _dia_from_numpy(dia_data, offsets, scipy_matrix, device, mesh)


def block_jacobi_from_numpy(blocks, N, *, device, mesh=None):
    """The port's block-Jacobi preconditioner from the JAX one's inverted
    ``.blocks`` ``(nb, bs, bs)`` of an ``N x N`` operator."""
    from .ops import _block_jacobi_from_blocks

    return _block_jacobi_from_blocks(np.asarray(blocks), N, device, mesh)


def block_jacobi_to_numpy(M):
    """A block-Jacobi preconditioner's inverted blocks as numpy."""
    return to_numpy(M.blocks)


def sparse_to_numpy(op):
    """The scipy matrix a CSR, DIA or SPAI operator applies (its
    ``.scipy_matrix``, else its device CSR read back)."""
    from .ops import _as_scipy_sparse

    return _as_scipy_sparse(op).tocsr()
