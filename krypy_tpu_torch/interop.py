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
(:func:`fused_deflation_from_numpy`).

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
           "auto_state_from_numpy", "fused_deflation_from_numpy"]


def from_numpy(arr, device):
    """numpy array (or anything ``np.asarray`` takes) -> tensor on
    ``device``, same dtype."""
    return torch.tensor(np.asarray(arr), device=device)


def to_numpy(t):
    """Tensor -> numpy array on the host, same dtype."""
    return t.detach().cpu().numpy()


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
