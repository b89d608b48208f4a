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
"""

import numpy as np
import torch

__all__ = ["from_numpy", "to_numpy", "internals_from_numpy",
           "internals_to_numpy", "basis_from_numpy"]


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
