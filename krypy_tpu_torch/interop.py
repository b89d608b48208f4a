"""Moving state between the JAX package and the port.

A solver has no weights: the only state that crosses between the two
packages is vectors (right-hand sides, initial guesses, residuals) and
operator coefficients.  Vectors cross as numpy arrays with their dtype
kept.  Operators cross by calling the port's constructor with the same
arguments as the JAX one (``nx``, ``pad_cols``, ``coarsest``,
``coarse_sweeps``, ...), since the JAX operators are closures whose only
state is those arguments.
"""

import numpy as np
import torch

__all__ = ["from_numpy", "to_numpy"]


def from_numpy(arr, device):
    """numpy array (or anything ``np.asarray`` takes) -> tensor on
    ``device``, same dtype."""
    return torch.tensor(np.asarray(arr), device=device)


def to_numpy(t):
    """Tensor -> numpy array on the host, same dtype."""
    return t.detach().cpu().numpy()
