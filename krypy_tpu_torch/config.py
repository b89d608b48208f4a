"""Global numerical configuration for krypy_tpu_torch.

Counterpart of :mod:`krypy_tpu.config`.  torch always has float64, so the
JAX package's x64 toggle has no counterpart here: arrays keep the dtype
they are created with, and every tensor the port creates names its dtype.

A numerics library must not trade digits silently, so full float32 is the
import-time default for the two places where PyTorch may otherwise use
TF32 on an NVIDIA card: float32 matrix products and cuDNN convolutions
(TF32 keeps about three decimal digits).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_float():
    """The widest available real floating dtype."""
    return torch.float64


def invariance_threshold(dtype) -> float:
    """Relative breakdown threshold for invariance detection: 45 eps of
    ``dtype`` (1e-14 in float64, the reference's krypy/utils.py value)."""
    return float(45 * torch.finfo(dtype).eps)
