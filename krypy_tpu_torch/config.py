"""Global numerical configuration for krypy_tpu_torch.

Counterpart of :mod:`krypy_tpu.config`.  torch always has float64, so the
JAX package's x64 toggle is always on here (:func:`x64_enabled`): arrays
keep the dtype they are created with, and every tensor the port creates
names its dtype.

A numerics library must not trade digits silently, so full float32 is the
import-time default for the two places where PyTorch may otherwise use
TF32 on an NVIDIA card: float32 matrix products and cuDNN convolutions
(TF32 keeps about three decimal digits).  Likewise a bfloat16 matrix
product (the products of a bfloat16 Krylov basis, ``basis_dtype=``) may
not reduce in bfloat16: its sums stay in float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.set_float32_matmul_precision("highest")


def x64_enabled() -> bool:
    """Always True: torch has float64 without a switch (the JAX package
    answers False only where ``KRYPY_TPU_X64=0`` was set at import)."""
    return True


def default_float():
    """The widest available real floating dtype."""
    return torch.float64


def default_complex():
    """The widest available complex floating dtype."""
    return torch.complex128


def invariance_threshold(dtype) -> float:
    """Relative breakdown threshold for invariance detection: 45 eps of
    ``dtype`` (1e-14 in float64, the reference's krypy/utils.py value)."""
    return float(45 * torch.finfo(dtype).eps)
