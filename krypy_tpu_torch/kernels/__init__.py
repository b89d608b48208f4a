"""Hand-written CUDA kernels of the PyTorch port (built from ``csrc/`` at
first use; see :mod:`krypy_tpu_torch.kernels._build`)."""

from .stencil import (
    launch_counts,
    reset_launch_counts,
    stencil5_affine,
    stencil5_jacobi2,
    stencil5_resrestrict_rows,
)

__all__ = [
    "stencil5_affine",
    "stencil5_jacobi2",
    "stencil5_resrestrict_rows",
    "launch_counts",
    "reset_launch_counts",
]
