"""Hand-written CUDA kernels of the PyTorch port (built from ``csrc/`` at
first use; see :mod:`krypy_tpu_torch.kernels._build`)."""

from ._launch import launch_counts, reset_launch_counts
from .orthogonalize import (
    apply_project,
    cgs2_fused,
    cgs_project,
    project_prefix,
    update_prefix,
)
from .stencil import (
    laplacian_2d,
    laplacian_2d_kernel,
    laplacian_2d_pipelined,
    stencil5_affine,
    stencil5_jacobi2,
    stencil5_pipelined,
    stencil5_resrestrict_rows,
)

__all__ = [
    "stencil5_affine",
    "stencil5_jacobi2",
    "stencil5_resrestrict_rows",
    "stencil5_pipelined",
    "laplacian_2d_pipelined",
    "laplacian_2d_kernel",
    "laplacian_2d",
    "project_prefix",
    "apply_project",
    "update_prefix",
    "cgs2_fused",
    "cgs_project",
    "launch_counts",
    "reset_launch_counts",
]
