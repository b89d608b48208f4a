"""Hand-written CUDA kernels of the PyTorch port (built from ``csrc/`` at
first use; see :mod:`krypy_tpu_torch.kernels._build`)."""

from ._launch import launch_counts, reset_launch_counts, tangent_counts
from .orthogonalize import (
    apply_project,
    cgs2_fused,
    cgs2_fused_blocks,
    cgs2_fused_sharded,
    cgs_project,
    cgs_project_blocks,
    project_prefix,
    update_prefix,
)
from .stencil import (
    laplacian_2d,
    laplacian_2d_kernel,
    laplacian_2d_pipelined,
    stencil5_affine,
    stencil5_coarse,
    stencil5_halo,
    stencil5_jacobi2,
    stencil5_pipelined,
    stencil5_resrestrict_rows,
    stencil5_sharded,
)

__all__ = [
    "stencil5_affine",
    "stencil5_coarse",
    "stencil5_jacobi2",
    "stencil5_resrestrict_rows",
    "stencil5_pipelined",
    "laplacian_2d_pipelined",
    "laplacian_2d_kernel",
    "laplacian_2d",
    "stencil5_sharded",
    "stencil5_halo",
    "project_prefix",
    "apply_project",
    "update_prefix",
    "cgs2_fused",
    "cgs2_fused_sharded",
    "cgs2_fused_blocks",
    "cgs_project",
    "cgs_project_blocks",
    "launch_counts",
    "reset_launch_counts",
    "tangent_counts",
]
