"""krypy_tpu_torch: the PyTorch and CUDA port of krypy_tpu.

The JAX package ``krypy_tpu`` is the reference: every module here mirrors
its namesake there and is tested against it on the same inputs.  This
package imports ``torch`` and never ``jax``.  Ported so far: the
multigrid-CG slice (``functional.cg``, ``functional.refine_to``, the
grid-padded Poisson operator and V-cycle in ``ops``), the north-star
restarted-GMRES slice (``functional.gmres``/``restarted_gmres``,
``ops.convection_diffusion_2d``, the pipeline in ``northstar``), the
deflation slice (``functional.deflated_gmres``, the Ritz extraction,
``functional.RecyclingGmres``, ``ops.shifted_laplacian_2d``, the pipeline
in ``suite``), their seven CUDA kernels (``kernels``: three stencil
kernels, three prefix-sweep CGS2 kernels, the ``cgs_project`` pass), and
the multi-device path (``parallel``: meshes over ``torch.distributed``;
the stencil operators' ``mesh=``; the sharded stencil and fused CGS2,
K8 and K9, on those kernels per shard; CG, GMRES, deflation and
recycling inside ``with mesh:``).
"""

from . import config  # noqa: F401  (full-f32 matmul defaults at import)
from . import functional, kernels, northstar, ops, parallel, suite

__version__ = "0.1.0"

__all__ = ["functional", "kernels", "northstar", "ops", "parallel", "suite",
           "__version__"]
