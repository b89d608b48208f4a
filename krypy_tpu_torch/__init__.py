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
recycling inside ``with mesh:``), BASELINE configs 1-3 (``suite``:
``functional.minres``/``deflated_minres``, the unpadded V-cycle, K1 at
every level), and BASELINE config 5 (``suite.config5_nls_newton_recycling``:
``functional.newton_krylov`` over ``torch.func.jvp`` with K1's
forward-mode rule, ``functional.AutoRecyclingGmres``,
``ops.nls_residual_2d``, the ``spectral`` module and the ``core``
subpackage: dtypes, operators, inner products, QR, rotations, timers),
and the one-reduce lane (``variant="1r"`` of CG and MINRES, every
``ortho`` of GMRES with ``cgs2_1r``, ``ip``, the bfloat16 basis,
``functional.FusedDeflation`` and the mesh price model
``functional.policy``).
"""

from . import config  # noqa: F401  (full-f32 matmul defaults at import)
from . import (core, errors, functional, kernels, northstar, ops, parallel,
               spectral, suite)

__version__ = "0.1.0"

__all__ = ["core", "errors", "functional", "kernels", "northstar", "ops",
           "parallel", "spectral", "suite", "__version__"]
