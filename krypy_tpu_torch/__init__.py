"""krypy_tpu_torch: the PyTorch and CUDA port of krypy_tpu.

The JAX package ``krypy_tpu`` is the reference: every module here mirrors
its namesake there and is tested against it on the same inputs.  This
package imports ``torch`` and never ``jax``.  Ported so far: the
multigrid-CG slice (``functional.cg``, ``functional.refine_to``, the
grid-padded Poisson operator and V-cycle in ``ops``) and its three CUDA
stencil kernels (``kernels``).
"""

from . import config  # noqa: F401  (full-f32 matmul defaults at import)
from . import functional, kernels, ops

__version__ = "0.1.0"

__all__ = ["functional", "kernels", "ops", "__version__"]
