"""krypy_tpu_torch.utils -- the reference-compatible utility surface
(counterpart of :mod:`krypy_tpu.utils`, with the same names).

The implementations live in the focused submodules
:mod:`krypy_tpu_torch.core`, :mod:`krypy_tpu_torch.arnoldi` and
:mod:`krypy_tpu_torch.spectral`.
"""

from ..errors import (
    ArgumentError,
    AssumptionError,
    ConvergenceError,
    InnerProductError,
    LinearOperatorError,
    RuntimeError,
)
from ..core.dtypes import find_common_dtype, shape_vec, shape_vecs
from ..core.operators import (
    DiagonalLinearOperator,
    FunctionLinearOperator,
    IdentityLinearOperator,
    LinearOperator,
    MatrixLinearOperator,
    TimedLinearOperator,
    ZeroLinearOperator,
    get_linearoperator,
)
from ..core.products import (
    inner,
    ip_euclid,
    norm,
    norm_MMlr,
    norm_squared,
    orthonormality,
)
from ..core.qr import qr
from ..core.projections import Projection
from ..core.rotations import Givens, House, givens_coeffs, house_vector
from ..core.timers import Timer, Timings
from ..arnoldi import Arnoldi, arnoldi, arnoldi_projected, arnoldi_res
from ..spectral import (
    BoundCG,
    BoundMinres,
    Interval,
    Intervals,
    NormalizedRootsPolynomial,
    angles,
    bound_perturbed_gmres,
    gap,
    get_residual_norms,
    hegedus,
    ritz,
    strakos,
)

__all__ = [
    "ArgumentError",
    "AssumptionError",
    "ConvergenceError",
    "LinearOperatorError",
    "InnerProductError",
    "RuntimeError",
    "Arnoldi",
    "BoundCG",
    "BoundMinres",
    "Givens",
    "House",
    "DiagonalLinearOperator",
    "FunctionLinearOperator",
    "IdentityLinearOperator",
    "LinearOperator",
    "MatrixLinearOperator",
    "TimedLinearOperator",
    "ZeroLinearOperator",
    "NormalizedRootsPolynomial",
    "Projection",
    "Interval",
    "Intervals",
    "Timer",
    "Timings",
    "angles",
    "arnoldi",
    "arnoldi_res",
    "arnoldi_projected",
    "bound_perturbed_gmres",
    "find_common_dtype",
    "gap",
    "get_linearoperator",
    "get_residual_norms",
    "givens_coeffs",
    "hegedus",
    "house_vector",
    "inner",
    "ip_euclid",
    "norm",
    "norm_MMlr",
    "norm_squared",
    "orthonormality",
    "qr",
    "ritz",
    "shape_vec",
    "shape_vecs",
    "strakos",
]
