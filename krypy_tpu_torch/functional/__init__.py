"""Solver cores of the PyTorch port (counterpart of
:mod:`krypy_tpu.functional`; ported so far: ``cg``, ``minres``,
``gmres`` (every ``ortho`` scheme, ``ip``, ``basis_dtype``,
``FusedDeflation``), ``restarted_gmres``, ``refine_to``, the deflation
module: ``deflated_gmres``, ``deflated_cg``, ``deflated_minres``, the
Ritz extraction, ``RecyclingGmres`` and ``AutoRecyclingGmres``,
``newton_krylov``, the mesh price model ``policy``, and the
nonsymmetric short recurrences ``bicgstab``, ``tfqmr``, ``qmr`` (with
``transpose_matvec``), ``idrs`` and the flexible ``fgmres``, and the
eigensolvers ``eigsh``, ``eigs``, ``lobpcg`` and the filtered window
lane ``eigsh_window``, ``window_count``, ``kpm_dos``,
``estimate_spectrum_bounds``, ``jackson_cheby_coeffs``, the
least-squares solvers ``lsqr`` and ``lsmr``, the randomized ``rsvd``,
``hutchpp`` and ``nystrom_preconditioner``, ``svds``, the Arnoldi
relation builder ``arnoldi``, the multi-shift ``shifted_cg``,
``shifted_gmres`` and ``restarted_shifted_gmres``, Chebyshev iteration
``chebyshev`` with ``spectral_bounds``, the matrix functions
``funm_krylov``, ``funm_krylov_arnoldi``, ``expm_multiply``,
``inv_sqrt_multiply``, ``slq_trace`` and ``slq_logdet``, the block
solvers ``block_cg`` and ``block_gmres``, and the sketched lane
``KronSketch``, ``kron_sketch``, ``sketch_apply``, ``sketched_gmres``,
``restarted_sketched_gmres`` and ``sketched_eigs``, and the s-step lane
``ca_cg``, ``ca_gmres``, ``restarted_ca_gmres``, ``newton_shifts`` and
``modified_leja``: every name of the JAX package's namespace)."""

from . import policy
from .arnoldi import ArnoldiResult, arnoldi
from .bicgstab import bicgstab
from .block import block_cg, block_gmres
from .cg import cg
from .chebyshev import chebyshev, spectral_bounds
from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    as_matvec,
    make_inner,
)
from .deflation import (
    AutoRecyclingGmres,
    RecyclingGmres,
    assemble_ritz_vectors,
    deflated_cg,
    deflated_gmres,
    deflated_minres,
    ritz_deflation_vectors,
    ritz_pairs,
    weighted_qr,
)
from .eigh import EigshResult, eigsh
from .eigs import EigsResult, eigs
from .fgmres import fgmres
from .funm import (
    expm_multiply,
    funm_krylov,
    funm_krylov_arnoldi,
    inv_sqrt_multiply,
    slq_logdet,
    slq_trace,
)
from .filtered import (
    WindowResult,
    eigsh_window,
    estimate_spectrum_bounds,
    jackson_cheby_coeffs,
    kpm_dos,
    window_count,
)
from .gmres import FusedDeflation, gmres, restarted_gmres
from .idr import idrs
from .lobpcg import LobpcgResult, lobpcg
from .lsq import lsmr, lsqr
from .minres import minres
from .newton import NewtonResult, newton_krylov
from .qmr import qmr, transpose_matvec
from .randomized import RsvdResult, hutchpp, nystrom_preconditioner, rsvd
from .refine import refine_to
from .sketch import (
    KronSketch,
    SketchedSolveResult,
    kron_sketch,
    restarted_sketched_gmres,
    sketch_apply,
    sketched_eigs,
    sketched_gmres,
)
from .shifted import (
    ShiftedResult,
    restarted_shifted_gmres,
    shifted_cg,
    shifted_gmres,
)
from .sstep import (
    ca_cg,
    ca_gmres,
    modified_leja,
    newton_shifts,
    restarted_ca_gmres,
)
from .svd import SvdsResult, svds
from .tfqmr import tfqmr

__all__ = [
    "cg",
    "minres",
    "gmres",
    "restarted_gmres",
    "FusedDeflation",
    "policy",
    "refine_to",
    "deflated_gmres",
    "deflated_cg",
    "deflated_minres",
    "RecyclingGmres",
    "AutoRecyclingGmres",
    "newton_krylov",
    "bicgstab",
    "tfqmr",
    "qmr",
    "transpose_matvec",
    "idrs",
    "fgmres",
    "eigsh",
    "EigshResult",
    "eigs",
    "EigsResult",
    "eigsh_window",
    "WindowResult",
    "window_count",
    "kpm_dos",
    "estimate_spectrum_bounds",
    "jackson_cheby_coeffs",
    "lobpcg",
    "LobpcgResult",
    "lsqr",
    "lsmr",
    "RsvdResult",
    "rsvd",
    "nystrom_preconditioner",
    "hutchpp",
    "svds",
    "SvdsResult",
    "arnoldi",
    "ArnoldiResult",
    "shifted_cg",
    "shifted_gmres",
    "restarted_shifted_gmres",
    "ShiftedResult",
    "chebyshev",
    "spectral_bounds",
    "funm_krylov",
    "funm_krylov_arnoldi",
    "expm_multiply",
    "inv_sqrt_multiply",
    "slq_trace",
    "slq_logdet",
    "block_cg",
    "block_gmres",
    "KronSketch",
    "SketchedSolveResult",
    "kron_sketch",
    "sketch_apply",
    "sketched_gmres",
    "restarted_sketched_gmres",
    "sketched_eigs",
    "ca_cg",
    "ca_gmres",
    "restarted_ca_gmres",
    "newton_shifts",
    "modified_leja",
    "NewtonResult",
    "ritz_deflation_vectors",
    "ritz_pairs",
    "assemble_ritz_vectors",
    "weighted_qr",
    "SolveResult",
    "CONVERGED",
    "MAXITER",
    "BREAKDOWN",
    "as_matvec",
    "make_inner",
]
