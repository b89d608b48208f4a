"""Solver cores of the PyTorch port (counterpart of
:mod:`krypy_tpu.functional`; ported so far: ``cg``, ``minres``,
``gmres`` (every ``ortho`` scheme, ``ip``, ``basis_dtype``,
``FusedDeflation``), ``restarted_gmres``, ``refine_to``, the deflation
module: ``deflated_gmres``, ``deflated_cg``, ``deflated_minres``, the
Ritz extraction, ``RecyclingGmres`` and ``AutoRecyclingGmres``,
``newton_krylov``, the mesh price model ``policy``, and the
nonsymmetric short recurrences ``bicgstab``, ``tfqmr``, ``qmr`` (with
``transpose_matvec``), ``idrs`` and the flexible ``fgmres``)."""

from . import policy
from .bicgstab import bicgstab
from .cg import cg
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
from .fgmres import fgmres
from .gmres import FusedDeflation, gmres, restarted_gmres
from .idr import idrs
from .minres import minres
from .newton import NewtonResult, newton_krylov
from .qmr import qmr, transpose_matvec
from .refine import refine_to
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
