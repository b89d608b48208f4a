"""Solver cores of the PyTorch port (counterpart of
:mod:`krypy_tpu.functional`; ported so far: ``cg``, ``gmres``,
``restarted_gmres``, ``refine_to`` and the deflation module:
``deflated_gmres``, ``deflated_cg``, the Ritz extraction and
``RecyclingGmres``)."""

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
from .gmres import gmres, restarted_gmres
from .refine import refine_to

__all__ = [
    "cg",
    "gmres",
    "restarted_gmres",
    "refine_to",
    "deflated_gmres",
    "deflated_cg",
    "deflated_minres",
    "RecyclingGmres",
    "AutoRecyclingGmres",
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
