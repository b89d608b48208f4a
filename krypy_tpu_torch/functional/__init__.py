"""Solver cores of the PyTorch port (counterpart of
:mod:`krypy_tpu.functional`; ported so far: ``cg``, ``gmres``,
``restarted_gmres`` and ``refine_to``)."""

from .cg import cg
from .common import BREAKDOWN, CONVERGED, MAXITER, SolveResult
from .gmres import gmres, restarted_gmres
from .refine import refine_to

__all__ = ["cg", "gmres", "restarted_gmres", "refine_to", "SolveResult",
           "CONVERGED", "MAXITER", "BREAKDOWN"]
