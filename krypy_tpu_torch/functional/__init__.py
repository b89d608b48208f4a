"""Solver cores of the PyTorch port (counterpart of
:mod:`krypy_tpu.functional`; this slice ports ``cg`` and ``refine_to``)."""

from .cg import cg
from .common import BREAKDOWN, CONVERGED, MAXITER, SolveResult
from .refine import refine_to

__all__ = ["cg", "refine_to", "SolveResult", "CONVERGED", "MAXITER",
           "BREAKDOWN"]
