"""Recycling Krylov solvers for sequences of linear systems (counterpart
of :mod:`krypy_tpu.recycling`)."""

from . import evaluators, factories, generators  # noqa: F401
from .linsys import (FACTORY_SHORTCUTS, RecyclingCg,  # noqa: F401
                     RecyclingGmres, RecyclingMinres)

__all__ = [
    "RecyclingCg",
    "RecyclingMinres",
    "RecyclingGmres",
    "evaluators",
    "factories",
    "generators",
]
