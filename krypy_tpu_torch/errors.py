"""Exception hierarchy (counterpart of :mod:`krypy_tpu.errors`, with the
same six names, so that user code that catches them ports over
unchanged).

The solver cores report status codes; the host-side classes translate
them into these exceptions.
"""

__all__ = [
    "ArgumentError",
    "AssumptionError",
    "ConvergenceError",
    "LinearOperatorError",
    "InnerProductError",
    "RuntimeError",
]


class ArgumentError(Exception):
    """An argument is invalid (krypy analogue of ValueError)."""


class AssumptionError(Exception):
    """All arguments are valid but a mathematical assumption is violated,
    so the requested result cannot be computed."""


class ConvergenceError(Exception):
    """A method did not converge.

    Carries the solver instance in ``self.solver`` so the caller can
    recover the last iterate and the residual history.
    """

    def __init__(self, msg, solver):
        super().__init__(msg)
        self.solver = solver


class LinearOperatorError(Exception):
    """A LinearOperator cannot be constructed or applied."""


class InnerProductError(Exception):
    """The provided inner product appears to be indefinite."""


class RuntimeError(Exception):  # noqa: A001 - mirrors the reference name
    """Errors that fit no other category."""
