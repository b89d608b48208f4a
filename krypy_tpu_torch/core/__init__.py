"""Core numerical building blocks (counterpart of :mod:`krypy_tpu.core`):
dtypes, operators, inner products, projections, QR, rotations and
timers."""

from . import (dtypes, operators, products, projections, qr,  # noqa: F401
               rotations, timers)
