"""Core numerical building blocks (counterpart of :mod:`krypy_tpu.core`):
dtypes, operators, inner products, QR, rotations and timers.
``projections`` is not ported yet (ROADMAP.md queue A, A9)."""

from . import dtypes, operators, products, qr, rotations, timers  # noqa: F401
