"""Wall-clock timing instrumentation (counterpart of
:mod:`krypy_tpu.core.timers`).

The timed quantities are whole calls, synchronised with the device by
the caller (see :class:`~krypy_tpu_torch.core.operators.
TimedLinearOperator`).  The recycling evaluators combine these
measurements with per-solver operation counts to predict the wall-clock
cost of candidate deflation subspaces.
"""

import time
from collections import defaultdict

__all__ = ["Timer", "Timings"]


class Timer(list):
    """A list of elapsed times; use as a context manager to append one."""

    def __enter__(self):
        self._tstart = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.append(time.perf_counter() - self._tstart)


class Timings(defaultdict):
    """defaultdict of :class:`Timer` keyed by operation name."""

    def __init__(self):
        super().__init__(Timer)

    def get(self, key):
        """Minimum recorded time for ``key`` (robust to noise), 0 if absent."""
        if key in self and len(self[key]) > 0:
            return min(self[key])
        return 0

    def get_ops(self, ops):
        """Dot product of a cost model ``{op: count}`` with measured times."""
        return sum(self.get(op) * count for op, count in ops.items())

    def __repr__(self):
        inner = ", ".join(f"{key}: {self.get(key)}" for key in self)
        return f"Timings({inner})"
