"""Mixed-precision iterative refinement (counterpart of
:mod:`krypy_tpu.functional.refine`).

The outer loop computes the TRUE residual in float64, a lower-precision
inner solver produces a correction, and each cycle multiplies the
residual by roughly the inner solve's reduction factor.

Both forms run as host loops that read one scalar, the outer relative
residual, per cycle.  ``compiled=True`` keeps the JAX package's compiled
semantics (its while-loop stop rule and best-iterate bookkeeping) and its
hidden warm-up solve, so that kernel builds and first launches stay out
of ``wall_s``.
"""

import time

import torch

from ..parallel import active_mesh
from .common import CONVERGED, MAXITER, SolveResult

__all__ = ["refine_to"]

#: warmed (operator, inner solver, tol, max_cycles, N, dtype) entries of
#: the compiled form; each value keeps its id()-keyed objects alive
_WARMED = {}
_WARMED_MAX = 16


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _initial(b, x0):
    b64 = b.reshape(-1).to(torch.float64)
    x = (torch.zeros_like(b64) if x0 is None
         else x0.reshape(-1).to(torch.float64))
    return b64, x


def _refine_loop(A64, b64, x, inner_solve, tol, max_cycles, inner_dtype):
    """The compiled form's loop: stop on ``rel <= tol``, on
    ``max_cycles`` corrections, or on a cycle that does not improve."""
    bnorm = float(torch.linalg.vector_norm(b64))

    def rel_of(r):
        return float(torch.linalg.vector_norm(r)) / bnorm if bnorm > 0 \
            else 0.0

    r = b64 - A64(x)
    rel = rel_of(r)
    hist = [rel]
    best_rel, best_x = rel, x
    prev = float("inf")
    j = 0
    inner_iters = 0
    while rel > tol and j < max_cycles and rel < prev:
        res = inner_solve(r.to(inner_dtype))
        x = x + res.x.reshape(-1).to(torch.float64)
        r = b64 - A64(x)
        prev, rel = rel, rel_of(r)
        hist.append(rel)
        if rel < best_rel:
            best_rel, best_x = rel, x
        inner_iters += int(res.niter)
        j += 1
    return best_x, hist, j, inner_iters, best_rel


def _refine_to_compiled(A64, b, inner_solve, *, tol, max_cycles, x0,
                        inner_dtype, warm=True):
    b64, x_init = _initial(b, x0)
    key = (id(A64), id(inner_solve), float(tol), int(max_cycles),
           b64.shape[0], str(inner_dtype))
    warm_s = 0.0
    if warm and key not in _WARMED:
        tw = time.perf_counter()
        _refine_loop(A64, b64, x_init, inner_solve, tol, max_cycles,
                     inner_dtype)
        _sync(b64)
        warm_s = time.perf_counter() - tw
        if len(_WARMED) >= _WARMED_MAX:
            _WARMED.pop(next(iter(_WARMED)))
        _WARMED[key] = (A64, inner_solve)

    t0 = time.perf_counter()
    bx, hist, cycles, inner_iters, best_rel = _refine_loop(
        A64, b64, x_init, inner_solve, tol, max_cycles, inner_dtype
    )
    _sync(bx)
    wall = time.perf_counter() - t0

    status = CONVERGED if best_rel <= tol else MAXITER
    dev = b64.device
    result = SolveResult(
        x=bx,
        resnorms=torch.tensor(hist, dtype=torch.float64, device=dev),
        niter=torch.tensor(cycles, dtype=torch.int64, device=dev),
        status=torch.tensor(status, dtype=torch.int64, device=dev),
    )
    return result, {
        "cycles": cycles,
        "inner_iters": inner_iters,
        "wall_s": wall,
        "warm_s": warm_s,
    }


def refine_to(
    A64,
    b,
    inner_solve,
    *,
    tol=1e-8,
    max_cycles=20,
    x0=None,
    inner_dtype=torch.float32,
    compiled=False,
    warm=True,
):
    """Solve ``A x = b`` to float64 relative residual ``tol`` by iterative
    refinement around a lower-precision inner solver.

    :param A64: float64-capable matvec callable (its dtype follows the
      input vector, as the operators in :mod:`krypy_tpu_torch.ops` do).
    :param b: right-hand side (promoted to float64 for the outer loop).
    :param inner_solve: callable ``r_low -> SolveResult`` whose ``x`` is
      the correction for the residual ``r_low``.
    :param tol: target float64 relative residual.
    :param max_cycles: refinement cycle cap.
    :param x0: optional initial guess.
    :param inner_dtype: dtype the residual is cast to for the inner solve.
    :param compiled: use the JAX package's compiled-form semantics (stop
      as soon as a cycle fails to improve; hidden warm-up solve on the
      first call for each operator/solver pair, reported as
      ``info['warm_s']``).
    :param warm: compiled form only: run the warm-up solve (default True).
    :return: ``(SolveResult, info)``; the result carries the float64 best
      iterate and the per-cycle outer residuals, ``info`` has ``cycles``,
      ``inner_iters`` and ``wall_s`` (and ``warm_s`` when compiled).

    Under an active mesh it raises ``NotImplementedError``: its outer
    norms are not sharded yet (ROADMAP.md queue A, slice 5).
    """
    if active_mesh() is not None:
        raise NotImplementedError(
            "refine_to on a mesh is not ported yet (ROADMAP.md queue A, "
            "slice 5)")
    if compiled:
        return _refine_to_compiled(
            A64, b, inner_solve, tol=tol, max_cycles=max_cycles, x0=x0,
            inner_dtype=inner_dtype, warm=warm,
        )
    b64, x = _initial(b, x0)
    bnorm = float(torch.linalg.vector_norm(b64))
    # warm the outer residual before the timer starts
    float(torch.linalg.vector_norm(b64 - A64(x)))
    t0 = time.perf_counter()
    outer = []
    inner_iters = 0
    best_x, best_rel = x, float("inf")
    # max_cycles + 1 residual evaluations bracket max_cycles corrections,
    # so the final correction is always measured (and can win best_x)
    for cycle in range(max_cycles + 1):
        r = b64 - A64(x)
        rel = float(torch.linalg.vector_norm(r)) / bnorm if bnorm else 0.0
        outer.append(rel)
        if rel < best_rel:
            best_x, best_rel = x, rel
        if (rel <= tol or cycle == max_cycles
                or (len(outer) > 1 and rel >= outer[-2])):
            break
        res = inner_solve(r.to(inner_dtype))
        inner_iters += int(res.niter)
        x = x + res.x.reshape(-1).to(torch.float64)
    wall = time.perf_counter() - t0

    status = CONVERGED if best_rel <= tol else MAXITER
    dev = b64.device
    result = SolveResult(
        x=best_x,
        resnorms=torch.tensor(outer, dtype=torch.float64, device=dev),
        niter=torch.tensor(len(outer) - 1, dtype=torch.int64, device=dev),
        status=torch.tensor(status, dtype=torch.int64, device=dev),
    )
    return result, {
        "cycles": len(outer) - 1,
        "inner_iters": inner_iters,
        "wall_s": wall,
    }
