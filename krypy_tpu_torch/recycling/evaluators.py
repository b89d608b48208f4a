"""Subset evaluators: price a candidate deflation subspace in predicted
wall-clock seconds for the *next* solve (counterpart of
:mod:`krypy_tpu_torch.recycling.evaluators`).

An evaluator maps
``(ritz, subset)`` to seconds, combining a predicted iteration count with
the measured per-operation timings through
:meth:`~krypy_tpu_torch.deflation._DeflationMixin.estimate_time` -- the
timing-to-decision feedback loop of the recycling machinery.  Candidates
whose prediction premises fail raise :class:`AssumptionError`, which the
factories treat as "skip this candidate".

Two pricing strategies:

* :class:`RitzApriori` -- pure theory: an a-priori convergence bound on
  the Ritz values that are *kept* (not deflated).
* :class:`RitzApproxKrylov` -- simulation: predict the actual residual
  curve with the :class:`~krypy_tpu_torch.deflation.Arnoldifyer` machinery.
"""

import warnings

import numpy as np

from .. import deflation, utils
from ..errors import ArgumentError, AssumptionError

__all__ = ["RitzApriori", "RitzApproxKrylov"]


class _RitzSubsetEvaluator:
    """Interface: :meth:`evaluate` prices a subset in predicted seconds."""

    def evaluate(self, ritz, subset):
        raise NotImplementedError("subclasses implement evaluate()")


def _split_indices(ritz, subset):
    """Deterministically ordered (deflated, kept) index lists."""
    chosen = sorted(subset)
    kept = sorted(set(range(len(ritz.values))) - set(subset))
    return chosen, kept


class RitzApriori(_RitzSubsetEvaluator):
    """Price a subset with an a-priori residual bound on the kept Ritz
    values (reference semantics: krypy/recycling/evaluators.py:13-134).

    :param Bound: :class:`~krypy_tpu_torch.utils.BoundCG` or
      :class:`~krypy_tpu_torch.utils.BoundMinres`.
    :param tol: target tolerance (default: the last solver's).
    :param strategy: ``'simple'`` feeds the kept Ritz values to the bound
      directly; ``'intervals'`` first inflates them to eigenvalue inclusion
      intervals derived from the Ritz residuals and the spectral gap.
    :param deflweight: weight of the deflation-overhead term in the time
      estimate.
    """

    def __init__(self, Bound, tol=None, strategy="simple", deflweight=1.0):
        self.Bound = Bound
        self.tol = tol
        self.strategy = strategy
        self.deflweight = deflweight

    def evaluate(self, ritz, subset):
        solver = ritz._deflated_solver
        if not solver.linear_system.self_adjoint:
            warnings.warn(
                "a-priori bounds assume a self-adjoint operator; the "
                "linear system is not flagged self_adjoint, so the "
                "prediction may be meaningless."
            )
        tol = solver.tol if self.tol is None else self.tol
        chosen, kept = _split_indices(ritz, subset)

        if self.strategy == "simple":
            spectrum = ritz.values[kept]
        elif self.strategy == "intervals":
            spectrum = self._inclusion_intervals(ritz, chosen, kept)
        else:
            raise ArgumentError(
                f"unknown strategy {self.strategy!r}; choose 'simple' or "
                "'intervals'"
            )
        nsteps = self.Bound(spectrum).get_step(tol)
        return solver.estimate_time(
            nsteps, len(chosen), deflweight=self.deflweight
        )

    @staticmethod
    def _inclusion_intervals(
        ritz, chosen, kept, eps_min=0, eps_max=0, eps_res=None
    ):
        """Inclusion intervals for the eigenvalues behind the *kept* Ritz
        values.

        Each kept eigenvalue is trapped within ``spread`` of its Ritz
        value, where ``spread`` combines the chosen pairs' residuals with
        their separation from the kept values (eigenvalue inclusion
        theorem + gap heuristic; reference semantics:
        krypy/recycling/evaluators.py:99-134).  ``eps_*`` model an
        additional operator perturbation.
        """
        if not chosen:
            # nothing deflated: fall back to plain residual intervals
            return utils.Intervals(
                [
                    utils.Interval(v - r, v + r)
                    for v, r in zip(ritz.values, ritz.resnorms)
                ]
            )
        if not kept:
            raise AssumptionError(
                "cannot build inclusion intervals when every Ritz pair "
                "is deflated"
            )
        if eps_res is None:
            eps_res = max(abs(eps_min), abs(eps_max))

        res_chosen = np.linalg.norm(ritz.resnorms[chosen], 2)
        separation = utils.gap(ritz.values[chosen], ritz.values[kept])
        if res_chosen + eps_max - eps_min >= separation:
            raise AssumptionError(
                "chosen Ritz pairs are not separated well enough from the "
                f"kept ones (residual {res_chosen:.3e} vs gap "
                f"{separation:.3e})"
            )
        chosen_bands = utils.Intervals(
            [
                utils.Interval(v + eps_min, v + eps_max)
                for v in ritz.values[chosen]
            ]
        )
        closest_to_zero = chosen_bands.min_abs()
        if closest_to_zero == 0:
            raise AssumptionError(
                "a chosen Ritz interval touches zero; the inclusion "
                "estimate degenerates"
            )

        spread = (res_chosen + eps_res) ** 2 * (
            1.0 / (separation - eps_max + eps_min) + 1.0 / closest_to_zero
        )
        return utils.Intervals(
            [
                utils.Interval(v + eps_min - spread, v + eps_max + spread)
                for v in ritz.values[kept]
            ]
        )


class RitzApproxKrylov(_RitzSubsetEvaluator):
    """Price a subset by simulating the next solve: predict its residual
    curve via :class:`~krypy_tpu_torch.deflation.Arnoldifyer` +
    :func:`~krypy_tpu_torch.deflation.bound_pseudo`, then convert the curve to an
    iteration count (reference semantics:
    krypy/recycling/evaluators.py:137-238).

    :param mode: ``'extrapolate'`` fits the worst geometric rate along the
      predicted curve; ``'direct'`` counts the predicted steps above tol.
    :param pseudospectra: include pseudospectral perturbation terms in the
      curve prediction (slower, sharper for nonnormal problems).
    """

    def __init__(
        self,
        mode="extrapolate",
        tol=None,
        pseudospectra=False,
        bound_pseudo_kwargs=None,
        deflweight=1.0,
    ):
        self._arnoldifyer = None
        self.mode = mode
        self.tol = tol
        self.pseudospectra = pseudospectra
        self.bound_pseudo_kwargs = dict(bound_pseudo_kwargs or {})
        self.deflweight = deflweight

    def _arnoldifyer_for(self, solver):
        """One Arnoldifyer per finished solve: its construction is the
        expensive part, candidate pricing reuses it."""
        cached = self._arnoldifyer
        if cached is None or cached._deflated_solver is not solver:
            cached = deflation.Arnoldifyer(solver)
            self._arnoldifyer = cached
        return cached

    def evaluate(self, ritz, subset):
        solver = ritz._deflated_solver
        tol = solver.tol if self.tol is None else self.tol
        chosen, _ = _split_indices(ritz, subset)

        curve = deflation.bound_pseudo(
            self._arnoldifyer_for(solver),
            ritz.coeffs[:, chosen],
            tol=tol,
            pseudo_type="auto" if self.pseudospectra else "omit",
            **self.bound_pseudo_kwargs,
        )
        if len(curve) < 2:
            raise AssumptionError(
                "the predicted residual curve is too short to price this "
                "candidate"
            )

        if self.mode == "direct":
            above = curve > tol
            if above.all():
                raise AssumptionError(
                    "predicted curve never reaches the tolerance "
                    "(mode='direct')"
                )
            nsteps = int(above.sum())
        elif self.mode == "extrapolate":
            # most pessimistic geometric rate observed along the curve
            rate = np.max(
                (curve[1:] / curve[0]) ** (1.0 / np.arange(1, len(curve)))
            )
            if not 0 < rate < 1:
                raise AssumptionError(
                    f"predicted curve is not contracting (rate={rate}); "
                    "extrapolation impossible"
                )
            nsteps = np.log(tol / curve[0]) / np.log(rate)
        else:
            raise ArgumentError(
                f"unknown mode {self.mode!r}; choose 'direct' or "
                "'extrapolate'"
            )

        return solver.estimate_time(
            nsteps, len(chosen), deflweight=self.deflweight
        )
