"""Deflation-vector factories: turn the state of the last (deflated) solve
into the deflation basis for the next one (counterpart of
:mod:`krypy_tpu_torch.recycling.factories`; the Ritz problems on host LAPACK,
the bases tensors on the system's device).
  :class:`RitzFactory`
searches subsets of the last solve's Ritz pairs, pricing each candidate
with an :mod:`~krypy_tpu_torch.recycling.evaluators` evaluator (predicted
wall-clock seconds) and growing the set greedily;
:class:`RitzFactorySimple` picks a fixed number by a sort criterion;
:class:`UnionFactory` concatenates the output of several factories.
"""

import numpy as np

from .. import deflation
from ..deflation import _column_stack
from ..errors import ArgumentError, AssumptionError
from . import generators

__all__ = [
    "RitzFactory",
    "RitzFactorySimple",
    "UnionFactory",
]


class _DeflationVectorFactory:
    """Interface: :meth:`get` maps a finished solver to an ``(N, k)``
    deflation basis."""

    def get(self, solver):
        raise NotImplementedError("subclasses implement get()")


class RitzFactory(_DeflationVectorFactory):
    """Automatic deflation-subspace selection by greedy subset growth.

    Each round, the generator proposes ways to extend the current index
    set; every proposal is priced by the evaluator; the cheapest priced
    candidate becomes the new current set.  Across all rounds the globally
    cheapest priced set wins.  A proposal whose pricing premises fail
    (:class:`AssumptionError`) is skipped -- failure as control flow, as in
    the reference (krypy/recycling/factories.py:58-63).

    :param subset_evaluator: prices a candidate index set (see
      :mod:`~krypy_tpu_torch.recycling.evaluators`).
    :param subsets_generator: proposes candidate extensions (default:
      :class:`~krypy_tpu_torch.recycling.generators.RitzSmall`).
    :param mode: Ritz mode passed to :class:`~krypy_tpu_torch.deflation.Ritz`.
    :param print_results: ``None`` | ``'number'`` | ``'values'`` |
      ``'timings'``.
    """

    def __init__(
        self,
        subset_evaluator,
        subsets_generator=None,
        mode="ritz",
        print_results=None,
    ):
        self.subsets_generator = (
            generators.RitzSmall()
            if subsets_generator is None
            else subsets_generator
        )
        self.subset_evaluator = subset_evaluator
        self.mode = mode
        self.print_results = print_results

    def get(self, deflated_solver):
        ritz = deflation.Ritz(deflated_solver, mode=self.mode)
        return ritz.get_vectors(self._select(ritz))

    def _select(self, ritz):
        def price(candidate):
            try:
                return self.subset_evaluator.evaluate(ritz, candidate)
            except AssumptionError:
                return None  # not priceable -> skip

        scored = {}
        current = frozenset()
        empty_cost = price(current)
        if empty_cost is not None:
            scored[current] = empty_cost

        universe = set(range(len(ritz.values)))
        while True:
            proposals = self.subsets_generator.generate(
                ritz, universe - current
            )
            if not proposals:
                break

            round_scores = {}
            for extension in proposals:
                candidate = frozenset(current | set(extension))
                cost = price(candidate)
                if cost is not None:
                    round_scores[candidate] = cost

            if round_scores:
                current = min(round_scores, key=round_scores.get)
                scored.update(round_scores)
            else:
                # no proposal was priceable this round: keep growing along
                # the one with the smallest combined Ritz residual
                cheapest_res = min(
                    proposals,
                    key=lambda s: float(np.sum(ritz.resnorms[list(s)])),
                )
                current = frozenset(current | set(cheapest_res))

        winner = min(scored, key=scored.get) if scored else frozenset()
        selection = sorted(winner)
        self._announce(ritz, selection, scored)
        return selection

    def _announce(self, ritz, selection, scored):
        if self.print_results is None:
            return
        if self.print_results == "number":
            print(f"deflation subspace size: {len(selection)}")
        elif self.print_results == "values":
            shown = ", ".join(str(v) for v in ritz.values[selection])
            print(
                f"deflating {len(selection)} Ritz value(s): {shown}"
            )
        elif self.print_results == "timings":
            print("predicted solve time per priced candidate set:")
            for candidate, cost in sorted(
                scored.items(), key=lambda item: item[1]
            ):
                vals = ", ".join(
                    str(v) for v in ritz.values[sorted(candidate)]
                )
                print(f"  {cost}s <- [{vals}]")
        else:
            raise ArgumentError(
                f"unknown print_results value {self.print_results!r}; "
                "choose None, 'number', 'values' or 'timings'"
            )


class RitzFactorySimple(_DeflationVectorFactory):
    """Select a fixed number of Ritz vectors by sort criterion.

    :param which: ``lm``/``sm`` (largest/smallest magnitude), ``lr``/``sr``
      (real part), ``li``/``si`` (imaginary part), or ``smallest_res``
      (smallest Ritz residual).
    """

    #: criterion -> (sort key on the Ritz values, take from the large end)
    _CRITERIA = {
        "lm": (np.abs, True),
        "sm": (np.abs, False),
        "lr": (np.real, True),
        "sr": (np.real, False),
        "li": (np.imag, True),
        "si": (np.imag, False),
    }

    def __init__(self, mode="ritz", n_vectors=0, which="sm"):
        self.mode = mode
        self.n_vectors = n_vectors
        self.which = which

    def get(self, solver):
        ritz = deflation.Ritz(solver, mode=self.mode)
        return ritz.get_vectors(self._pick(ritz))

    def _pick(self, ritz):
        n = self.n_vectors
        if self.which == "smallest_res":
            return np.argsort(ritz.resnorms)[:n]
        if self.which not in self._CRITERIA:
            raise ArgumentError(
                f"unknown criterion {self.which!r}; choose one of "
                f"{sorted(self._CRITERIA)} or 'smallest_res'"
            )
        key, from_top = self._CRITERIA[self.which]
        order = np.argsort(key(ritz.values))
        # note: order[-n:] would return everything for n == 0
        return order[len(order) - n:] if from_top else order[:n]


class UnionFactory(_DeflationVectorFactory):
    """Concatenate the bases produced by several factories."""

    def __init__(self, factories):
        self._factories = list(factories)

    def get(self, solver):
        return _column_stack(*[f.get(solver) for f in self._factories])
