"""Candidate-subset proposal strategies for the greedy Ritz-subset search
(counterpart of :mod:`krypy_tpu_torch.recycling.generators`; host numpy on the
Ritz values).

A generator inspects the Ritz data of the last solve and proposes which
Ritz-vector indices the greedy search in
:class:`~krypy_tpu_torch.recycling.factories.RitzFactory` should consider adding
next.  Each proposal is a set of indices; an empty list terminates the
search.
"""

import numpy as np

__all__ = ["RitzSmall", "RitzExtremal"]


def _budget_exhausted(generator, ritz, remaining):
    """True when no further proposals should be made: fewer than two
    indices remain, or the number of already-selected vectors reached the
    generator's cap."""
    n_selected = len(ritz.values) - len(remaining)
    return len(remaining) <= 1 or n_selected >= generator.max_vectors


def _extreme_of(values):
    """Indices (into ``values``) of its minimum and maximum."""
    if len(values) == 0:
        return []
    order = np.argsort(values)
    picks = [order[0]]
    if len(values) > 1:
        picks.append(order[-1])
    return picks


class RitzSmall:
    """Propose the single remaining Ritz value of smallest magnitude --
    the default generator: one new candidate per greedy round."""

    def __init__(self, max_vectors=np.inf):
        self.max_vectors = max_vectors

    def generate(self, ritz, remaining_subset):
        remaining = sorted(remaining_subset)
        if _budget_exhausted(self, ritz, remaining):
            return []
        magnitudes = np.abs(ritz.values[remaining])
        return [{remaining[int(np.argmin(magnitudes))]}]


class RitzExtremal:
    """Propose extremal Ritz values.

    Self-adjoint systems get up to four proposals (the most negative /
    least negative / smallest positive / largest positive values --
    deflation targets at both spectrum ends); other systems get the
    smallest- and largest-magnitude values.
    """

    def __init__(self, max_vectors=np.inf):
        self.max_vectors = max_vectors

    def generate(self, ritz, remaining_subset):
        remaining = np.array(sorted(remaining_subset))
        if _budget_exhausted(self, ritz, remaining):
            return []
        vals = ritz.values[remaining]

        picks = []
        if ritz._deflated_solver.linear_system.self_adjoint:
            for branch in (vals < 0, vals > 0):
                branch_idx = np.flatnonzero(branch)
                for local in _extreme_of(vals[branch_idx]):
                    picks.append(int(remaining[branch_idx[local]]))
        else:
            for local in _extreme_of(np.abs(vals)):
                picks.append(int(remaining[local]))
        return [{i} for i in picks]
