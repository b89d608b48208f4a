"""Native epsilon-pseudospectrum computation (counterpart of
:mod:`krypy_tpu.pseudospectra`).

* :class:`NormalEvals` -- for normal matrices the
  :math:`\\varepsilon`-pseudospectrum is exactly the union of disks of
  radius :math:`\\varepsilon` around the eigenvalues; the boundary (arcs of
  circles outside all other disks) is computed in closed form.
* :class:`NonnormalMeshgrid` / :class:`NonnormalAuto` -- for non-normal
  matrices, :math:`\\sigma_{\\min}(A - zI)` is evaluated on a complex grid
  as one *batched* ``torch.linalg.svdvals`` on the device of ``A``, and
  the level sets are extracted on the host by marching squares
  (:func:`_level_lines`, which resolves saddle cells as contourpy's
  default algorithm does, so the paths equal the JAX package's).

The objects expose ``contour_paths(epsilon)`` returning a :class:`Paths`
with ``vertices()`` (complex boundary points) and ``length()`` (total
boundary length), the interface consumed by
:func:`krypy_tpu_torch.deflation.bound_pseudo` and
:func:`krypy_tpu_torch.spectral.bound_perturbed_gmres`.
"""

import numpy as np
import torch

from .arnoldi import host
from .linsys import system_device

__all__ = ["Path", "Paths", "NormalEvals", "NonnormalMeshgrid", "NonnormalAuto"]


class Path:
    """A polyline in the complex plane."""

    def __init__(self, vertices):
        self._vertices = np.asarray(vertices, dtype=complex).ravel()

    def vertices(self):
        return self._vertices

    def length(self):
        if self._vertices.size < 2:
            return 0.0
        return float(np.sum(np.abs(np.diff(self._vertices))))


class _Arc(Path):
    """A circular arc, with exact length."""

    def __init__(self, center, radius, phi0, phi1, n_points=64):
        self.center = center
        self.radius = radius
        self.phi0 = phi0
        self.phi1 = phi1
        phis = np.linspace(phi0, phi1, max(2, n_points))
        super().__init__(center + radius * np.exp(1j * phis))

    def length(self):
        return float(abs(self.phi1 - self.phi0) * self.radius)


class Paths:
    """A collection of boundary paths."""

    def __init__(self, paths=None):
        self.paths = list(paths) if paths is not None else []

    def append(self, path):
        self.paths.append(path)

    def vertices(self):
        if not self.paths:
            return np.zeros((0,), dtype=complex)
        return np.concatenate([p.vertices() for p in self.paths])

    def length(self):
        return float(sum(p.length() for p in self.paths))


def _merge_intervals(intervals):
    """Merge overlapping [lo, hi] intervals."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [list(intervals[0])]
    for lo, hi in intervals[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


class NormalEvals:
    """Pseudospectrum of a normal matrix: union of eigenvalue disks.

    ``contour_paths(epsilon)`` returns the exact boundary of the union of
    disks :math:`|z - \\lambda_i| \\le \\varepsilon`: for each disk the
    angular intervals hidden inside other disks are subtracted and the
    remaining arcs returned.
    """

    def __init__(self, evals):
        self.evals = np.asarray(evals, dtype=complex).ravel()

    def contour_paths(self, epsilon, n_points=128):
        paths = Paths()
        lam = self.evals
        r = float(epsilon)
        for i, ci in enumerate(lam):
            covered = []
            fully_covered = False
            for j, cj in enumerate(lam):
                if i == j:
                    continue
                dist = abs(cj - ci)
                if dist == 0:
                    continue
                if dist >= 2 * r:
                    continue  # equal radii: disks intersect iff dist < 2r
                # angular window of circle i hidden inside disk j
                # (equal radii r): half-angle = arccos(dist / (2 r))
                half = np.arccos(dist / (2 * r))
                mid = np.angle(cj - ci)
                covered.append((mid - half, mid + half))
            # normalize angular intervals into [0, 2pi), splitting wrap-around
            norm_cov = []
            for lo, hi in covered:
                span = hi - lo
                lo = lo % (2 * np.pi)
                hi = lo + span
                if hi <= 2 * np.pi:
                    norm_cov.append((lo, hi))
                else:
                    norm_cov.append((lo, 2 * np.pi))
                    norm_cov.append((0.0, hi - 2 * np.pi))
            merged = _merge_intervals(norm_cov)
            if merged and merged[0][0] <= 0 and merged[-1][1] >= 2 * np.pi:
                fully_covered = len(merged) == 1
            if fully_covered:
                continue
            # visible arcs = complement of merged within [0, 2pi)
            if not merged:
                paths.append(_Arc(ci, r, 0.0, 2 * np.pi, n_points))
                continue
            cursor = 0.0
            for lo, hi in merged:
                if lo > cursor:
                    paths.append(_Arc(ci, r, cursor, lo, n_points))
                cursor = max(cursor, hi)
            if cursor < 2 * np.pi:
                paths.append(_Arc(ci, r, cursor, 2 * np.pi, n_points))
        return paths


def _smallest_singular_values(A, zs):
    """sigma_min(A - z I) for a batch of shifts, as one batched
    ``torch.linalg.svdvals`` in complex128 on the device of ``A`` (a
    tensor); ``zs`` is numpy.  Returns numpy."""
    zs = torch.as_tensor(np.asarray(zs, dtype=np.complex128),
                         device=A.device)
    n = A.shape[0]
    Ac = A.to(torch.complex128)
    eye = torch.eye(n, dtype=torch.complex128, device=A.device)
    batch = Ac[None, :, :] - zs[:, None, None] * eye
    return torch.linalg.svdvals(batch)[:, -1].cpu().numpy()


def _crossing_points(za, zb, xa, xb, ya, yb, level):
    """Where the level crosses the edges from points ``a`` to ``b``: linear
    interpolation, in contourpy's form."""
    frac = (zb - level) / (zb - za)
    return xa * frac + xb * (1.0 - frac), ya * frac + yb * (1.0 - frac)


def _level_lines(X, Y, Z, level):
    """The ``level`` set of the field ``Z`` on the grid ``(X, Y)`` (all of
    shape ``(ny, nx)``, ``Z[j, i]`` at ``(X[j, i], Y[j, i])``), as a list
    of ``(n, 2)`` polylines: marching squares with linear interpolation
    along the cell edges, joined into lines; a closed line repeats its
    first point at its end.  A corner lies above the level where ``Z >
    level``; a saddle cell (two opposite corners above, two below) joins
    its above corners where the mean of its four corners lies above the
    level, and its below corners otherwise, as contourpy's default
    (``serial``) algorithm does."""
    Z = np.asarray(Z, dtype=float)
    X = np.asarray(X, dtype=float)
    Y = np.asarray(Y, dtype=float)
    ny, nx = Z.shape
    if ny < 2 or nx < 2:
        return []
    up = Z > level

    # crossing points of the horizontal edges (j, i)-(j, i+1), numbered
    # j * (nx - 1) + i, and of the vertical edges (j, i)-(j+1, i),
    # numbered nh + j * nx + i
    nh = ny * (nx - 1)
    h_cross = up[:, :-1] != up[:, 1:]
    v_cross = up[:-1, :] != up[1:, :]
    px = np.full(nh + (ny - 1) * nx, np.nan)
    py = np.full_like(px, np.nan)
    with np.errstate(divide="ignore", invalid="ignore"):
        hx, hy = _crossing_points(Z[:, :-1], Z[:, 1:], X[:, :-1], X[:, 1:],
                                  Y[:, :-1], Y[:, 1:], level)
        vx, vy = _crossing_points(Z[:-1, :], Z[1:, :], X[:-1, :], X[1:, :],
                                  Y[:-1, :], Y[1:, :], level)
    px[:nh][h_cross.ravel()] = hx[h_cross]
    py[:nh][h_cross.ravel()] = hy[h_cross]
    px[nh:][v_cross.ravel()] = vx[v_cross]
    py[nh:][v_cross.ravel()] = vy[v_cross]

    # each cell (j, i): its corners a (j, i), b (j, i+1), c (j+1, i+1),
    # d (j+1, i) and its edges bottom, right, top, left
    jj, ii = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1), indexing="ij")
    bottom = jj * (nx - 1) + ii
    top = bottom + (nx - 1)
    left = nh + jj * nx + ii
    right = left + 1
    a, b = up[:-1, :-1], up[:-1, 1:]
    c, d = up[1:, 1:], up[1:, :-1]
    code = a.astype(int) | (b << 1) | (c << 2) | (d << 3)
    mid_up = 0.25 * (Z[:-1, :-1] + Z[:-1, 1:] + Z[1:, 1:] + Z[1:, :-1]) \
        > level

    segments = []
    # the edge pairs of a cell cut by one line: the two edges of its one
    # odd corner, or the two that separate its two pairs of neighbours
    pairs = {
        1: ((bottom, left),), 14: ((bottom, left),),
        2: ((bottom, right),), 13: ((bottom, right),),
        4: ((right, top),), 11: ((right, top),),
        8: ((top, left),), 7: ((top, left),),
        3: ((left, right),), 12: ((left, right),),
        6: ((bottom, top),), 9: ((bottom, top),),
    }
    for k, edge_pairs in pairs.items():
        sel = code == k
        for e0, e1 in edge_pairs:
            segments.append(np.stack([e0[sel], e1[sel]], axis=1))
    # saddles: a, c above (code 5) or b, d above (code 10); the middle
    # decides which corners the lines cut off
    for k in (5, 10):
        for mid in (True, False):
            sel = (code == k) & (mid_up == mid)
            # the corners cut off are the below ones where the middle is
            # above, else the above ones
            cut_ac = (k == 5) != mid
            if cut_ac:  # cut off a (bottom, left) and c (right, top)
                edge_pairs = ((bottom, left), (right, top))
            else:  # cut off b (bottom, right) and d (top, left)
                edge_pairs = ((bottom, right), (top, left))
            for e0, e1 in edge_pairs:
                segments.append(np.stack([e0[sel], e1[sel]], axis=1))
    segments = np.concatenate(segments) if segments else \
        np.zeros((0, 2), int)
    return _join(segments, px, py)


def _join(segments, px, py):
    """Join edge-to-edge segments (rows of edge numbers) into polylines of
    the edges' crossing points: every edge lies on at most two segments,
    so the segments form open lines (from an edge on one segment, on the
    grid's border) and closed loops."""
    neighbours = {}
    for e0, e1 in segments.tolist():
        neighbours.setdefault(e0, []).append(e1)
        neighbours.setdefault(e1, []).append(e0)
    seen = set()
    lines = []

    def walk(start):
        line = [start]
        seen.add(start)
        prev, cur = None, start
        while True:
            nxt = [e for e in neighbours[cur] if e != prev]
            if not nxt:
                break  # the other end of an open line
            prev, cur = cur, nxt[0]
            line.append(cur)
            if cur in seen:
                break  # back at the start of a loop
            seen.add(cur)
        return line

    ends = sorted(e for e, nb in neighbours.items() if len(nb) == 1)
    for e in ends:
        if e not in seen:
            lines.append(walk(e))
    for e in sorted(neighbours):
        if e not in seen:
            lines.append(walk(e))
    return [np.stack([px[line], py[line]], axis=1) for line in lines]


class NonnormalMeshgrid:
    """Grid evaluation of :math:`\\sigma_{\\min}(A - zI)` with contour
    extraction of pseudospectrum boundaries.

    ``A`` is a numpy array or a tensor; the batched SVD runs on ``device``
    (keyword-only): ``None`` means ``A``'s device where ``A`` is a tensor,
    else ``"cuda"``.  ``A`` and ``Vals`` are kept as numpy."""

    def __init__(
        self,
        A,
        real_min=-1.0,
        real_max=1.0,
        real_n=50,
        imag_min=-1.0,
        imag_max=1.0,
        imag_n=50,
        *,
        device=None,
    ):
        self.device = system_device(A, device)
        self.A = host(A)
        real = np.linspace(real_min, real_max, real_n)
        imag = np.linspace(imag_min, imag_max, imag_n)
        self.Real, self.Imag = np.meshgrid(real, imag)
        zs = (self.Real + 1j * self.Imag).ravel()
        self.Vals = _smallest_singular_values(
            torch.as_tensor(self.A, device=self.device), zs
        ).reshape(self.Real.shape)

    def contour_paths(self, epsilon, n_points=None):
        """Extract the epsilon level set as polyline paths."""
        lines = _level_lines(self.Real, self.Imag, self.Vals, float(epsilon))
        paths = Paths()
        for line in lines:
            if line.shape[0] >= 2:
                paths.append(Path(line[:, 0] + 1j * line[:, 1]))
        return paths


class NonnormalAuto(NonnormalMeshgrid):
    """Meshgrid pseudospectrum with automatic bounding box covering all
    epsilon-pseudospectra for ``epsilon <= delta_max`` (the
    pseudospectrum lies within distance delta_max of the spectrum)."""

    def __init__(self, A, delta_min, delta_max, n_points=60, **kwargs):
        evals = np.linalg.eigvals(host(A))
        pad = 1.1 * delta_max
        super().__init__(
            A,
            real_min=float(np.min(evals.real) - pad),
            real_max=float(np.max(evals.real) + pad),
            real_n=n_points,
            imag_min=float(np.min(evals.imag) - pad),
            imag_max=float(np.max(evals.imag) + pad),
            imag_n=n_points,
            **kwargs,
        )
