"""Shared machinery of the eigensolver tests (tests/test_torch_eigsh.py,
tests/test_torch_eigen_block.py): run a solver of the JAX package's
``functional`` and its counterpart in the port on the same numpy inputs,
and hold the port's results to the JAX package's with :func:`hold`:

* ``status`` equal (and ``n_inside`` for ``eigsh_window``);
* ``theta`` within ``THETA_RTOL`` relative, or the JAX test's own
  tolerance where that is looser; a real operator's ``eigs`` values as
  multisets whose members may be each other's conjugates (a magnitude
  cut through a conjugate pair picks one member by rounding,
  tests/test_eigs.py);
* ``niter`` equal;
* ``U`` by the largest principal angle between the two column spaces,
  ``sin <= ANGLE``, where the wanted pairs are converged and their
  eigenvalues separated from the next (a subspace is then defined);
* ``pair_resnorms`` within ``RES_RTOL`` relative above an absolute floor
  of the solve's ``tol`` (converged residuals sit at rounding level).

A quantity that misses its bound passes only by the rule of
tests/torch_compat_cases.py: the JAX package's own result moves beyond
the bound when one ulp is added to the start (``v0[0]`` and ``v0[N //
2]``, or ``X0[0, 0]`` and ``X0[N // 2, 0]``), and the port's deviation is
at most ``WITNESS_SPREAD`` times that (for ``niter``, at most the
witness's own change).  The start is passed to both packages as the same
numpy array where a witness may be needed.  The port's small
eigendecompositions differ from the JAX package's by signs inside the
restarts, so no raw Ritz vector is compared.
"""

import jax.numpy as jnp
import numpy as np
import torch

import torch_compat_cases as cc
from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, interop, ops

#: the strict bound of theta (relative) and of the subspace angle
THETA_RTOL = 1e-10
ANGLE = 1e-8
#: pair residuals: relative bound above the solve's tol
RES_RTOL = 1e-6


def pk(v, pkg):
    """A case's value for ``pkg``: ``{"jax": .., "torch": ..}`` picks,
    numpy arrays become a jax array or a CPU tensor."""
    if isinstance(v, dict) and set(v) == {"jax", "torch"}:
        return v[pkg]
    if isinstance(v, np.ndarray):
        return jnp.asarray(v) if pkg == "jax" else torch.tensor(v)
    return v


def to_np(a):
    if isinstance(a, torch.Tensor):
        return interop.to_numpy(a)
    return np.asarray(a)


def run(fn, pkg, *args, **kw):
    """One solve of ``fn`` by ``pkg`` on the case's inputs; its results
    as numpy."""
    solver = getattr(JF if pkg == "jax" else F, fn)
    r = solver(*(pk(a, pkg) for a in args),
               **{k: pk(v, pkg) for k, v in kw.items()})
    out = {"theta": to_np(r.theta), "U": to_np(r.U), "niter": int(r.niter),
           "status": int(r.status), "pair": to_np(r.pair_resnorms),
           "resnorms": to_np(r.resnorms)}
    if hasattr(r, "n_inside"):
        out["n_inside"] = int(r.n_inside)
        out["saturated"] = bool(r.saturated)
    return out


def sin_angle(U1, U2):
    """The sine of the largest principal angle between the column spaces
    of ``U1`` and ``U2``."""
    Q1, _ = np.linalg.qr(U1)
    Q2, _ = np.linalg.qr(U2)
    return float(np.linalg.norm(Q2 - Q1 @ (Q1.conj().T @ Q2), 2))


def absdiff(g, w):
    """``|g - w|`` with equal entries (infinities too) at 0 and a NaN
    against a number at infinity."""
    with np.errstate(invalid="ignore"):
        d = np.abs(g - w)
    d = np.where(g == w, 0.0, d)
    return np.where(np.isnan(d), np.inf, d)


def theta_dev(want, got, conj=False):
    """Relative deviation of ``got`` from ``want``, in order, or as
    nearest-member multisets (``conj``: each member may be the other's
    conjugate)."""
    w, g = np.asarray(want), np.asarray(got)
    if w.size == 0:
        return 0.0
    scale = np.maximum(np.abs(w), 1e-300)
    if not conj:
        return float(np.max(absdiff(g, w) / scale))
    d = absdiff(g[:, None], w[None, :])
    d = np.minimum(d, absdiff(g[:, None], w[None, :].conj()))
    d = d / scale[None, :]
    return float(max(d.min(axis=0).max(), d.min(axis=1).max()))


def pair_dev(want, got, tol):
    """Relative deviation of pair residuals above the floor ``tol``."""
    if np.size(want) == 0:
        return 0.0
    return float(np.max(np.maximum(absdiff(got, want) - tol, 0.0)
                        / np.maximum(np.abs(want), 1e-300)))


def _deviations(want, got, tol, conj, subspace, width):
    """Each compared quantity's deviation and bound (module docstring);
    ``width`` leading pairs are compared (all where None)."""
    w = slice(None) if width is None else slice(0, width)
    dev = {"theta": theta_dev(want["theta"][w], got["theta"][w], conj),
           "niter": abs(got["niter"] - want["niter"]),
           "pair": pair_dev(want["pair"][w], got["pair"][w], tol)}
    bound = {"niter": 0, "pair": RES_RTOL}
    if subspace and want["status"] == 0 and not conj:
        dev["U"] = sin_angle(want["U"][:, w], got["U"][:, w])
        bound["U"] = ANGLE
    return dev, bound


def hold(fn, *args, rtol=THETA_RTOL, subspace=True, conj=False,
         start="v0", default=None, **kw):
    """Run ``fn`` in both packages on ``args`` and ``kw`` and hold the
    port to the JAX package (module docstring); ``start`` names the
    keyword of the start (``v0`` or ``X0``) that the witness perturbs,
    ``default`` the numpy value of each package's default start where
    ``kw`` has none.  For ``eigsh_window`` the ``n_inside`` leading pairs
    are compared.  Returns the JAX package's results."""
    want = run(fn, "jax", *args, **kw)
    got = run(fn, "torch", *args, **kw)
    tol = kw.get("tol", 1e-8)
    assert got["status"] == want["status"]
    assert got["theta"].shape == want["theta"].shape
    assert got.get("n_inside") == want.get("n_inside")
    assert got.get("saturated") == want.get("saturated")
    width = want.get("n_inside")
    dev, bound = _deviations(want, got, tol, conj, subspace, width)
    bound["theta"] = rtol
    missed = {k: v for k, v in dev.items() if v > bound[k]}
    if missed:
        _witness(fn, args, kw, start, kw.get(start, default), want, missed,
                 bound, conj, width)
    return want


def _witness(fn, args, kw, start, x0, want, missed, bound, conj, width):
    """The rounding witness: the JAX package's own results under one ulp
    of the start ``x0``'s first entry and of its entry N // 2 must move
    beyond the bound, and the port by at most ``WITNESS_SPREAD`` times
    that."""
    assert isinstance(x0, np.ndarray), (
        f"the port misses {missed} and the case has no {start} to witness")
    moved = {k: 0.0 for k in missed}
    for i in (0, x0.shape[0] // 2):
        w = x0.copy()
        w[i:] = cc.one_ulp(x0[i:])
        r = run(fn, "jax", *args, **dict(kw, **{start: w}))
        dev, _ = _deviations(want, r, 0.0, conj, "U" in missed, width)
        for k in moved:
            moved[k] = max(moved[k], dev[k])
    for k, v in missed.items():
        assert moved[k] > bound[k], (
            f"{k}: the port deviates by {v:.3e}; the JAX package under one "
            f"ulp of {start} by {moved[k]:.3e} (bound {bound[k]})")
        limit = moved[k] if k == "niter" else cc.WITNESS_SPREAD * moved[k]
        assert v <= limit, (f"{k}: the port deviates by {v:.3e}, the JAX "
                            f"package's witness by {moved[k]:.3e}")


def diag(d):
    """``diag(d)`` in both packages (the port's on the CPU)."""
    return {"jax": jops.diagonal(jnp.asarray(d)),
            "torch": ops.diagonal(torch.tensor(d))}


def lap2d(nx):
    return {"jax": jops.poisson_2d(nx),
            "torch": ops.poisson_2d(nx, device="cpu")}


def start(N):
    """The JAX package's default start vector, from numpy."""
    return np.cos(np.arange(N) * 0.7391) + 0.01


def start_block(N, k):
    """The JAX package's default ``(N, k)`` start block, from numpy."""
    return np.stack([np.cos(np.arange(N) * (0.7391 + 0.1137 * i))
                     + 0.01 * (i + 1) for i in range(k)], axis=1)
