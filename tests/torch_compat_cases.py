"""Shared machinery of the compatibility-lane tests (tests/test_torch_linsys.py,
tests/test_torch_compat.py): run a solver of the JAX package's ``linsys`` /
``deflation`` and its counterpart in the port on the same numpy inputs,
and hold the port's results to the JAX package's.

The rule: ``resnorms`` to ``rtol = 1e-10`` above an absolute floor of
``1e3 eps ||b||`` (relative to ``||M Ml b||``), equal lengths, ``xk`` to
``1e-10`` relative, ``errnorms`` likewise, ``V``, ``H`` and ``P`` to
``1e-10``, and whether the solve raised ``ConvergenceError``.

Where a quantity misses its bound, rounding may be steering the solve: a
10x10 battery solve run to 1e-13 goes on past the dimension of the space,
its residuals sit at the round-off floor, and each new basis vector is the
normalization of a vector of round-off.  Two summation orders then give
different answers.  Such a quantity passes only with a rounding witness:
the JAX package's own solve moves beyond the bound when (a) one ulp is
added to ``b[0]``, (b) one ulp is added to ``A[0, 0]`` or (c) the
unknowns are taken in reverse order (the same system, permuted; its
results permuted back), and the port's deviation is at most
``WITNESS_SPREAD`` times the largest of the witnesses' (round-off vectors
normalized by round-off norms differ by O(1) in any order, while a
witness's may only flip part of them).
"""

import types
import warnings

import numpy as np

EPS = np.finfo(np.float64).eps
#: the bound of every compared quantity (relative, see the module text)
STRICT = 1e-10
#: how far the port may move beyond the JAX package's own witness
WITNESS_SPREAD = 1e4
#: the results of a solver of either lane
RESULTS = ("xk", "resnorms", "errnorms", "V", "H", "P")


def recorded_cases(cases):
    """The case table ``cases()`` of a JAX battery built on
    tests/test_linsys.py's system builder, as ``(solver class, (A, b,
    kwargs), params)``: the builder runs with that module's ``linsys``
    replaced by a namespace whose LinearSystem keeps the numpy arguments
    it was built from, so that the port's system can be built from the
    same."""
    import test_linsys
    from krypy_tpu import linsys

    class Recorded(linsys.LinearSystem):
        def __init__(self, A, b, **kwargs):
            super().__init__(A, b, **kwargs)
            self.recorded = (A, b, kwargs)

    real = test_linsys.linsys
    test_linsys.linsys = types.SimpleNamespace(
        LinearSystem=Recorded, Cg=linsys.Cg, Minres=linsys.Minres,
        Gmres=linsys.Gmres, RestartedGmres=linsys.RestartedGmres)
    try:
        table = list(cases())
    finally:
        test_linsys.linsys = real
    return [(cls, ls.recorded, params) for cls, ls, params in table]


def check_contract(sol, cls, jls, params):
    """tests/test_linsys.py's ``check_solver`` (the final residual equals
    the explicitly recomputed one to 14 decimals, the error norms, the
    iteration budget) on the port's solver ``sol``, its results as numpy,
    against the JAX package's system ``jls`` of the same inputs."""
    import test_linsys
    from krypy_tpu_torch import interop

    test_linsys.check_solver(
        types.SimpleNamespace(xk=interop.compat_solver_to_numpy(sol)["xk"],
                              resnorms=sol.resnorms,
                              errnorms=getattr(sol, "errnorms", None)),
        cls, jls, params)


def jax_results(solver):
    """The JAX lane's solver results as numpy (``None`` where absent)."""
    out = {}
    for name in RESULTS:
        val = getattr(solver, name, None)
        out[name] = None if val is None else np.asarray(val)
    return out


def run(cls, ls, params, exc):
    """``cls(ls, **params)``; the solver carried by ``exc`` where it raised.
    Returns ``(solver, raised)``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return cls(ls, **params), False
        except exc as caught:
            return caught.solver, True


def _history_dev(want, got, floor):
    want = np.asarray(want, dtype=float)
    got = np.asarray(got, dtype=float)
    if want.shape != got.shape:
        return np.inf
    if want.size == 0:
        return 0.0
    excess = np.maximum(np.abs(want - got) - floor, 0.0)
    return float(np.max(excess / np.maximum(np.abs(want), 1e-300)))


def deviations(want, got, b_norm=0.0, mmlb_norm=1.0):
    """Per-quantity deviation of ``got`` from ``want`` (dicts of results,
    ``raised`` among them where a solve ran), in the units of the strict
    bound: histories relative above their floor, ``xk`` relative in norm,
    any other array (``V``, ``H``, ``P``, Gram matrices) absolute."""
    out = {}
    xn = (np.linalg.norm(want["xk"]) or 1.0) if "xk" in want else 1.0
    for k, w in want.items():
        g = got[k]
        if k == "raised":
            out[k] = 0.0 if w == g else np.inf
        elif w is None:
            assert g is None, k
        elif k == "resnorms":
            out[k] = _history_dev(w, g, 1e3 * EPS * b_norm
                                  / (mmlb_norm or 1.0))
        elif k == "errnorms":
            out[k] = _history_dev(w, g, 1e3 * EPS * xn)
        elif k == "xk":
            out[k] = float(np.linalg.norm(w - g) / xn)
        elif np.shape(w) != np.shape(g):
            out[k] = np.inf
        else:
            out[k] = float(np.max(np.abs(w - g))) if np.size(w) else 0.0
    return out


def one_ulp(b):
    """``b`` (a vector or a matrix) with one ulp added to the real part of
    its first entry."""
    b = np.array(b, copy=True)
    v = b.flat[0]
    b.flat[0] = np.nextafter(np.real(v), np.inf) + (
        1j * np.imag(v) if np.iscomplexobj(b) else 0)
    return b


def reversal(N):
    """``(forward, back)``: the reversed order of N unknowns applied to an
    input (rows of a vector or block, rows and columns of an N x N
    matrix) and its inverse applied to a result (rows of a vector or
    basis; H is invariant)."""
    perm = np.arange(N)[::-1]

    def forward(a):
        if a is None or not hasattr(a, "shape") or np.ndim(a) == 0:
            return a
        a = np.asarray(a)
        if a.ndim == 2 and a.shape == (N, N):
            return a[perm][:, perm]
        return a[perm]

    def back(res):
        res = dict(res)
        for k in ("xk", "V", "P"):
            if res.get(k) is not None:
                res[k] = res[k][np.argsort(perm)]
        return res

    return forward, back


def hold(want, got, witness, b_norm=0.0, mmlb_norm=1.0, strict=STRICT):
    """Assert the port's results ``got`` against the JAX package's
    ``want``; ``witness()`` returns the JAX package's results under the
    two rounding witnesses, called only where a quantity misses
    ``strict``.  Returns the quantities that passed by the witness rule
    (empty where every quantity met its bound)."""
    dev = deviations(want, got, b_norm, mmlb_norm)
    missed = {k: v for k, v in dev.items() if v > strict}
    if not missed:
        return []
    moved = [deviations(want, w, b_norm, mmlb_norm) for w in witness()]
    for k, v in missed.items():
        w = max(m.get(k, 0.0) for m in moved)
        assert w > strict, (
            f"{k}: the port deviates by {v:.3e}, the JAX package under one "
            f"ulp of b or A or the reversed order by {w:.3e} (bound "
            f"{strict})")
        assert w == np.inf or v <= WITNESS_SPREAD * w, (
            f"{k}: the port deviates by {v:.3e}, {v / w:.1f} times the "
            f"JAX package's witness {w:.3e}")
    return sorted(missed)


def compare_solves(jcls, pcls, jexc, pexc, make_jls, make_pls, args, params,
                   extra=()):
    """Run the JAX lane's ``jcls`` on ``make_jls(*args)`` and the port's
    ``pcls`` on ``make_pls(*args)`` with ``params`` (numpy arrays in
    ``args`` and ``params`` are the inputs), hold the port to the JAX
    package (:func:`hold`) and return ``(jax system, port solver, the
    witnessed quantities)``.  ``args = (A, b, kwargs)``; ``extra`` names
    further solver attributes compared alike (a deflated solve's ``E``,
    ``C``)."""
    from krypy_tpu_torch import interop

    A, b, kw = args
    jls = make_jls(A, b, **kw)
    js, jraised = run(jcls, jls, params, jexc)
    ps, praised = run(pcls, make_pls(A, b, **kw), params, pexc)

    def results(solver, raised, port):
        out = (interop.compat_solver_to_numpy(solver) if port
               else jax_results(solver))
        for k in extra:
            val = getattr(solver, k)
            out[k] = interop.to_numpy(val) if port else np.asarray(val)
        out["raised"] = raised
        return out

    want = results(js, jraised, False)
    got = results(ps, praised, True)

    def witness():
        out = []
        for wA, wb in ((A, one_ulp(b)), (one_ulp(A), b)):
            ws, wraised = run(jcls, make_jls(wA, wb, **kw), params, jexc)
            out.append(results(ws, wraised, False))
        fwd, back = reversal(b.shape[0])
        wkw = {k: fwd(v) for k, v in kw.items()}
        wparams = {k: fwd(v) for k, v in params.items()}
        ws, wraised = run(jcls, make_jls(fwd(A), fwd(b), **wkw), wparams,
                          jexc)
        out.append(back(results(ws, wraised, False)))
        return out

    steered = hold(want, got, witness, float(np.linalg.norm(b)),
                   float(jls.MMlb_norm))
    return jls, ps, steered
