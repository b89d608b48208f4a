"""The port's ``recycling`` package (generators, factories, evaluators,
``RecyclingCg``/``RecyclingMinres``/``RecyclingGmres``) against the JAX
package's, float64 on the same numpy inputs.

* tests/test_recycling.py's 21 + 2 + 1 sequences through both packages:
  iterations per solve equal, each deflation basis ``U`` within a
  principal angle of 1e-8 of the JAX package's and ``xk`` to 1e-10, a
  miss passing only under tests/torch_compat_cases.py's rounding witness
  (the JAX package's own sequence under one ulp of b or A or the
  reversed unknowns); then that file's own contract on the port's solves
  (the final residual equal to the recomputed one to 14 decimals).  The
  residual histories are not compared entry by entry: the 1e-8
  eigenvalue's solves are rounding-steered (a first solve's history
  moves by 2e-4 under one ulp of b in the JAX package itself).  The automatic factories
  price candidates with measured timings, so both packages' solves get
  the same clock (``_CLOCK``) before the pricing reads it;
* tests/test_aux.py:106-187's evaluators and generators: the same
  predicted seconds (1e-8 relative) on the same clock, the same
  AssumptionErrors, the same chosen index sets;
* a ``maxiter`` that forces ``ConvergenceError`` leaves ``last_solver``
  at the previous solve in both packages;
* BASELINE config 5 in KryPy's words at 15^2: the Jacobian systems
  ``J_k = -Lap + diag(3 kappa u_k^2 - lam)``, ``b_k = -F(u_k)``, ``u_k =
  t_k u*``, built in numpy, through both packages'
  ``RecyclingGmres(RitzFactorySimple(3, "sm"))``; then the port's ``ops``
  operator and its ``torch.func.jvp`` Jacobian action in place of the
  dense ``J_k``, with the same counts;
* examples/deflation_recycling.py's ``compat_lane`` on the port;
* the public names of the new modules against the JAX modules'.
"""

import warnings

import numpy as np
import pytest
import scipy.linalg
import torch

import krypy_tpu
from krypy_tpu import checkpoint as jcheckpoint, deflation as jdeflation
from krypy_tpu import linsys as jlinsys, pseudospectra as jpseudospectra
from krypy_tpu import recycling as jrecycling, utils as jutils
from krypy_tpu.errors import AssumptionError as JaxAssumptionError
from krypy_tpu.errors import ConvergenceError as JaxConvergenceError
import krypy_tpu_torch
from krypy_tpu_torch import (checkpoint, deflation, errors, interop, linsys,
                             ops, pseudospectra, recycling, utils)

import torch_compat_cases as cc

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The host LAPACK work here is small and dense (matrices of 200 x 200
    and below), which OpenBLAS runs many times faster on one thread than
    on its default pool; both packages share the limit."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1):
        yield

#: the two packages: (linsys, deflation, recycling, utils, exceptions,
#: system keywords, result to numpy)
JAX = (jlinsys, jdeflation, jrecycling, jutils,
       (JaxConvergenceError, JaxAssumptionError), {}, np.asarray)
PORT = (linsys, deflation, recycling, utils,
        (errors.ConvergenceError, errors.AssumptionError),
        dict(device="cpu"), interop.to_numpy)

#: the clock both packages' pricing reads (seconds per application)
_CLOCK = {"A": 2e-5, "M": 1e-6, "Ml": 1e-6, "Mr": 1e-6, "ip_B": 3e-6,
          "axpy": 1e-6}

SPD = dict(normal=True, self_adjoint=True, positive_definite=True)

#: the JAX package's first solve under each witness, by solver, system
#: and witness
_FIRST_WITNESSES = {}


def _outliers(N, small):
    d = np.linspace(1, 2, N)
    d[:len(small)] = small
    return np.diag(d), np.ones((N, 1))


def _set_clock(pkg, solver):
    """Replace the measured timings that the next pricing reads (the last
    solve's system's) by ``_CLOCK``, in ``pkg``'s own Timings."""
    timings = pkg[3].Timings()
    for key, val in _CLOCK.items():
        timings[key].append(val)
    solver.linear_system.timings = timings


def _angle(Uw, Ug):
    """The largest principal angle between two bases (0 for empty ones)."""
    if Uw.shape[1] == 0 and Ug.shape[1] == 0:
        return 0.0
    if Uw.shape != Ug.shape:
        return np.inf
    return float(np.max(scipy.linalg.subspace_angles(Uw, Ug)))


def _sequence(pkg, solver_name, A, b, factory, n_solves, params,
              clock=False, ctor_factory=None):
    """``n_solves`` solves of ``LinearSystem(A, b, **SPD)`` by ``pkg``'s
    recycling solver; per solve its ``xk``, ``resnorms`` and ``U`` as
    numpy.  Returns ``(runs, recycling solver, solvers)``."""
    lin, _, rec, _, (conv, _), skw, host = pkg
    ls = lin.LinearSystem(A, b, **SPD, **skw)
    rs = getattr(rec, solver_name)(vector_factory=ctor_factory)
    runs, sols = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(n_solves):
            if clock and rs.last_solver is not None:
                _set_clock(pkg, rs.last_solver)
            kw = {} if factory is None else dict(
                vector_factory=factory(pkg))
            sol = rs.solve(ls, **kw, **params)
            sols.append(sol)
            runs.append(dict(xk=host(sol.xk), resnorms=list(sol.resnorms),
                             U=host(sol.projection.U)))
    return runs, rs, sols


#: the bound of each compared quantity of a solve: ``xk`` relative in
#: norm, ``U`` the largest principal angle to the JAX package's basis
BOUNDS = {"xk": cc.STRICT, "U": 1e-8}


def _seq_dev(want, got):
    out = {}
    for i, (w, g) in enumerate(zip(want, got)):
        out[f"xk{i}"] = cc.deviations({"xk": w["xk"]}, {"xk": g["xk"]})["xk"]
        out[f"U{i}"] = _angle(w["U"], g["U"])
    return out


def _hold_sequence(want, got, witness):
    """tests/torch_compat_cases.py's ``hold`` over the solves of a
    sequence: a quantity beyond its bound (:data:`BOUNDS`) passes only
    where the JAX package's own sequence moves beyond it under a witness,
    and the port by at most ``WITNESS_SPREAD`` times as far.
    ``witness(upto)`` yields the JAX package's first ``upto`` solves
    under each witness in turn; they are taken only until their largest
    moves pass every missed quantity (the largest only grows, so the
    verdict is that of all three)."""
    def bound(key):
        return BOUNDS[key.rstrip("0123456789")]

    def passes(v, w, key):
        return w > bound(key) and (w == np.inf or v <= cc.WITNESS_SPREAD * w)

    dev = _seq_dev(want, got)
    missed = {k: v for k, v in dev.items() if v > bound(k)}
    if not missed:
        return []
    upto = 1 + max(int(k.lstrip("xkU")) for k in missed)
    moved = dict.fromkeys(missed, 0.0)
    for runs in witness(upto):
        m = _seq_dev(want[:upto], runs)
        moved = {k: max(w, m.get(k, 0.0)) for k, w in moved.items()}
        if all(passes(v, moved[k], k) for k, v in missed.items()):
            break
    for k, v in missed.items():
        w = moved[k]
        assert w > bound(k), (
            f"{k}: the port deviates by {v:.3e}, the JAX package under one "
            f"ulp of b or A or the reversed order by {w:.3e}")
        assert w == np.inf or v <= cc.WITNESS_SPREAD * w, (k, v, w)
    return sorted(missed)


def _compare_sequences(solver_name, A, b, factory, n_solves, params,
                       clock=False, ctor_factory=None):
    """Both packages' sequences, held to each other; returns the port's
    ``(runs, recycling solver, solvers)`` and the JAX package's runs."""
    def ctor(pkg):
        return None if ctor_factory is None else ctor_factory(pkg)

    want, jrs, _ = _sequence(JAX, solver_name, A, b, factory, n_solves,
                             params, clock, ctor(JAX))
    got, prs, psols = _sequence(PORT, solver_name, A, b, factory, n_solves,
                                params, clock, ctor(PORT))
    assert [len(r["resnorms"]) for r in got] == \
        [len(r["resnorms"]) for r in want]

    def witness(upto):
        # the first ``upto`` solves suffice; the first solve deflates
        # nothing, so its witnesses are the same for every factory
        key = (solver_name, A.tobytes(), b.tobytes(), repr(params))
        fwd, _ = cc.reversal(b.shape[0])
        back = np.argsort(np.arange(b.shape[0])[::-1])
        for i, (wA, wb, order) in enumerate((
                (A, cc.one_ulp(b), None), (cc.one_ulp(A), b, None),
                (fwd(A), fwd(b), back))):
            if upto == 1 and (key, i) in _FIRST_WITNESSES:
                yield _FIRST_WITNESSES[key, i]
                continue
            runs = _sequence(JAX, solver_name, wA, wb, factory, upto,
                             params, clock, ctor(JAX))[0]
            if order is not None:
                runs = [dict(r, xk=r["xk"][order], U=r["U"][order])
                        for r in runs]
            if upto == 1:
                _FIRST_WITNESSES[key, i] = runs
            yield runs

    steered = _hold_sequence(want, got, witness)
    if steered:
        print("passed by the rounding witness:", steered)
    return (got, prs, psols), (want, jrs)


def _simple(n_vectors, which):
    def make(pkg):
        return pkg[2].factories.RitzFactorySimple(n_vectors=n_vectors,
                                                  which=which)
    return make


# ---------------------------------------------------------------------------
# tests/test_recycling.py's sequences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "solver_name", ["RecyclingCg", "RecyclingMinres", "RecyclingGmres"])
@pytest.mark.parametrize(
    "which", ["lm", "sm", "lr", "sr", "li", "si", "smallest_res"])
def test_ritz_factory_simple_matches_jax(solver_name, which):
    A, b = _outliers(100, [1e-8, 1e-4, 1e-2, 2e-2, 3e-2])
    params = {"maxiter": 50, "tol": 1e-5, "x0": None}
    (got, _, sols), _ = _compare_sequences(solver_name, A, b,
                                           _simple(3, which), 3, params)
    jls = jlinsys.LinearSystem(A, b, **SPD)
    jcls = getattr(jrecycling, solver_name)
    for i, sol in enumerate(sols):
        cc.check_contract(sol, jcls, jls, params)
        if i > 0:
            assert len(sol.resnorms) <= len(sols[0].resnorms)
        assert sol.xk.device.type == "cpu"


@pytest.mark.parametrize("factory_shortcut",
                         ["RitzApproxKrylov", "RitzAprioriCg"])
def test_automatic_factories_match_jax(factory_shortcut):
    """The string shortcuts end to end, both packages priced on the same
    clock: the same chosen subspaces, iterations and iterates."""
    A, b = _outliers(50, [1e-4, 1e-2, 3e-2])
    params = {"maxiter": 50, "tol": 1e-5, "x0": None}
    (got, rs, sols), _ = _compare_sequences(
        "RecyclingCg", A, b, None, 2, params, clock=True,
        ctor_factory=lambda pkg: factory_shortcut)
    for sol in sols:
        assert sol.resnorms[-1] <= 1e-5
    assert len(rs.timings["vector_factory"]) == 2
    assert len(rs.timings["solve"]) == 2
    assert got[1]["U"].shape[1] > 0


def test_union_factory_matches_jax():
    A, b = _outliers(40, [1e-3])

    def union(pkg):
        f = pkg[2].factories
        return f.UnionFactory([f.RitzFactorySimple(n_vectors=1, which="sm"),
                               f.RitzFactorySimple(n_vectors=1, which="lm")])

    (got, _, sols), _ = _compare_sequences(
        "RecyclingMinres", A, b, None, 2, {"tol": 1e-6},
        ctor_factory=union)
    assert sols[1].resnorms[-1] <= 1e-6
    assert len(sols[1].resnorms) <= len(sols[0].resnorms)
    assert got[1]["U"].shape[1] == 2


@pytest.mark.parametrize(
    "solver_name", ["RecyclingCg", "RecyclingMinres", "RecyclingGmres"])
def test_capped_solve_leaves_last_solver(solver_name):
    """A deflated solve that raises ``ConvergenceError`` at ``maxiter``
    does not become ``last_solver``: the next solve recycles from the one
    before it, in both packages alike."""
    A, b = _outliers(100, [1e-8, 1e-4, 1e-2, 2e-2, 3e-2])
    lens = []
    for pkg in (JAX, PORT):
        lin, _, rec, _, (conv, _), skw, _ = pkg
        ls = lin.LinearSystem(A, b, **SPD, **skw)
        rs = getattr(rec, solver_name)(
            vector_factory=rec.factories.RitzFactorySimple(n_vectors=3,
                                                           which="sm"))
        first = rs.solve(ls, tol=1e-5, maxiter=50)
        with pytest.raises(conv) as caught:
            rs.solve(ls, tol=1e-5, maxiter=3)
        assert caught.value.solver is not first
        assert rs.last_solver is first
        third = rs.solve(ls, tol=1e-5, maxiter=50)
        assert rs.last_solver is third
        lens.append([len(first.resnorms), len(caught.value.solver.resnorms),
                     len(third.resnorms)])
    assert lens[0] == lens[1]


# ---------------------------------------------------------------------------
# tests/test_aux.py's evaluators and generators
# ---------------------------------------------------------------------------

def _deflated_ritz(pkg, Solver, N=30, d0=1e-3, tol=1e-8, timed=True):
    lin, defl, _, _, _, skw, _ = pkg
    d = np.linspace(1, 2, N)
    d[0] = d0
    ls = lin.LinearSystem(np.diag(d), np.ones((N, 1)), **SPD, **skw)
    if timed:
        ls = lin.ConvertedTimedLinearSystem(ls)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = getattr(defl, Solver)(ls, tol=tol, store_arnoldi=True)
    if timed:
        _set_clock(pkg, sol)
    return defl.Ritz(sol)


def _price(pkg, evaluator, ritz, subset):
    try:
        return float(evaluator.evaluate(ritz, frozenset(subset)))
    except pkg[4][1] as exc:
        return type(exc).__name__


@pytest.mark.parametrize("mode", ["extrapolate", "direct"])
def test_ritz_approx_krylov_evaluator_matches_jax(mode):
    """tests/test_aux.py:106: the same predicted seconds for each single
    Ritz index and the pair (or the same AssumptionError), the
    Arnoldifyer built once per solve."""
    out = []
    for pkg in (JAX, PORT):
        ritz = _deflated_ritz(pkg, "DeflatedGmres")
        ev = pkg[2].evaluators.RitzApproxKrylov(mode=mode, tol=1e-8)
        prices = [_price(pkg, ev, ritz, s) for s in
                  ({0}, {1}, {0, 1}, set())]
        first = ev._arnoldifyer
        assert first is not None
        _price(pkg, ev, ritz, {2})
        assert ev._arnoldifyer is first
        out.append(prices)
    want, got = out
    for w, g in zip(want, got):
        if isinstance(w, str):
            assert g == w
        else:
            assert abs(g - w) <= 1e-8 * abs(w)


@pytest.mark.parametrize("strategy", ["simple", "intervals"])
@pytest.mark.parametrize("Bound", ["BoundCG", "BoundMinres"])
def test_ritz_apriori_evaluator_matches_jax(strategy, Bound):
    """tests/test_aux.py:140 (and the simple strategy, and MINRES's
    bound): the same predicted seconds or the same AssumptionError."""
    out = []
    for pkg in (JAX, PORT):
        Solver = "DeflatedCg" if Bound == "BoundCG" else "DeflatedMinres"
        ritz = _deflated_ritz(pkg, Solver)
        ev = pkg[2].evaluators.RitzApriori(
            Bound=getattr(pkg[3], Bound), strategy=strategy)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            small = int(np.argmin(ritz.values))
            out.append([_price(pkg, ev, ritz, s)
                        for s in ({small}, {small, small + 1}, set())])
    want, got = out
    for w, g in zip(want, got):
        if isinstance(w, str):
            assert g == w
        else:
            assert abs(g - w) <= 1e-8 * abs(w)


@pytest.mark.parametrize("evaluator", ["RitzApproxKrylov", "RitzAprioriCg"])
@pytest.mark.parametrize("generator", ["RitzSmall", "RitzExtremal"])
def test_ritz_factory_selection_matches_jax(evaluator, generator):
    """``RitzFactory``'s greedy search over both generators and
    evaluators, on the same clock: the same chosen index set."""
    picks = []
    for pkg in (JAX, PORT):
        rec = pkg[2]
        ritz = _deflated_ritz(pkg, "DeflatedCg", N=40, d0=1e-4, tol=1e-6)
        ev = (rec.evaluators.RitzApproxKrylov() if evaluator ==
              "RitzApproxKrylov" else
              rec.evaluators.RitzApriori(Bound=pkg[3].BoundCG))
        factory = rec.factories.RitzFactory(
            subset_evaluator=ev,
            subsets_generator=getattr(rec.generators, generator)(
                max_vectors=4))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            picks.append(list(factory._select(ritz)))
    assert picks[1] == picks[0]


def test_ritz_extremal_generator_matches_jax():
    """tests/test_aux.py:166: the same proposals, and none at a cap of 0."""
    out = []
    for pkg in (JAX, PORT):
        lin, defl, rec, _, _, skw, _ = pkg
        d = np.linspace(-1, 2, 20)
        ls = lin.LinearSystem(np.diag(d), np.ones((20, 1)), normal=True,
                              self_adjoint=True, **skw)
        ritz = defl.Ritz(defl.DeflatedGmres(ls, tol=1e-8,
                                            store_arnoldi=True))
        everything = set(range(len(ritz.values)))
        subsets = rec.generators.RitzExtremal().generate(ritz, everything)
        assert 1 <= len(subsets) <= 4 and all(len(s) == 1 for s in subsets)
        assert rec.generators.RitzExtremal(max_vectors=0).generate(
            ritz, everything) == []
        small = rec.generators.RitzSmall().generate(ritz, everything)
        out.append((subsets, small))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# BASELINE config 5 in KryPy's words, small
# ---------------------------------------------------------------------------

C5_NX = 15
C5_TS = (0.0, 0.5, 0.8, 0.95, 1.0)
C5_PARAMS = {"tol": 1e-8, "maxiter": C5_NX * C5_NX}


def _c5_pieces():
    """The dense Laplacian, u* and F of ``ops.nls_residual_2d(15, kappa=1,
    lam=25, amplitude=3)`` in float64 numpy (the Laplacian held to the
    JAX package's operator)."""
    from krypy_tpu import ops as jops

    N = C5_NX * C5_NX
    lap = ops.poisson_2d(C5_NX, device="cpu")
    L = torch.stack([lap(col) for col in torch.eye(N, dtype=torch.float64)],
                    dim=1).numpy()
    jlap = jops.poisson_2d(C5_NX)
    v = np.random.RandomState(0).rand(N)
    np.testing.assert_allclose(L @ v, np.asarray(jlap(v)), rtol=1e-13)
    _, ustar = ops.nls_residual_2d(C5_NX, kappa=1.0, lam=25.0,
                                   amplitude=3.0, dtype=torch.float64,
                                   device="cpu")
    u = ustar.numpy()
    g = L @ u + u**3 - 25.0 * u

    def F(w):
        return L @ w + w**3 - 25.0 * w - g

    return L, u, F


def _c5_systems():
    L, ustar, F = _c5_pieces()
    return [(L + np.diag(3.0 * (t * ustar) ** 2 - 25.0), -F(t * ustar))
            for t in C5_TS]


def _c5_sequence(pkg, systems):
    lin, _, rec, _, (conv, _), skw, host = pkg
    rs = rec.RecyclingGmres(
        vector_factory=rec.factories.RitzFactorySimple(n_vectors=3,
                                                       which="sm"))
    runs = []
    for J, b in systems:
        ls = lin.LinearSystem(J, b, self_adjoint=True, **skw)
        sol = rs.solve(ls, **C5_PARAMS)
        runs.append(dict(xk=host(sol.xk), resnorms=list(sol.resnorms),
                         U=host(sol.projection.U)))
    return runs


def test_config5_jacobian_sequence_matches_jax():
    """Config 5's Jacobian systems along ``u_k = t_k u*`` through both
    packages' RecyclingGmres: iterations per solve equal, ``xk`` (and the
    bases) by the witness rule; then the port's ``ops`` stencil and the
    ``torch.func.jvp`` action of its ``nls_residual_2d`` in place of the
    dense matrix, with the same iteration counts."""
    systems = _c5_systems()
    want = _c5_sequence(JAX, systems)
    got = _c5_sequence(PORT, systems)
    counts = [len(r["resnorms"]) - 1 for r in want]
    assert [len(r["resnorms"]) - 1 for r in got] == counts
    assert counts[-1] == 0  # F(u*) = 0: the last system is trivial
    assert max(counts[1:4]) <= counts[0]

    def witness(upto):
        for k in range(3):
            sys_k = []
            for J, b in systems[:upto]:
                if k == 0:
                    sys_k.append((J, cc.one_ulp(b)))
                elif k == 1:
                    sys_k.append((cc.one_ulp(J), b))
                else:
                    fwd, _ = cc.reversal(b.shape[0])
                    sys_k.append((fwd(J), fwd(b)))
            runs = _c5_sequence(JAX, sys_k)
            if k == 2:
                back = np.argsort(np.arange(len(systems[0][1]))[::-1])
                runs = [dict(r, xk=r["xk"][back], U=r["U"][back])
                        for r in runs]
            yield runs

    steered = _hold_sequence(want, got, witness)
    if steered:
        print("passed by the rounding witness:", steered)

    # the port's operators in place of the dense J_k
    N = C5_NX * C5_NX
    lap = ops.poisson_2d(C5_NX, device="cpu")
    Fnls, ustar = ops.nls_residual_2d(C5_NX, kappa=1.0, lam=25.0,
                                      amplitude=3.0, dtype=torch.float64,
                                      device="cpu")
    for form in ("stencil", "jvp"):
        rs = recycling.RecyclingGmres(
            vector_factory=recycling.factories.RitzFactorySimple(
                n_vectors=3, which="sm"))
        its = []
        for t, (_, b) in zip(C5_TS, systems):
            uk = t * ustar
            if form == "stencil":
                dk = 3.0 * uk**2 - 25.0

                def J(v, dk=dk):
                    return lap(v) + dk * v
            else:
                def J(v, uk=uk):
                    return torch.func.jvp(Fnls, (uk,), (v,))[1]
                b = -Fnls(uk).numpy()
            J.shape = (N, N)
            ls = linsys.LinearSystem(J, b, self_adjoint=True, device="cpu")
            its.append(len(rs.solve(ls, **C5_PARAMS).resnorms) - 1)
        assert its[:4] == counts[:4], (form, its, counts)


# ---------------------------------------------------------------------------
# the README example, names
# ---------------------------------------------------------------------------

def _compat_lane(pkg):
    """examples/deflation_recycling.py's ``compat_lane`` (:14-44) in
    ``pkg``: plain and deflated GMRES iterations, then three recycled
    solves'."""
    lin, defl, rec, _, _, skw, _ = pkg
    N = 100
    d = np.linspace(1, 2, N)
    d[0] = 1e-4
    ls = lin.LinearSystem(np.diag(d), np.ones((N, 1)), self_adjoint=True,
                          positive_definite=True, **skw)
    plain = lin.Gmres(ls, tol=1e-8)
    deflated = defl.DeflatedGmres(ls, U=np.eye(N, 1), tol=1e-8)
    rs = rec.RecyclingGmres(vector_factory=rec.factories.RitzFactorySimple(
        n_vectors=3, which="sm"))
    iters = [len(rs.solve(ls, tol=1e-8).resnorms) - 1 for _ in range(3)]
    return len(plain.resnorms) - 1, len(deflated.resnorms) - 1, iters


def test_example_compat_lane_matches_jax():
    assert _compat_lane(PORT) == _compat_lane(JAX)


def test_public_names_match_jax():
    """Every public name of the JAX package's recycling modules,
    ``pseudospectra``, ``checkpoint`` and ``deflation`` is in the port's
    namesake, and the package roots export the same modules."""
    from krypy_tpu.recycling import (evaluators as jev, factories as jfa,
                                     generators as jge, linsys as jrl)
    from krypy_tpu_torch.recycling import (evaluators, factories,
                                           generators, linsys as rl)

    for jm, pm in ((jrecycling, recycling), (jev, evaluators),
                   (jfa, factories), (jge, generators), (jrl, rl),
                   (jpseudospectra, pseudospectra),
                   (jcheckpoint, checkpoint), (jdeflation, deflation)):
        assert sorted(pm.__all__) == sorted(jm.__all__), jm.__name__
        missing = [n for n in jm.__all__ if not hasattr(pm, n)]
        assert not missing, (jm.__name__, missing)
    assert sorted(rl.FACTORY_SHORTCUTS) == sorted(jrl.FACTORY_SHORTCUTS)
    assert recycling.FACTORY_SHORTCUTS is rl.FACTORY_SHORTCUTS
    for name in krypy_tpu.__all__:
        assert hasattr(krypy_tpu_torch, name), name
    for name in ("recycling", "pseudospectra", "checkpoint"):
        assert name in krypy_tpu_torch.__all__


# ---------------------------------------------------------------------------
# config 5's Newton sequence through the recycling lane: the capped solves
# ---------------------------------------------------------------------------

class _NewtonAdapter:
    """``functional.newton_krylov``'s ``recycling_solver=`` over one
    package's ``recycling.RecyclingGmres(RitzFactorySimple(3, "sm"))``
    (the chip smoke's adapter, in float64): each Jacobian solve is
    ``LinearSystem(J, b, self_adjoint=True)``; a solve that raises
    ``ConvergenceError`` gives newton its iterate, and each solve records
    whether it was capped and which solve it recycled from."""

    def __init__(self, pkg):
        self.pkg = pkg
        rec = pkg[2]
        self.rec = rec.RecyclingGmres(
            vector_factory=rec.factories.RitzFactorySimple(n_vectors=3,
                                                           which="sm"))
        self.solves = []
        self._number = {}

    def _system(self, op, b):
        lin = self.pkg[0]
        N = b.numel()
        if self.pkg is PORT:
            def J(v):
                return op(v)
            J.shape = (N, N)
            return lin.LinearSystem(J, b, self_adjoint=True, device="cpu")

        def block(X):
            X = np.asarray(X)
            return np.stack([op(torch.tensor(X[:, j])).numpy()
                             for j in range(X.shape[1])], axis=1)
        A = jutils.LinearOperator((N, N), np.float64, dot=block)
        return lin.LinearSystem(A, b.numpy(), self_adjoint=True)

    def warmup(self, op, b, M=None, maxiter=None):
        return self

    def solve(self, op, b, tol=None, M=None, maxiter=None):
        import types

        ls = self._system(op, b)
        before = self.rec.last_solver
        k = len(self.solves)
        try:
            sol, capped = self.rec.solve(ls, tol=tol, maxiter=maxiter), False
        except self.pkg[4][0] as e:
            sol, capped = e.solver, True
        self._number[id(sol)] = k
        self.solves.append((len(sol.resnorms) - 1, capped, None if before
                            is None else self._number[id(before)]))
        x = torch.as_tensor(self.pkg[6](sol.xk)).reshape(b.shape)
        return types.SimpleNamespace(x=x.to(b.dtype),
                                     niter=len(sol.resnorms) - 1)


def test_capped_newton_sequence_matches_jax():
    """Config 5 at 31^2 in float64 with the inner solves capped at 12
    (the chip smoke's sequences at 511^2 and 1023^2 reach their cap of
    250 likewise): under the reference's semantics a capped solve does
    not become ``last_solver``, so every later solve recycles from the
    first one, whose Ritz vectors belong to another Jacobian, and Newton
    stalls, in both packages alike: the same capped solves, the same
    recycling sources, the same inner counts and ``||F||`` to 1e-6."""
    from krypy_tpu_torch import functional as F

    Fnls, _ = ops.nls_residual_2d(31, kappa=1.0, lam=25.0, amplitude=3.0,
                                  dtype=torch.float64, device="cpu")
    out = []
    for pkg in (JAX, PORT):
        ad = _NewtonAdapter(pkg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = F.newton_krylov(Fnls, torch.zeros(31 * 31,
                                                    dtype=torch.float64),
                                  tol=1e-5, maxiter=8, inner_maxiter=12,
                                  recycling_solver=ad)
        out.append((ad.solves, res))
    (jsolves, jres), (psolves, pres) = out
    assert psolves == jsolves
    assert not pres.converged and not jres.converged
    assert psolves[0][1] is False and all(c for _, c, _ in psolves[1:])
    assert all(src == 0 for _, _, src in psolves[1:])
    np.testing.assert_allclose(pres.resnorms, jres.resnorms, rtol=1e-6)
