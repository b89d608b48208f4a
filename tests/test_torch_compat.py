"""The port's reference-compatible lane beyond ``linsys`` against the JAX
package, float64 and complex128 on the same numpy inputs:
``core.projections.Projection`` (tests/test_core.py:64-160's cases),
``arnoldi`` (tests/test_arnoldi.py:134-287's cases, every other one of
the product, every ``ortho``, ``M``, ``ip_B`` and ``maxiter``; the
one-reduce forms through the port's one-reduce GMRES), the deflated
solvers (tests/test_deflation.py:65's battery), ``Ritz``
(tests/test_aux.py:267), the one-call ``cg``/``minres``/``gmres``
(tests/test_convenience.py, goldens at 1e-11), the README example with
numpy inputs, the names that raise, and BASELINE configs 2 and 3 through
``linsys`` at 63^2 against each package's functional lane.

Arnoldi relations are compared to 1e-12; where a single-pass scheme near
an invariant subspace lets rounding steer the basis, the rounding witness
of tests/torch_compat_cases.py decides (the JAX package's own relation
moves under one ulp of ``v`` or the reversed order of the unknowns), and
the port's relation is held to the Drkošová bounds of
tests/test_arnoldi.py as the JAX package's is.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import krypy_tpu
import krypy_tpu_torch
from krypy_tpu import deflation as jdeflation, linsys as jlinsys
from krypy_tpu import utils as jutils
from krypy_tpu.errors import ConvergenceError as JaxConvergenceError
from krypy_tpu_torch import (deflation, errors, functional as F, interop,
                             linsys, utils)
from krypy_tpu_torch.core import projections

import helpers
import test_arnoldi as arnoldi_battery
import test_deflation as deflation_battery
import torch_compat_cases as cc

torch.set_num_threads(1)

_B = np.diag(np.linspace(1, 5, 10))


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def _ip_forms():
    """tests/helpers.py's three inner-product forms, in each package."""
    Bt = _t(helpers._B)
    return [
        ("euclid", None, None),
        ("operator", jutils.MatrixLinearOperator(helpers._B),
         utils.MatrixLinearOperator(helpers._B, device="cpu")),
        ("callable",
         lambda x, y: jnp.dot(x.conj().T, jnp.dot(jnp.asarray(helpers._B),
                                                  y)),
         lambda x, y: x.conj().T @ (Bt.to(y.dtype) @ y)),
    ]


_XS = [np.eye(10, 1), np.eye(10, 5), np.eye(10, 5) + 1e-1 * np.ones((10, 5)),
       np.eye(10), np.zeros((10, 0))]


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("ip", range(3), ids=["euclid", "operator",
                                              "callable"])
@pytest.mark.parametrize("Ys", [None, 0, 1])
@pytest.mark.parametrize("xi", range(len(_XS)))
def test_projection(xi, Ys, ip, iterations):
    """tests/test_core.py:64's cases: the port's properties in each, and
    the JAX package's projection at ``iterations=2``."""
    X = _XS[xi]
    Y = None if Ys is None else X + Ys
    _, jip, pip = _ip_forms()[ip]
    Pt = projections.Projection(X, Y, ip_B=pip, iterations=iterations,
                                device="cpu")
    N, k = X.shape
    I = np.eye(N)
    a = np.ones((N, 1))
    z = np.ones((N, 1)) / np.sqrt(N)
    if iterations == 2:
        # against the JAX package at the default iteration count (its
        # eager B-inner-product QR costs ~0.3 s a case on this CPU)
        Pj = jutils.Projection(X, Y, ip_B=jip, iterations=iterations)
        for name in ("apply", "apply_complement", "apply_adj",
                     "apply_complement_adj"):
            want = np.asarray(getattr(Pj, name)(I))
            got = getattr(Pt, name)(I).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                       err_msg=name)
        for name in ("apply", "apply_complement"):
            _, Ya_j = getattr(Pj, name)(a, return_Ya=True)
            _, Ya_t = getattr(Pt, name)(a, return_Ya=True)
            assert tuple(Ya_t.shape) == np.asarray(Ya_j).shape
            np.testing.assert_allclose(Ya_t.numpy(), np.asarray(Ya_j),
                                       atol=1e-12)
    # the port's own properties (tests/test_core.py's)
    PI = Pt.apply(I).numpy()
    np.testing.assert_array_equal(Pt.matrix().numpy(), PI)
    if k > 0:
        np.testing.assert_allclose(Pt.apply(X).numpy(), X, atol=1e-14)
        Yc = X if Y is None else Y
        assert np.linalg.norm(interop.to_numpy(utils.inner(
            _t(Yc), _t(I - PI), ip_B=pip)), 2) < 1e-13
        for name in ("apply", "apply_complement"):
            _, Ya = getattr(Pt, name)(a, return_Ya=True)
            np.testing.assert_allclose(
                Ya.numpy(), interop.to_numpy(utils.inner(_t(Yc), _t(a),
                                                         ip_B=pip)),
                atol=1e-14)
    assert np.linalg.norm(Pt.apply(I - PI).numpy(), 2) < 1e-14
    np.testing.assert_allclose(I - PI, Pt.apply_complement(I).numpy(),
                               atol=1e-14)
    assert torch.equal(Pt.operator() * _t(z), Pt.apply(z))
    assert torch.equal(Pt.operator_complement() * _t(z),
                       Pt.apply_complement(z))
    if k == 0:
        assert np.linalg.norm(PI) == 0
        assert isinstance(Pt.operator(), utils.ZeroLinearOperator)


def test_projection_refusals_and_device():
    for kwargs in (dict(iterations=0),):
        with pytest.raises(errors.ArgumentError):
            projections.Projection(np.eye(4, 2), device="cpu", **kwargs)
    with pytest.raises(errors.ArgumentError):
        projections.Projection(np.ones(4), device="cpu")
    with pytest.raises(errors.ArgumentError):
        projections.Projection(np.eye(4, 2), np.eye(4, 3), device="cpu")
    # a tensor basis keeps its device; numpy goes to the card by default
    P = projections.Projection(_t(np.eye(4, 2)))
    assert P.V.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            projections.Projection(np.eye(4, 2))


# ---------------------------------------------------------------------------
# Arnoldi
# ---------------------------------------------------------------------------

_ARNOLDI_MATRICES = {"spd": helpers.matrix_spd,
                     "symm_indef": helpers.matrix_symm_indef,
                     "nonsymm": helpers.matrix_nonsymm}
_VS = {"ones": np.ones((10, 1)), "e1": np.eye(10, 1)}
_IPS = {"none": (None, None), "op": (jutils.MatrixLinearOperator(_B),
                                     utils.MatrixLinearOperator(
                                         _B, device="cpu")),
        "callable": (
            lambda x, y: jnp.dot(x.conj().T, jnp.dot(jnp.asarray(_B), y)),
            lambda x, y: x.conj().T @ (_t(_B).to(y.dtype) @ y)),
        "matrix": (_B, _B)}
#: the JAX forms of ``_IPS`` on the reversed unknowns (``fwd`` reverses a
#: vector or the rows and columns of a matrix)
_IPS_REVERSED = {
    "none": lambda fwd: None,
    "op": lambda fwd: jutils.MatrixLinearOperator(fwd(_B)),
    "callable": lambda fwd: lambda x, y: jnp.dot(
        x.conj().T, jnp.dot(jnp.asarray(fwd(_B)), y)),
    "matrix": lambda fwd: fwd(_B)}


#: every JAX_EVERY-th case of a battery is also solved by the JAX package
#: and compared (its eager solves cost ~50 ms a case on this CPU); every
#: case holds the port to the battery's own checks
JAX_EVERY = 3


def _arnoldi_cases():
    """tests/test_arnoldi.py:134's product (the Householder cases it
    skips left out), then its Lanczos product (:154)."""
    cases = []
    for m, v, it, ortho, M, ip in itertools.product(
            _ARNOLDI_MATRICES, _VS, [1, 5, 9, 10],
            ["mgs", "dmgs", "cgs", "cgs2", "house"], ["none", "B"], _IPS):
        if ortho == "house" and (M != "none" or ip != "none"):
            continue
        cases.append((m, v, it, ortho, M, ip))
    for m, v, it, M, ip in itertools.product(
            ["spd", "symm_indef"], _VS, [1, 5, 9, 10], ["none", "B"], _IPS):
        cases.append((m, v, it, "lanczos", M, ip))
    return list(enumerate(cases))


def _arnoldi_results(res, M):
    out = dict(zip(("V", "H", "P"), res)) if M is not None else dict(
        zip(("V", "H"), res), P=None)
    return {k: None if v is None else (interop.to_numpy(v)
                                       if isinstance(v, torch.Tensor)
                                       else np.asarray(v))
            for k, v in out.items()}


@pytest.mark.parametrize("case", _arnoldi_cases(),
                         ids=lambda c: f"{c[0]}-" + "-".join(map(str, c[1])))
def test_arnoldi(case):
    """The port's relation within the Drkošová bounds, and (every
    ``JAX_EVERY``-th case) the JAX package's relation to 1e-12."""
    index, (mname, vname, maxiter, ortho, Mname, ipname) = case
    A = _ARNOLDI_MATRICES[mname]()
    v = _VS[vname]
    M = None if Mname == "none" else _B
    jip, pip = _IPS[ipname]
    An = np.linalg.norm(A, 2)
    res = utils.arnoldi(A, _t(v), maxiter=maxiter, ortho=ortho, M=M,
                        ip_B=pip)
    got = _arnoldi_results(res, M)
    if index % JAX_EVERY == 0:

        def jax_run(A_, v_, M_, ip_):
            return _arnoldi_results(jutils.arnoldi(
                A_, jnp.asarray(v_), maxiter=maxiter, ortho=ortho, M=M_,
                ip_B=ip_), M_)

        def witness():
            fwd, back = cc.reversal(10)
            return [jax_run(A, cc.one_ulp(v), M, jip),
                    jax_run(cc.one_ulp(A), v, M, jip),
                    back(jax_run(fwd(A), fwd(v), fwd(M),
                                 _IPS_REVERSED[ipname](fwd)))]

        def scaled(res):
            # H relative to ||A||; the basis columns are unit vectors
            return dict(res, H=res["H"] / An)

        cc.hold(scaled(jax_run(A, v, M, jip)), scaled(got),
                lambda: [scaled(w) for w in witness()], strict=1e-12)
    # the same Drkošová bounds as the JAX package's relation
    arnoldi_battery.assert_arnoldi(
        A, v, jnp.asarray(got["V"]), got["H"], got["P"], maxiter,
        ortho, M, jip, An=An)


def test_arnoldi_operator_input():
    matrix = helpers.matrix_nonsymm()
    v = torch.ones((10, 1), dtype=torch.float64)
    V1, H1 = utils.arnoldi(matrix, v, maxiter=5)
    V2, H2 = utils.arnoldi(utils.MatrixLinearOperator(matrix, device="cpu"),
                           v, maxiter=5)
    assert np.allclose(V1.numpy(), V2.numpy(), atol=1e-14)
    assert np.allclose(H1, H2, atol=1e-14)


def test_arnoldi_projected_matches_jax():
    matrix = helpers.matrix_spd()
    v = np.ones((10, 1))
    out = []
    for pkg, mk in ((jutils, jnp.asarray), (utils, _t)):
        V, H = pkg.arnoldi(matrix, mk(v), maxiter=6, ortho="dmgs")
        n = H.shape[1]
        x = np.eye(n - 1, 1)
        y = np.eye(n, 1)
        Hx = np.asarray(H)[:-1, : n - 1] @ x
        P = pkg.Projection(mk(Hx), mk(y)).operator_complement()
        U, G, Fm = pkg.arnoldi_projected(H, P, 1)
        i = G.shape[1]
        assert np.asarray(U).shape[1] == G.shape[0]
        assert G.shape[0] in (i, i + 1)
        assert Fm.shape == (1, i)
        out.append((np.asarray(U), np.asarray(G), np.asarray(Fm)))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, atol=1e-12)


def test_arnoldi_refusals_match_jax():
    v = np.ones((10, 1))
    A = helpers.matrix_spd()
    for kwargs in (dict(ortho="cgs2_1r"), dict(ortho="nope"),
                   dict(ortho="house", M=_B), dict(ortho="house", ip_B=_B)):
        with pytest.raises(jutils.ArgumentError):
            jutils.arnoldi(A, jnp.asarray(v), **kwargs)
        with pytest.raises(utils.ArgumentError):
            utils.arnoldi(A, _t(v), **kwargs)
    eng = utils.Arnoldi(A, _t(v), maxiter=1)
    eng.advance()
    with pytest.raises(utils.ArgumentError):
        eng.advance()


def _one_reduce_relation(A, v, maxiter, ip=None, M=None):
    """The one-reduce DCGS-2 relation of the port: GMRES with
    ``ortho="cgs2_1r"`` on ``b = v`` from zero, run to ``maxiter`` or
    breakdown (``tol=0``), its basis and Hessenberg from
    ``return_internal``."""
    res, st = F.gmres(_t(A), _t(v).reshape(-1), ortho="cgs2_1r", tol=0.0,
                      maxiter=maxiter, ip=None if ip is None else _t(ip),
                      M=None if M is None else _t(M), return_internal=True)
    n = int(res.niter)
    cols = n if int(res.status) == F.BREAKDOWN else n + 1
    V = st["V"][:cols].T.numpy()
    P = None if st["P"] is None else st["P"][:cols].T.numpy()
    return V, st["H"][:cols, :n].numpy(), P


@pytest.mark.parametrize("ip", [None, _B], ids=["euclid", "B"])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("vname", sorted(_VS))
@pytest.mark.parametrize("mname", sorted(_ARNOLDI_MATRICES))
def test_one_reduce_relation_bounds(mname, vname, maxiter, ip):
    """tests/test_arnoldi.py:178's one-reduce cases on the port's
    one-reduce scheme: the Drkošová battery at the two-pass class."""
    A = _ARNOLDI_MATRICES[mname]()
    V, H, _ = _one_reduce_relation(A, _VS[vname], maxiter, ip=ip)
    arnoldi_battery.assert_arnoldi(
        A, _VS[vname], jnp.asarray(V), H, None, maxiter, "dmgs", None,
        None if ip is None else ip, An=np.linalg.norm(A, 2))


@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("vname", sorted(_VS))
@pytest.mark.parametrize("mname", sorted(_ARNOLDI_MATRICES))
def test_one_reduce_dual_basis_bounds(mname, vname, maxiter):
    """tests/test_arnoldi.py:210's dual-basis (``V = M P``) one-reduce
    cases on the port's scheme."""
    A = _ARNOLDI_MATRICES[mname]()
    V, H, P = _one_reduce_relation(A, _VS[vname], maxiter, M=_B)
    arnoldi_battery.assert_arnoldi(
        A, _VS[vname], jnp.asarray(V), H, jnp.asarray(P), maxiter, "dmgs",
        _B, None, An=np.linalg.norm(A, 2))


def test_one_reduce_refusals():
    """tests/test_arnoldi.py:241: the one-reduce scheme refuses M with a
    weighted ip, and a scalar-callable ip, with ValueError."""
    b = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        F.gmres(torch.eye(4, dtype=torch.float64), b, maxiter=2,
                ortho="cgs2_1r", M=lambda x: x,
                ip=torch.eye(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        F.gmres(torch.eye(4, dtype=torch.float64), b, maxiter=2,
                ortho="cgs2_1r", ip=lambda x, y: torch.vdot(x, y))


# ---------------------------------------------------------------------------
# deflated solvers and Ritz
# ---------------------------------------------------------------------------

PORT_DEFLATED = {jdeflation.DeflatedCg: deflation.DeflatedCg,
                 jdeflation.DeflatedMinres: deflation.DeflatedMinres,
                 jdeflation.DeflatedGmres: deflation.DeflatedGmres}


DEFLATION_CASES = cc.recorded_cases(
    deflation_battery.generate_deflation_cases)


def _port_system(A, b, **kwargs):
    return linsys.LinearSystem(A, b, device="cpu", **kwargs)


def _check_ritz(solver, ls):
    """tests/test_deflation.py's ``check_ritz`` on the port's solver and
    Ritz pairs: the augmented Ritz pairs against a generalized
    eigenproblem on Z = [V_n, U] formed by hand."""
    n_, n = solver.H.shape
    m = solver.projection.U.shape[1]
    Z = torch.cat([solver.V[:, :n], solver.projection.U], dim=1)
    MMlAMrZ = ls.M * (ls.MlAMr * Z)
    ip = ls.get_ip_Minv_B()
    inner_left = interop.to_numpy(utils.inner(Z, MMlAMrZ, ip_B=ip))
    inner_right = interop.to_numpy(utils.inner(Z, Z, ip_B=ip))
    if ls.self_adjoint:
        np.testing.assert_array_almost_equal(inner_left,
                                             inner_left.T.conj())
    if isinstance(solver, linsys.Gmres) and 0 < n + m <= ls.N:
        np.testing.assert_array_almost_equal(inner_right, np.eye(n + m),
                                             decimal=4)
    if 0 < n + m <= ls.N and \
            np.linalg.norm(inner_right - np.eye(n + m), 2) < 1e-8:
        cmp_values = scipy.linalg.eig(inner_left, inner_right)[0]
        ritz = deflation.Ritz(solver, mode="ritz")
        sort = np.argsort(np.abs(ritz.values))
        np.testing.assert_array_almost_equal(
            ritz.values[sort], cmp_values[np.argsort(np.abs(cmp_values))])


@pytest.mark.parametrize("case", list(enumerate(DEFLATION_CASES)), ids=[
    f"{i}-{cls.__name__}" for i, (cls, _, _) in enumerate(DEFLATION_CASES)])
def test_deflation_solver(case):
    """The battery's contract and the deflation bookkeeping on the port's
    solver, and (every ``JAX_EVERY``-th case) the JAX package's solve
    compared, ``E`` and ``C`` included."""
    index, (cls, args, params) = case
    if index % JAX_EVERY == 0:
        jls, sol, _ = cc.compare_solves(
            cls, PORT_DEFLATED[cls], JaxConvergenceError,
            errors.ConvergenceError, jlinsys.LinearSystem, _port_system,
            args, params, extra=("E", "C"))
    else:
        A, b, kw = args
        jls = jlinsys.LinearSystem(A, b, **kw)
        sol, _ = cc.run(PORT_DEFLATED[cls], _port_system(A, b, **kw), params,
                        errors.ConvergenceError)
    cc.check_contract(sol, cls, jls, params)
    # the deflation bookkeeping against an explicit recomputation
    ls = sol.linear_system
    n = sol.H.shape[1]
    U = sol.projection.U
    host = interop.to_numpy
    np.testing.assert_array_almost_equal(
        host(sol.E), host(utils.inner(U, ls.MlAMr * U, ip_B=ls.ip_B)))
    np.testing.assert_array_almost_equal(
        host(sol.C),
        host(utils.inner(U, ls.MlAMr * sol.V[:, :n], ip_B=ls.ip_B)))
    np.testing.assert_array_almost_equal(
        host(sol.B_),
        host(utils.inner(sol.V, sol.projection.AU, ip_B=ls.ip_B)))
    _check_ritz(sol, ls)


@pytest.mark.parametrize("mode", ["ritz", "harmonic"])
@pytest.mark.parametrize("with_U", [False, True])
def test_deflated_ritz_matches_jax(mode, with_U):
    """tests/test_aux.py:267 on the port, and against the JAX package's
    values and residual norms."""
    N = 20
    d = np.linspace(1, 2, N)
    d[0] = 1e-2
    U = np.eye(N, 2) if with_U else None
    flags = dict(normal=True, self_adjoint=True, positive_definite=True)
    out = []
    for lin, defl, exc, kw in (
            (jlinsys, jdeflation, JaxConvergenceError, {}),
            (linsys, deflation, errors.ConvergenceError,
             dict(device="cpu"))):
        ls = lin.LinearSystem(np.diag(d), np.ones((N, 1)), **flags, **kw)
        sol, _ = cc.run(defl.DeflatedGmres, ls,
                        dict(U=U, tol=1e-10, maxiter=8, store_arnoldi=True),
                        exc)
        out.append(defl.Ritz(sol, mode=mode))
    jr, ritz = out
    explicit = ritz.get_explicit_resnorms()
    finite = np.isfinite(ritz.values)
    np.testing.assert_allclose(ritz.resnorms[finite], explicit[finite],
                               atol=1e-8)
    np.testing.assert_allclose(np.linalg.norm(ritz.coeffs, axis=0), 1.0,
                               atol=1e-12)
    order, jorder = np.argsort(ritz.values), np.argsort(jr.values)
    np.testing.assert_allclose(ritz.values[order], jr.values[jorder],
                               rtol=1e-10)
    np.testing.assert_allclose(ritz.resnorms[order], jr.resnorms[jorder],
                               atol=1e-10)
    vecs = ritz.get_vectors([0, 1])
    assert tuple(vecs.shape) == (N, 2) and vecs.device.type == "cpu"


def test_estimate_time_needs_timed_system():
    A = helpers.matrix_spd()
    b = np.ones((10, 1))
    ls = linsys.LinearSystem(A, b, self_adjoint=True,
                             positive_definite=True, device="cpu")
    sol = deflation.DeflatedCg(ls, U=np.eye(10, 1), tol=1e-10,
                               store_arnoldi=True)
    with pytest.raises(errors.RuntimeError):
        sol.estimate_time(5, 1)
    tls = linsys.ConvertedTimedLinearSystem(ls)
    sol = deflation.DeflatedCg(tls, U=np.eye(10, 1), tol=1e-10,
                               store_arnoldi=True)
    assert sol.estimate_time(5, 1) >= 0


def test_orthonormal_span_and_unitary_column_match_jax():
    """The extended-basis helpers that ``Arnoldifyer`` will use."""
    rng = np.random.RandomState(0)
    X = rng.rand(10, 3)
    X[:, 2] = X[:, 0] + X[:, 1]
    for ip in (None, _B):
        Qj = np.asarray(jdeflation._orthonormal_span(jnp.asarray(X), ip,
                                                     1e-12))
        Qt = deflation._orthonormal_span(_t(X), ip, 1e-12).numpy()
        assert Qt.shape == Qj.shape == (10, 2)
        np.testing.assert_allclose(Qt, Qj, atol=1e-12)
    q = rng.rand(5) + 1j * rng.rand(5)
    np.testing.assert_allclose(deflation._unitary_from_column(q),
                               jdeflation._unitary_from_column(q),
                               atol=1e-14)


# ---------------------------------------------------------------------------
# the one-call functions
# ---------------------------------------------------------------------------

_GOLDEN = {
    "cg": [1004.1873775173957, 1000.0003174916551, 999.9999999997555],
    "gmres": [1004.1873724888546, 1000.0003124630923, 999.999994971191],
    "minres": [1004.187372488912, 1000.0003124632159, 999.9999949713145],
}
_GOLDEN_DEFLATED = {
    "cg": [1004.1873775173271, 1000.0003174918709, 1000.0],
    "minres": [1004.1873774950692, 1000.0003174918709, 1000.0],
    "gmres": [1004.1873774950692, 1000.0003174918709, 1000.0],
}


def _functionals(sol):
    sol = np.asarray(sol)
    return [np.sum(np.abs(sol)), np.sqrt(np.dot(sol, sol)),
            np.max(np.abs(sol))]


def _readme():
    return np.diag([1.0e-3] + list(range(2, 101)))


@pytest.mark.parametrize("method", sorted(_GOLDEN))
def test_golden(method):
    tol = 1.0e-11
    A = _readme()
    fn = getattr(krypy_tpu_torch, method)
    b = np.ones((100, 1))
    sol, _ = fn(A, b, inner_product=lambda a, b: torch.dot(a, b),
                device="cpu")
    assert tuple(sol.shape) == b.shape
    b = np.ones(100)
    sol, _ = fn(A, b, inner_product=lambda a, b: torch.dot(a, b),
                device="cpu")
    assert tuple(sol.shape) == b.shape and sol.device.type == "cpu"
    got = _functionals(sol.numpy())
    for g, r in zip(got, _GOLDEN[method]):
        assert abs(g - r) < tol * r
    want, _ = getattr(krypy_tpu, method)(
        A, b, inner_product=lambda a, b: jnp.dot(a, b))
    want = np.asarray(want)
    assert np.linalg.norm(sol.numpy() - want) <= 1e-11 * np.linalg.norm(want)


@pytest.mark.parametrize("method", sorted(_GOLDEN_DEFLATED))
def test_golden_deflated(method):
    """The goldens the JAX package's test_golden_deflated holds it to."""
    tol = 1.0e-11
    A = _readme()
    b = np.ones(100)
    U = np.zeros(100)
    U[0] = 1.0
    sol, _ = getattr(krypy_tpu_torch, method)(A, b, U=U, device="cpu")
    for g, r in zip(_functionals(sol.numpy()), _GOLDEN_DEFLATED[method]):
        assert abs(g - r) < tol * r


def test_custom_inner_product():
    tol = 1.0e-11
    A = _readme()
    b = np.ones(100)
    sol, _ = krypy_tpu_torch.cg(A, b, inner_product=lambda a, b: a @ b,
                                device="cpu")
    for g, r in zip(_functionals(sol.numpy()), _GOLDEN["cg"]):
        assert abs(g - r) < tol * r


def test_nonconvergence_raises_with_state():
    A = _readme()
    b = np.ones(100)
    with pytest.raises(errors.ConvergenceError) as excinfo:
        krypy_tpu_torch.gmres(A, b, maxiter=3, tol=1e-14, device="cpu")
    solver = excinfo.value.solver
    assert solver.xk is not None
    assert len(solver.resnorms) == 4
    assert solver.resnorms[-1] > 1e-14
    with pytest.raises(JaxConvergenceError) as jexc:
        krypy_tpu.gmres(A, b, maxiter=3, tol=1e-14)
    np.testing.assert_allclose(solver.resnorms, jexc.value.solver.resnorms,
                               rtol=1e-12)


def test_readme_example_with_numpy_inputs():
    """README.md's compatibility example, numpy in, through the port's
    root: the solution on the requested device, the JAX package's
    answer."""
    A = _readme()
    b = np.ones(100)
    x, solver = krypy_tpu_torch.gmres(A, b, device="cpu")
    xj, sj = krypy_tpu.gmres(A, b)
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert len(solver.resnorms) == len(sj.resnorms)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10)
    if not torch.cuda.is_available():
        # numpy inputs, no device named: the card, which is absent
        with pytest.raises((RuntimeError, AssertionError)):
            krypy_tpu_torch.gmres(A, b)


def test_one_call_options_and_shapes():
    A = _readme()
    b = np.ones(100)
    with pytest.raises(AssertionError):
        krypy_tpu_torch.cg(np.ones((3, 4)), np.ones(3), device="cpu")
    with pytest.raises(AssertionError):
        krypy_tpu_torch.cg(A, np.ones(7), device="cpu")
    x, solver = krypy_tpu_torch.minres(
        A, torch.ones(100, dtype=torch.float64), ortho="lanczos",
        x0=np.zeros(100), use_explicit_residual=True, store_arnoldi=True,
        exact_solution=np.linalg.solve(A, b))
    assert solver.explicit_residual and solver.V.shape[0] == 100
    assert len(solver.errnorms) == len(solver.resnorms)
    assert x.device.type == "cpu"


# ---------------------------------------------------------------------------
# names that raise
# ---------------------------------------------------------------------------

def _raising_calls(pkg_linsys, pkg_deflation, pkg_utils, device):
    A = helpers.matrix_spd()
    b = np.ones((10, 1))
    kw = {} if device is None else {"device": device}
    ls = pkg_linsys.LinearSystem(A, b, **kw)
    return {
        "not a system": lambda: pkg_linsys.Cg("nope"),
        "Minv missing": lambda: pkg_linsys.LinearSystem(
            A, b, M=np.eye(10), **kw).get_ip_Minv_B(),
        "givens qr": lambda: pkg_linsys._GivensQR(1.0, np.float64),
        "ritz mode": lambda: pkg_deflation.Ritz(
            pkg_deflation.DeflatedGmres(ls, U=np.eye(10, 1), tol=1e-8,
                                        store_arnoldi=True), mode="nope"),
        "projection iterations": lambda: pkg_utils.Projection(
            np.eye(10, 1), iterations=0, **kw),
        "abstract projection": lambda: pkg_deflation._Projection(ls, None),
        "operations": lambda: pkg_linsys._KrylovSolver.operations(3),
    }


def test_names_raise_where_jax_raises():
    want = _raising_calls(jlinsys, jdeflation, jutils, None)
    got = _raising_calls(linsys, deflation, utils, "cpu")
    for name in want:
        with pytest.raises(Exception) as je:
            want[name]()
        with pytest.raises(Exception) as pe:
            got[name]()
        assert type(pe.value).__name__ == type(je.value).__name__, name
    # and warn where the JAX names warn
    A = helpers.matrix_spd()
    for lin, kw in ((jlinsys, {}), (linsys, {"device": "cpu"})):
        with pytest.warns(UserWarning, match="normal by definition"):
            ls = lin.LinearSystem(A, np.ones(10), self_adjoint=True,
                                  normal=False, **kw)
        assert ls.normal
        with pytest.warns(UserWarning, match="self-adjoint"):
            lin.Minres(lin.LinearSystem(A, np.ones(10), **kw), tol=2.0)


def test_arnoldifyer_and_bound_pseudo_are_not_ported_yet():
    """The two names that raised ``NotImplementedError`` until the
    recycling lane was ported now run (tests/test_torch_pseudospectra.py
    holds them to the JAX package); only ``pseudo_type='contain'`` raises
    it, as the JAX package's does."""
    ls = linsys.LinearSystem(np.diag(np.linspace(1, 2, 10)), np.ones(10),
                             self_adjoint=True, device="cpu")
    sol = deflation.DeflatedGmres(ls, U=np.eye(10, 1), tol=1e-8,
                                  store_arnoldi=True)
    arn = deflation.Arnoldifyer(sol)
    Wt = np.zeros((arn.n + arn.d, 0))
    bounds = deflation.bound_pseudo(arn, Wt, tol=1e-8, pseudo_type="omit")
    assert len(bounds) >= 1 and np.isfinite(bounds).all()
    with pytest.raises(NotImplementedError, match="contain"):
        deflation.bound_pseudo(arn, Wt, pseudo_type="contain")


def test_public_names_match_jax():
    """Every public name of the JAX modules is in the port's."""
    from krypy_tpu import _convenience as jconv, arnoldi as jarn
    from krypy_tpu.core import projections as jproj
    from krypy_tpu_torch import _convenience, arnoldi

    for jm, pm in ((jlinsys, linsys), (jdeflation, deflation),
                   (jutils, utils), (jarn, arnoldi), (jproj, projections),
                   (jconv, _convenience)):
        missing = [n for n in jm.__all__ if not hasattr(pm, n)]
        assert not missing, (jm.__name__, missing)
    for name in ("linsys", "deflation", "utils", "cg", "minres", "gmres"):
        assert hasattr(krypy_tpu_torch, name)


# ---------------------------------------------------------------------------
# BASELINE configs 2 and 3 through linsys, against the functional lane
# ---------------------------------------------------------------------------

C23_NX = 63


def _config2_pieces(pkg, ops_mod, nx):
    """Config 2's A, M and weights in one package (float64)."""
    from krypy_tpu_torch import suite

    w = suite.config2_weights(nx).astype(np.float64)
    if pkg == "jax":
        lap = ops_mod.poisson_2d(nx)
        mg = ops_mod.multigrid_poisson_preconditioner(nx, coarsest=31,
                                                      coarse_sweeps=60)
        w = jnp.asarray(w)
    else:
        lap = ops_mod.poisson_2d(nx, device="cpu")
        mg = ops_mod.multigrid_poisson_preconditioner(
            nx, coarsest=31, coarse_sweeps=60, device="cpu")
        w = _t(w)

    def A(x):
        return lap(x) / w

    def M(r):
        return mg(w * r)

    return A, M, w


def _lanes_config2(pkg):
    """CG and MINRES on config 2 at 63^2 (float64, one solve to 1e-4 from
    zero, maxiter 200) through each lane of ``pkg``: ``{solver: (linsys
    iterations, functional iterations, linsys x, functional x)}``."""
    N = C23_NX * C23_NX
    if pkg == "jax":
        from krypy_tpu import functional as JF, ops as jops

        A, M, w = _config2_pieces(pkg, jops, C23_NX)
        # compiled once: the eager lane would dispatch each op of the
        # V-cycle on its own
        A, M = jax.jit(A), jax.jit(M)
        b = jnp.ones(N)
        Aop = jutils.FunctionLinearOperator((N, N), np.float64, A)
        Mop = jutils.FunctionLinearOperator((N, N), np.float64, M)
        ls = jlinsys.LinearSystem(Aop, b, M=Mop,
                                  ip_B=jutils.DiagonalLinearOperator(w),
                                  self_adjoint=True, positive_definite=True)
        Fm, lin = JF, jlinsys

        def ip(x, y):
            return jnp.vdot(x, w * y)
    else:
        from krypy_tpu_torch import ops

        A, M, w = _config2_pieces(pkg, ops, C23_NX)
        A.shape = M.shape = (N, N)
        b = torch.ones(N, dtype=torch.float64)
        ls = linsys.LinearSystem(A, b, M=M,
                                 ip_B=utils.DiagonalLinearOperator(w),
                                 self_adjoint=True, positive_definite=True)
        Fm, lin = F, linsys

        def ip(x, y):
            return torch.vdot(x, w * y)
    out = {}
    for name, cls in (("cg", lin.Cg), ("minres", lin.Minres)):
        sol = cls(ls, tol=1e-4, maxiter=200)
        res = getattr(Fm, name)(A, b, M=M, ip=ip, tol=1e-4, maxiter=200)
        out[name] = (len(sol.resnorms) - 1, int(res.niter),
                     np.asarray(sol.xk)[:, 0], np.asarray(res.x))
    return out


def test_config2_through_linsys_both_packages():
    """Config 2's CG and MINRES at 63^2 through ``linsys`` (the port's
    ``ops`` callables in A and M, the weights as a DiagonalLinearOperator
    in ``ip_B``) against the functional lane, in each package; the two
    packages' linsys lanes against each other."""
    got, want = _lanes_config2("torch"), _lanes_config2("jax")
    for name in ("cg", "minres"):
        (it, itf, x, xf), (jit, jitf, jx, jxf) = got[name], want[name]
        # the lanes of each package agree as the other package's do
        assert it - itf == jit - jitf, name
        assert abs(it - itf) <= 1, name
        np.testing.assert_allclose(x, xf, rtol=1e-4)
        np.testing.assert_allclose(jx, jxf, rtol=1e-4)
        # and the port's linsys lane is the JAX package's
        assert it == jit, name
        np.testing.assert_allclose(x, jx, rtol=1e-9)


def test_config3_through_linsys_both_packages():
    """Config 3 at 63^2 (restarted GMRES(30), at most 10 restarts, tol
    1e-4, float64) through ``linsys.RestartedGmres`` with ``Ml``, ``M``
    and ``Mr`` from ``ops`` against the functional ``restarted_gmres``,
    in each package."""
    from krypy_tpu import ops as jops
    from krypy_tpu.functional.gmres import restarted_gmres as jrestarted
    from krypy_tpu_torch import ops

    nx = C23_NX
    N = nx * nx
    h2 = (1.0 / (nx + 1)) ** 2
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            cd = jops.convection_diffusion_2d(nx)
            Ml = jops.multigrid_poisson_preconditioner(nx, coarsest=31,
                                                       coarse_sweeps=60)
            M = jops.diagonal(jnp.full(N, 1.0 + 0.5 * h2))
            Mr = jops.jacobi_preconditioner(jnp.full(N, 4.0 / h2))
            b = jnp.ones(N)

            cd, Ml, M, Mr = (jax.jit(f) for f in (cd, Ml, M, Mr))

            def op(f):
                return jutils.FunctionLinearOperator((N, N), np.float64, f)

            ls = jlinsys.LinearSystem(op(cd), b, M=op(M), Ml=op(Ml),
                                      Mr=op(Mr))
            restarted, lin = jrestarted, jlinsys
        else:
            cd = ops.convection_diffusion_2d(nx, device="cpu")
            Ml = ops.multigrid_poisson_preconditioner(
                nx, coarsest=31, coarse_sweeps=60, device="cpu")
            M = ops.diagonal(torch.full((N,), 1.0 + 0.5 * h2,
                                        dtype=torch.float64))
            Mr = ops.jacobi_preconditioner(torch.full(
                (N,), 4.0 / h2, dtype=torch.float64))
            Ml.shape = Mr.shape = (N, N)
            b = torch.ones(N, dtype=torch.float64)
            ls = linsys.LinearSystem(cd, b, M=M, Ml=Ml, Mr=Mr)
            restarted, lin = F.restarted_gmres, linsys
        sol = lin.RestartedGmres(ls, maxiter=30, max_restarts=10, tol=1e-4)
        res = restarted(cd, b, Ml=Ml, M=M, Mr=Mr, tol=1e-4, maxiter=30,
                        max_restarts=10)
        out[pkg] = (len(sol.resnorms) - 1, int(res.niter),
                    np.asarray(sol.xk)[:, 0], np.asarray(res.x))
    (it, itf, x, xf), (jit, jitf, jx, jxf) = out["torch"], out["jax"]
    assert it - itf == jit - jitf
    assert it == jit
    np.testing.assert_allclose(x, xf, rtol=1e-3)
    np.testing.assert_allclose(x, jx, rtol=1e-9)
