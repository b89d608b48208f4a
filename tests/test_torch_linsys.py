"""The port's reference-compatible solvers (krypy_tpu_torch.linsys) against
krypy_tpu.linsys, float64 and complex128, on the same numpy inputs.

The cases are tests/test_linsys.py's own battery (its builder at its
default ``KRYPY_TPU_TEST_STRIDE``: six matrix classes x inner products x
right-hand sides x exact solutions x preconditioners x initial guesses x
tolerances, for CG, MINRES, GMRES and restarted GMRES), each solved by
both packages with ``store_arnoldi=True`` and held to the rule of
tests/torch_compat_cases.py (``resnorms``, ``xk``, ``errnorms``, ``V``,
``H``, ``P`` to 1e-10, with a rounding witness where a 10x10 solve run to
1e-13 sits at the round-off floor); the battery's own contract
(``check_solver``: the final residual equals the explicitly recomputed
one to 14 decimals, the error norms, the iteration budget) is then run on
the port's solver.  Also: ``LinearSystem.get_residual``, the timed
systems, and the port's compatibility lane against its functional lane.
"""

import warnings

import numpy as np
import pytest
import torch

from krypy_tpu import linsys as jlinsys
from krypy_tpu.errors import ConvergenceError as JaxConvergenceError
from krypy_tpu_torch import functional as F, interop, linsys, utils
from krypy_tpu_torch.errors import ConvergenceError

import helpers
import test_linsys as battery
import torch_compat_cases as cc

torch.set_num_threads(1)

PORT = {jlinsys.Cg: linsys.Cg, jlinsys.Minres: linsys.Minres,
        jlinsys.Gmres: linsys.Gmres,
        jlinsys.RestartedGmres: linsys.RestartedGmres}


CASES = cc.recorded_cases(battery.all_cases)


def port_system(A, b, **kwargs):
    return linsys.LinearSystem(A, b, device="cpu", **kwargs)


@pytest.mark.parametrize("case", CASES, ids=[
    f"{i}-{cls.__name__}" for i, (cls, _, _) in enumerate(CASES)])
def test_battery_matches_jax(case):
    cls, args, params = case
    params = dict(params, store_arnoldi=True)
    jls, sol, _ = cc.compare_solves(
        cls, PORT[cls], JaxConvergenceError, ConvergenceError,
        jlinsys.LinearSystem, port_system, args, params)
    cc.check_contract(sol, cls, jls, params)


def test_linear_system():
    A = np.diag(range(1, 11))
    exact = np.ones((10, 1))
    b = A.dot(exact)
    ls = linsys.LinearSystem(A, b, M=np.eye(10), Ml=np.eye(10),
                             Mr=np.eye(10), device="cpu")
    MMlr, r, rnorm = ls.get_residual(torch.zeros((10, 1), dtype=torch.float64),
                                     compute_norm=True)
    np.testing.assert_almost_equal(r.numpy(), b)
    np.testing.assert_almost_equal(r.numpy(), MMlr.numpy())
    np.testing.assert_almost_equal(float(rnorm), np.linalg.norm(b, 2))

    MMlr, r, rnorm = ls.get_residual(torch.tensor(exact), compute_norm=True)
    np.testing.assert_almost_equal(r.numpy(), np.zeros((10, 1)))
    np.testing.assert_almost_equal(float(rnorm), 0)
    assert ls.device == torch.device("cpu")
    assert r.device == torch.device("cpu")


def test_linear_system_device_rule():
    """``device=None`` is ``b``'s device for a tensor ``b`` and the card
    for numpy ``b``: without a card, numpy inputs raise, as the
    constructors in ``ops`` do; nothing runs on the CPU unasked."""
    A = helpers.matrix_spd()
    ls = linsys.LinearSystem(A, torch.ones(10, dtype=torch.float64))
    assert ls.device == torch.device("cpu") and ls.A.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            linsys.LinearSystem(A, np.ones(10))


def _timed_cases():
    A = helpers.matrix_spd()
    b = np.ones((10, 1))
    flags = dict(self_adjoint=True, positive_definite=True)
    yield "timed", lambda m: m.TimedLinearSystem(A, b, device="cpu", **flags)
    yield "converted", lambda m: m.ConvertedTimedLinearSystem(
        m.LinearSystem(A, b, device="cpu", **flags))


@pytest.mark.parametrize("kind", ["timed", "converted"])
def test_timed_linear_system_records(kind):
    """tests/test_aux.py:39-86's timed systems: the timings fill, and the
    solve is the JAX package's."""
    make = dict(_timed_cases())[kind]
    ls = make(linsys)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = linsys.Cg(ls, tol=1e-10)
    assert len(ls.timings["A"]) > 0
    assert ls.timings.get("A") >= 0
    A = helpers.matrix_spd()
    b = np.ones((10, 1))
    flags = dict(self_adjoint=True, positive_definite=True)
    jls = (jlinsys.TimedLinearSystem(A, b, **flags) if kind == "timed"
           else jlinsys.ConvertedTimedLinearSystem(
               jlinsys.LinearSystem(A, b, **flags)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsol = jlinsys.Cg(jls, tol=1e-10)
    np.testing.assert_allclose(sol.resnorms, jsol.resnorms, rtol=1e-10,
                               atol=1e3 * cc.EPS)
    np.testing.assert_allclose(sol.xk.numpy(), np.asarray(jsol.xk),
                               rtol=1e-10)


def test_timed_callable_inner_product():
    """A block-callable ``ip_B`` is timed per scalar, as in the JAX
    package."""
    A = helpers.matrix_spd()
    B = torch.tensor(np.diag(np.linspace(1, 5, 10)))
    ls = linsys.TimedLinearSystem(
        A, torch.ones((10, 1), dtype=torch.float64),
        ip_B=lambda X, Y: X.T @ (B @ Y), self_adjoint=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        linsys.Gmres(ls, tol=1e-10)
    assert len(ls.timings["ip_B"]) > 0


@pytest.mark.parametrize("solver_name", ["cg", "minres", "gmres"])
def test_matches_eager_lane(solver_name):
    """tests/test_functional.py:326 on the port's own two lanes: the
    functional and the compatibility lane agree on residual histories."""
    A = helpers.matrix_spd()
    b = A @ np.ones(10)
    res = getattr(F, solver_name)(torch.tensor(A), torch.tensor(b),
                                  tol=1e-12, maxiter=10)
    ls = linsys.LinearSystem(A, b.reshape(-1, 1), self_adjoint=True,
                             positive_definite=True, device="cpu")
    eager_cls = {"cg": linsys.Cg, "minres": linsys.Minres,
                 "gmres": linsys.Gmres}[solver_name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eager = eager_cls(ls, tol=1e-12, maxiter=10)
    n = int(res.niter)
    func_resnorms = res.resnorms[: n + 1].numpy()
    assert len(eager.resnorms) == n + 1
    np.testing.assert_allclose(func_resnorms, np.asarray(eager.resnorms),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res.x.numpy()[:, None],
                               eager.xk.numpy()[:, 0][:, None],
                               rtol=1e-8, atol=1e-10)


def test_results_live_on_the_system_device_in_the_callers_shape():
    """``xk``, ``V``, ``H`` and ``P``: tensors on the system's device
    (``H`` on the host), in the caller's ``(N, 1)`` convention; resnorms
    a list of floats."""
    A = helpers.matrix_spd()
    M = np.diag(np.linspace(1, 2, 10))
    ls = linsys.LinearSystem(A, np.ones(10), M=M, self_adjoint=True,
                             positive_definite=True, device="cpu")
    sol = linsys.Gmres(ls, tol=1e-10, store_arnoldi=True)
    assert isinstance(sol.resnorms, list)
    assert all(isinstance(r, float) for r in sol.resnorms)
    for t in (sol.xk, sol.V, sol.P):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert sol.xk.shape == (10, 1)
    assert isinstance(sol.H, np.ndarray)
    out = interop.compat_solver_to_numpy(sol)
    assert out["errnorms"] is None and out["V"].shape == tuple(sol.V.shape)
    assert "GMRES" in repr(sol) and "A:" in repr(ls)


def test_ops_operators_in_the_slots():
    """The port's matvec callables (``ops``) in ``A``, ``M``, ``Ml`` and
    ``Mr`` and a weight vector as a DiagonalLinearOperator in ``ip_B``: a
    callable applies column by column, in the right-hand side's dtype,
    and the solve is the functional lane's."""
    from krypy_tpu_torch import ops

    nx = 15
    lap = ops.poisson_2d(nx, device="cpu")
    mg = ops.multigrid_poisson_preconditioner(nx, coarsest=7,
                                              device="cpu")
    w = torch.linspace(1, 2, nx * nx, dtype=torch.float64)
    b = torch.ones(nx * nx, dtype=torch.float64)

    def A(x):
        return lap(x) / w.to(x.dtype)

    A.shape = lap.shape

    def M(r):
        return mg(w.to(r.dtype) * r)

    M.shape = lap.shape
    ls = linsys.LinearSystem(A, b, M=M,
                             ip_B=utils.DiagonalLinearOperator(w),
                             self_adjoint=True, positive_definite=True)
    assert ls.dtype == torch.float64
    sol = linsys.Cg(ls, tol=1e-8, maxiter=100)
    res = F.cg(A, b, M=M, ip=lambda x, y: torch.vdot(x, w * y), tol=1e-8,
               maxiter=100)
    assert len(sol.resnorms) - 1 == int(res.niter)
    np.testing.assert_allclose(sol.xk[:, 0].numpy(), res.x.numpy(),
                               rtol=1e-7)
    # float32 in: the Krylov vectors stay float32, the iterate and the
    # explicit residual are float64 (the JAX lane's identity slots and
    # zero x0 are float64)
    seen = []

    def A32(x):
        seen.append(x.dtype)
        return A(x)

    ls32 = linsys.LinearSystem(A32, b.float(), M=M, self_adjoint=True,
                               positive_definite=True)
    assert ls32.dtype == torch.float64
    sol32 = linsys.Cg(ls32, tol=1e-4, maxiter=50)
    assert sol32.xk.dtype == torch.float64
    k = len(sol32.resnorms) - 1
    assert seen.count(torch.float32) == k
    assert seen.count(torch.float64) == len(seen) - k >= 1
    # a block of columns through a callable slot
    X = torch.ones((nx * nx, 3), dtype=torch.float64)
    Y = ls.A * X
    np.testing.assert_allclose(Y[:, 2].numpy(), A(X[:, 2]).numpy())
