"""The port's MINRES (krypy_tpu_torch.functional.minres) and deflated
MINRES against krypy_tpu.functional in float64 on the same numpy inputs:
the same iteration count and status, residual histories to ``rtol =
1e-9`` and solutions to ``1e-9 * |x|``.  Float64 reductions summed in
another order differ by round-off, many digits below both bounds; a
history entry at the round-off floor itself (the final explicit residual
of a solve to 1e-10 or an exact step) carries the absolute ``1e-13`` of
tests/test_torch_cg.py beside the relative bound.

Inputs: the 2-D Poisson operator at 31^2; the README system (golden of
tests/test_functional.py:27); an indefinite ``Q diag(s) Q^T`` of 300
unknowns with ``s`` in [-4, -1] and [1, 6], plain, with a Jacobi ``M`` and
split ``Ml``/``Mr``; config 2's weighted Poisson ``W^{-1} Lap`` at 31^2
with the inner product ``<x, W y>`` as a matrix and as a callable.

MINRES runs in a regime where rounding steers the iteration once it needs
more iterations than the operator has distinct eigenvalues, or once its
Ritz values have converged: there the JAX package's own residual history
moves by 84% (tests/test_functional.py:176's 80-unknown system, 96
iterations) or 1% (the weighted Poisson operator at 31^2 without ``M``,
104 iterations to 1e-6) when one ulp is added to ``b``.  Histories are
compared where that does not happen; tests/test_functional.py:176's
system is held to its own test's bounds (count and status, iterate to
1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, interop, ops

torch.set_num_threads(1)


def _t(a):
    return interop.from_numpy(np.asarray(a), "cpu")


def _compare(rj, rt, rtol=1e-9):
    assert int(rt.niter) == int(rj.niter)
    assert int(rt.status) == int(rj.status)
    want = np.asarray(rj.resnorms)
    got = interop.to_numpy(rt.resnorms)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], rtol=rtol, atol=1e-13)
    xj, xt = np.asarray(rj.x), interop.to_numpy(rt.x)
    assert xt.shape == xj.shape
    # an iterate that is zero in exact arithmetic carries only round-off
    assert np.linalg.norm(xt - xj) <= rtol * np.linalg.norm(xj) + 1e-13
    if rj.errnorms is None:
        assert rt.errnorms is None
    else:
        ej, et = np.asarray(rj.errnorms), interop.to_numpy(rt.errnorms)
        live = ~np.isnan(ej)
        np.testing.assert_array_equal(np.isnan(et), ~live)
        np.testing.assert_allclose(et[live], ej[live], rtol=rtol, atol=1e-13)


def _indefinite(variant):
    """The indefinite 300-unknown system for ``variant``: ``(A, b, jax
    kwargs, torch kwargs)``."""
    rng = np.random.default_rng(11)
    N = 300
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    s = np.r_[np.linspace(-4.0, -1.0, 90), np.linspace(1.0, 6.0, N - 90)]
    A = (Q * s) @ Q.T
    A = (A + A.T) / 2
    b = rng.standard_normal(N)
    kj, kt = {}, {}
    if variant == "jacobi":
        d = np.abs(np.diag(A)) + 1.0
        kj["M"] = lambda x: x / jnp.asarray(d)
        kt["M"] = lambda x: x / _t(d)
    elif variant == "split":
        d = np.linspace(1, 2, N)
        kj["Ml"] = kj["Mr"] = lambda x: x / jnp.asarray(d)
        kt["Ml"] = kt["Mr"] = lambda x: x / _t(d)
        A = d[:, None] * A * d[None, :]
    return A, b, kj, kt


def _weighted(kind):
    """Config 2's system at 31^2: ``W^{-1} Lap x = b`` with ``M = V(w r)``
    (the unpadded V-cycle), self-adjoint in ``<x, W y>`` given as a matrix
    or as a callable.  Returns the JAX and the torch ``(A, b, kwargs)``."""
    nx = 31
    N = nx * nx
    b = np.random.default_rng(0).standard_normal(N)
    w = np.linspace(1.0, 2.0, N)
    Aj, At = jops.poisson_2d(nx), ops.poisson_2d(nx, device="cpu")
    kw = dict(coarsest=7, coarse_sweeps=12)
    Mj = jops.multigrid_poisson_preconditioner(nx, **kw)
    Mt = ops.multigrid_poisson_preconditioner(nx, device="cpu", **kw)
    wj, wt = jnp.asarray(w), _t(w)
    if kind == "matrix":
        ipj, ipt = jnp.diag(wj), torch.diag(wt)
    else:
        def ipj(x, y):
            return jnp.vdot(x, wj * y)

        def ipt(x, y):
            return torch.vdot(x, wt * y)
    return ((lambda x: Aj(x) / wj, jnp.asarray(b),
             dict(M=lambda r: Mj(wj * r), ip=ipj)),
            (lambda x: At(x) / wt, _t(b),
             dict(M=lambda r: Mt(wt * r), ip=ipt)))


@pytest.mark.parametrize("variant", ["plain", "jacobi", "split"])
def test_minres_indefinite_matches_jax(variant):
    A, b, kj, kt = _indefinite(variant)
    kw = dict(tol=1e-9, maxiter=300)
    rj = JF.minres(jnp.asarray(A), jnp.asarray(b), **kj, **kw)
    rt = F.minres(_t(A), _t(b), **kt, **kw)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt)


@pytest.mark.parametrize("kind", ["matrix", "callable"])
def test_minres_weighted_inner_product_matches_jax(kind):
    (Aj, bj, kj), (At, bt, kt) = _weighted(kind)
    rj = JF.minres(Aj, bj, tol=1e-10, maxiter=100, **kj)
    rt = F.minres(At, bt, tol=1e-10, maxiter=100, **kt)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt)


def test_minres_reference_indefinite_system():
    """tests/test_functional.py:176's system, ``Q diag(linspace(-40, 60,
    80)) Q^T``, to tol 1e-9: 96 iterations for 80 unknowns, the same count
    and status, the iterate to that test's 1e-7 (histories not compared:
    module docstring)."""
    rng = np.random.default_rng(11)
    N = 80
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    A = (Q * np.linspace(-40, 60, N)) @ Q.T
    A = (A + A.T) / 2
    b = rng.standard_normal(N)
    rj = JF.minres(jnp.asarray(A), jnp.asarray(b), tol=1e-9, maxiter=300)
    rt = F.minres(_t(A), _t(b), tol=1e-9, maxiter=300)
    assert int(rt.niter) == int(rj.niter)
    assert int(rt.status) == int(rj.status) == F.CONVERGED
    xj = np.asarray(rj.x)
    assert np.linalg.norm(interop.to_numpy(rt.x) - xj) <= \
        1e-7 * np.linalg.norm(xj)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_minres_poisson_matches_jax(precond):
    nx = 31
    b = np.random.default_rng(0).standard_normal(nx * nx)
    Aj, At = jops.poisson_2d(nx), ops.poisson_2d(nx, device="cpu")
    kj = {} if precond is None else dict(M=jops.jacobi_preconditioner(Aj))
    kt = {} if precond is None else dict(M=ops.jacobi_preconditioner(At))
    rj = JF.minres(Aj, jnp.asarray(b), tol=1e-10, maxiter=300, **kj)
    rt = F.minres(At, _t(b), tol=1e-10, maxiter=300, **kt)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt)


def test_minres_readme_golden():
    """tests/test_functional.py's golden: ``sum |x|`` of the README
    system at tol 1e-5."""
    A = np.diag([1.0e-3] + list(range(2, 101)))
    b = np.ones(100)
    rt = F.minres(_t(A), _t(b), tol=1e-5)
    assert int(rt.status) == F.CONVERGED
    golden = 1004.187372488912
    assert abs(float(rt.x.abs().sum()) - golden) < 1e-11 * golden
    _compare(JF.minres(jnp.asarray(A), jnp.asarray(b), tol=1e-5), rt)


@pytest.mark.parametrize("explicit", [False, True])
def test_minres_x0_ml_mr_exact_solution_match_jax(explicit):
    """An initial guess, split preconditioning, error-norm tracking, the
    explicit residual every iteration or only where the reference takes
    it."""
    A, b, kj, kt = _indefinite("split")
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(b.shape[0])
    xs = np.linalg.solve(A, b)
    kw = dict(tol=1e-9, maxiter=300, explicit_residual=explicit)
    rj = JF.minres(jnp.asarray(A), jnp.asarray(b), x0=jnp.asarray(x0),
                   exact_solution=jnp.asarray(xs), **kj, **kw)
    rt = F.minres(_t(A), _t(b), x0=_t(x0), exact_solution=_t(xs), **kt,
                  **kw)
    _compare(rj, rt)


def _symmetric_pairs():
    """``diag(-5..-1, 1..5) x = ones``: a spectrum symmetric about zero,
    on which MINRES makes no progress on every odd iteration (the
    residual repeats exactly), and its ten distinct eigenvalues."""
    return np.diag(np.r_[-np.arange(5, 0, -1.0), np.arange(1, 6.0)]), \
        np.ones(10)


@pytest.mark.parametrize("window", [1, 2])
def test_minres_stagnation_window_matches_jax(window):
    """``stagnation_window=1`` stops at the first iteration that does not
    improve (the first); ``2`` runs on to the invariant subspace."""
    A, b = _symmetric_pairs()
    kw = dict(tol=1e-30, stagnation_window=window)
    rj = JF.minres(jnp.asarray(A), jnp.asarray(b), **kw)
    rt = F.minres(_t(A), _t(b), **kw)
    _compare(rj, rt)
    assert int(rt.niter) == (1 if window == 1 else 10)


def test_minres_invariant_stop_matches_jax():
    """Three distinct eigenvalues: the Krylov space is invariant after
    three iterations, short of a tolerance of 1e-30: BREAKDOWN."""
    A = np.diag(np.repeat([1.0, 2.0, 5.0], 10))
    b = np.ones(30)
    rj = JF.minres(jnp.asarray(A), jnp.asarray(b), tol=1e-30)
    rt = F.minres(_t(A), _t(b), tol=1e-30)
    assert int(rt.niter) == 3 and int(rt.status) == F.BREAKDOWN
    _compare(rj, rt)


def test_minres_zero_rhs_and_column_shape():
    """b = 0 converges at once with x = 0; an ``(N, 1)`` right-hand side
    gives an ``(N, 1)`` x."""
    A = ops.poisson_2d(7, device="cpu")
    res = F.minres(A, torch.zeros(49, dtype=torch.float64))
    assert int(res.niter) == 0 and int(res.status) == F.CONVERGED
    assert not bool(res.x.any())
    col = F.minres(A, torch.ones((49, 1), dtype=torch.float64), tol=1e-10)
    flat = F.minres(A, torch.ones(49, dtype=torch.float64), tol=1e-10)
    assert col.x.shape == (49, 1)
    assert torch.equal(col.x[:, 0], flat.x)


def test_minres_progress_prints_what_jax_prints(capsys):
    """``progress=True`` prints each iteration's relative residual, the
    JAX package's lines to the digits printed."""
    nx = 15
    b = np.random.default_rng(2).standard_normal(nx * nx)
    JF.minres(jops.poisson_2d(nx), jnp.asarray(b), tol=1e-8, progress=True)
    jax.effects_barrier()
    want = capsys.readouterr().out.splitlines()
    F.minres(ops.poisson_2d(nx, device="cpu"), _t(b), tol=1e-8,
             progress=True)
    got = capsys.readouterr().out.splitlines()
    assert len(want) > 10 and got == want


def _deflation_basis(A_rows=300):
    """Three vectors near the eigenvectors of ``_indefinite``'s three
    eigenvalues nearest zero (what a recycled Ritz basis holds), each
    perturbed by 1e-2 noise; a basis of random vectors makes MINRES need
    more iterations than undeflated, in the regime the module docstring
    describes."""
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((A_rows, A_rows)))
    s = np.r_[np.linspace(-4.0, -1.0, 90), np.linspace(1.0, 6.0, A_rows - 90)]
    idx = np.argsort(np.abs(s))[:3]
    return Q[:, idx] + 1e-2 * np.random.default_rng(12).standard_normal(
        (A_rows, 3))


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_deflated_minres_matches_jax(precond):
    """``deflated_minres`` on the indefinite system with a 3-vector basis
    carried across by ``interop.basis_from_numpy``; with ``M`` the basis is
    orthonormalized in the ``Minv`` product, as the JAX package asks."""
    A, b, kj, kt = _indefinite("plain" if precond is None else "jacobi")
    if precond:
        d = np.abs(np.diag(A)) + 1.0
        kj["Minv"] = lambda x: x * jnp.asarray(d)
        kt["Minv"] = lambda x: x * _t(d)
    U = _deflation_basis()
    kw = dict(tol=1e-9, maxiter=300, variant="auto")
    rj = JF.deflated_minres(jnp.asarray(A), jnp.asarray(b), jnp.asarray(U),
                            **kj, **kw)
    rt = F.deflated_minres(_t(A), _t(b), interop.basis_from_numpy(U, "cpu"),
                           **kt, **kw)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt)
    # the deflated solve needs fewer iterations than the undeflated one
    assert int(rt.niter) < int(F.minres(_t(A), _t(b), tol=1e-9, maxiter=300,
                                        **{k: v for k, v in kt.items()
                                           if k != "Minv"}).niter)


def test_minres_options_that_raise():
    """``variant="1r"`` runs now (against the JAX package's solve),
    ``fused_deflation`` without it raises the JAX package's
    ``ValueError``, an unknown variant raises, and ``"auto"`` off a mesh
    is the classic recurrence."""
    A, b = ops.poisson_2d(7, device="cpu"), torch.ones(49,
                                                       dtype=torch.float64)
    Aj, bj = jops.poisson_2d(7), jnp.ones(49)
    _compare(JF.minres(Aj, bj, variant="1r", tol=1e-10),
             F.minres(A, b, variant="1r", tol=1e-10))
    for fn, args in ((JF.minres, (Aj, bj)), (F.minres, (A, b))):
        with pytest.raises(ValueError, match="fused_deflation requires"):
            fn(*args, fused_deflation=object())
    with pytest.raises(ValueError):
        F.minres(A, b, variant="pipelined")
    assert int(F.minres(A, b, variant="auto", tol=1e-8).status) == \
        F.CONVERGED