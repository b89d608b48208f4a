"""The one-reduce lane of the port against the JAX package in float64 on
the same numpy inputs: CG and MINRES with ``variant="1r"`` (Euclidean,
with an inner-product matrix, with ``M``), their ``fused_deflation``
built by :func:`krypy_tpu_torch.interop.fused_deflation_from_numpy` from
the JAX package's own deflation data, ``deflated_cg``/``deflated_minres``
with ``variant="1r"``, ``make_gram``, and the JAX package's
``ValueError``/``TypeError`` for what it refuses.

Tolerances: iteration counts and status equal; residual histories
``rtol=1e-10`` (``atol=1e-13`` for the final explicit residual at the
round-off floor, whose relative spread is ~1e-6 in the JAX package
itself when one ulp is added to ``b``); iterates ``1e-10`` relative.
MINRES with ``M``, with the inner-product matrix and the deflated MINRES
are rounding-steered (the JAX package's own history moves by 10% with
``M`` and up to 11x with ``ip`` under an ulp of ``b``, as
tests/test_torch_minres.py's docstring sets out for the classic
recurrence): there counts, status and iterates are compared, the
iterates to ``1e-9``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu.functional.common import make_gram as jmake_gram
from krypy_tpu.functional.deflation import build_deflation
from krypy_tpu.functional.gmres import FusedDeflation as JFusedDeflation
from krypy_tpu_torch import functional as F, interop, ops
from krypy_tpu_torch.functional.common import make_gram

torch.set_num_threads(1)

NX = 15
N = NX * NX


def _t(a):
    return interop.from_numpy(np.asarray(a), "cpu")


def _compare(rj, rt, rtol=1e-10, history=True):
    assert int(rt.niter) == int(rj.niter)
    assert int(rt.status) == int(rj.status)
    want = np.asarray(rj.resnorms)
    got = interop.to_numpy(rt.resnorms)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if history:
        live = ~np.isnan(want)
        np.testing.assert_allclose(got[live], want[live], rtol=rtol,
                                   atol=1e-13)
    xj, xt = np.asarray(rj.x), interop.to_numpy(rt.x)
    assert np.linalg.norm(xt - xj) <= rtol * np.linalg.norm(xj)


def _rhs(seed=0):
    return np.random.default_rng(seed).standard_normal(N)


def _weighted(solver):
    """A dense system of 40 unknowns, ``B^{-1} A`` with ``B`` diagonal in
    [1, 3], self-adjoint in ``<x, B y>`` (tests/test_torch_cg.py's weighted
    system; for MINRES ``A`` indefinite, eigenvalues in [-4, -1] and
    [1, 6]).  On the 15^2 operators a weighted solve needs ~80-100
    iterations, where an ulp of ``b`` moves the JAX package's own count."""
    n = 40
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((n, n))
    if solver == "cg":
        A = Q @ Q.T + n * np.eye(n)
    else:
        Q, _ = np.linalg.qr(Q)
        s = np.r_[np.linspace(-4.0, -1.0, 12), np.linspace(1.0, 6.0, n - 12)]
        A = (Q * s) @ Q.T
        A = (A + A.T) / 2
    B = np.diag(rng.uniform(1.0, 3.0, n))
    op = np.linalg.solve(B, A)
    b = rng.standard_normal(n)
    return (jnp.asarray(op), _t(op), b, dict(ip=jnp.asarray(B)),
            dict(ip=_t(B)))


def _system(solver, kind):
    """``(A_jax, A_torch, b, jax kwargs, torch kwargs)``: the Poisson
    operator for CG, the indefinite shifted Laplacian for MINRES; ``kind``
    "plain", "ip" (:func:`_weighted`) or "M" (a diagonal SPD ``M``)."""
    if kind == "ip":
        return _weighted(solver)
    if solver == "cg":
        Aj, At = jops.poisson_2d(NX), ops.poisson_2d(NX, device="cpu")
    else:
        Aj = jops.shifted_laplacian_2d(NX, sigma=60.0)
        At = ops.shifted_laplacian_2d(NX, sigma=60.0, device="cpu")
    d = np.random.default_rng(1).uniform(0.5, 2.0, N)
    kj, kt = {}, {}
    if kind == "M":
        kj["M"] = jops.diagonal(jnp.asarray(d))
        kt["M"] = ops.diagonal(_t(d))
    return Aj, At, _rhs(), kj, kt


@pytest.mark.parametrize("kind", ["plain", "ip", "M"])
@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_one_reduce_matches_jax(solver, kind):
    Aj, At, b, kj, kt = _system(solver, kind)
    kw = dict(tol=1e-10, maxiter=300, variant="1r")
    rj = getattr(JF, solver)(Aj, jnp.asarray(b), **kw, **kj)
    rt = getattr(F, solver)(At, _t(b), **kw, **kt)
    assert int(rt.status) == F.CONVERGED
    steered = solver == "minres" and kind != "plain"
    _compare(rj, rt, rtol=1e-9 if steered else 1e-10, history=not steered)


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_one_reduce_exact_solution_and_explicit_residual(solver):
    """``explicit_residual`` every iteration and the error norms, as in
    the classic recurrence."""
    Aj, At, b, _, _ = _system(solver, "plain")
    xs = np.random.default_rng(7).standard_normal(N)
    kw = dict(tol=1e-9, maxiter=60, variant="1r", explicit_residual=True)
    rj = getattr(JF, solver)(Aj, jnp.asarray(b),
                             exact_solution=jnp.asarray(xs), **kw)
    rt = getattr(F, solver)(At, _t(b), exact_solution=_t(xs), **kw)
    _compare(rj, rt)
    ej, et = np.asarray(rj.errnorms), interop.to_numpy(rt.errnorms)
    live = ~np.isnan(ej)
    np.testing.assert_array_equal(np.isnan(et), ~live)
    np.testing.assert_allclose(et[live], ej[live], rtol=1e-9, atol=1e-13)


def _fused(solver):
    """The JAX package's deflation data of a random 4-column basis on
    ``solver``'s operator, as both packages' ``FusedDeflation`` (the
    port's through interop) and both packages' projection of the initial
    residual."""
    Aj, At, b, _, _ = _system(solver, "plain")
    U = np.random.default_rng(4).standard_normal((N, 4))
    dj = build_deflation(Aj, jnp.asarray(U))
    Uo, W2, G = (np.asarray(a) for a in (dj.Uo, dj.W2, dj.G))
    fj = JFusedDeflation(UoT=dj.Uo.T, W2T=dj.W2.T, G=dj.G)
    ft = interop.fused_deflation_from_numpy(Uo.T, W2.T, G, device="cpu")
    assert ft.UoT.is_contiguous() and ft.UoT.dtype == torch.float64

    def proj(lib, t):
        def once(r):
            return r - t(W2) @ lib.linalg.solve(t(G), t(Uo).T @ r)
        return lambda r: once(once(r))

    return (Aj, At, b, fj, ft, proj(jnp, jnp.asarray), proj(torch, _t))


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_fused_deflation_matches_jax(solver):
    """The same deflation data folded into both packages' one-reduce
    products, with the projected initial residual: equal counts and
    status, histories to 1e-10 (CG; MINRES's are rounding-steered)."""
    Aj, At, b, fj, ft, pj, pt = _fused(solver)
    kw = dict(tol=1e-10, maxiter=120, variant="1r")
    rj = getattr(JF, solver)(Aj, jnp.asarray(b), fused_deflation=fj,
                             projected_r0=pj, **kw)
    rt = getattr(F, solver)(At, _t(b), fused_deflation=ft, projected_r0=pt,
                            **kw)
    _compare(rj, rt, rtol=1e-9, history=solver == "cg")


@pytest.mark.parametrize("variant", ["classic", "1r"])
@pytest.mark.parametrize("solver", ["deflated_cg", "deflated_minres"])
def test_deflated_short_recurrences_match_jax(solver, variant):
    """``variant="1r"`` takes the fused path in both packages (the
    classic one the operator hook): against JAX with the random 4-column
    basis; the fused deflated CG needs the classic one's iterations."""
    core = solver.split("_")[1]
    Aj, At, b, _, _ = _system(core, "plain")
    U = np.random.default_rng(4).standard_normal((N, 4))
    kw = dict(tol=1e-10, maxiter=300, variant=variant)
    rj = getattr(JF, solver)(Aj, jnp.asarray(b), jnp.asarray(U), **kw)
    rt = getattr(F, solver)(At, _t(b), _t(U), **kw)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt, rtol=1e-9, history=core == "cg")
    if variant == "1r" and core == "cg":
        classic = F.deflated_cg(At, _t(b), _t(U), tol=1e-10, maxiter=300)
        assert abs(int(rt.niter) - int(classic.niter)) <= 1


@pytest.mark.parametrize("ip", ["none", "matrix"])
def test_make_gram_matches_jax(ip):
    rng = np.random.default_rng(9)
    L, R = rng.standard_normal((3, 50)), rng.standard_normal((4, 50))
    B = np.diag(rng.uniform(1.0, 2.0, 50))
    ipj, ipt = (None, None) if ip == "none" else (jnp.asarray(B), _t(B))
    got = interop.to_numpy(make_gram(ipt)(_t(L), _t(R)))
    want = np.asarray(jmake_gram(ipj)(jnp.asarray(L), jnp.asarray(R)))
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    with pytest.raises(TypeError):
        jmake_gram(lambda x, y: x @ y)
    with pytest.raises(TypeError, match="one-reduce"):
        make_gram(lambda x, y: x @ y)


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("case", [
    "1r_scalar_ip", "fused_without_1r", "fused_with_override",
    "unknown_variant"])
@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_errors_match_jax(solver, case):
    """The JAX package's ``ValueError`` where it raises one."""
    Aj, At, b, fj, ft, _, _ = _fused(solver)
    kj, kt = {
        "1r_scalar_ip": (dict(variant="1r", ip=lambda x, y: jnp.vdot(x, y)),
                         dict(variant="1r", ip=lambda x, y: torch.vdot(x, y))),
        "fused_without_1r": (dict(fused_deflation=fj),
                             dict(fused_deflation=ft)),
        "fused_with_override": (
            dict(variant="1r", fused_deflation=fj,
                 operator_override=lambda v: v),
            dict(variant="1r", fused_deflation=ft,
                 operator_override=lambda v: v)),
        "unknown_variant": (dict(variant="pipelined"),
                            dict(variant="pipelined")),
    }[case]
    want = _error(lambda: getattr(JF, solver)(Aj, jnp.asarray(b), maxiter=2,
                                              **kj))
    got = _error(lambda: getattr(F, solver)(At, _t(b), maxiter=2, **kt))
    assert want is ValueError and got is want


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_auto_is_classic_off_a_mesh(solver):
    """``variant="auto"`` outside a mesh is the classic recurrence, bit
    for bit (the mesh's choice: tests/test_torch_parallel.py)."""
    _, At, b, _, _ = _system(solver, "plain")
    kw = dict(tol=1e-8, maxiter=200)
    ra = getattr(F, solver)(At, _t(b), variant="auto", **kw)
    rc = getattr(F, solver)(At, _t(b), variant="classic", **kw)
    assert torch.equal(ra.x, rc.x) and int(ra.niter) == int(rc.niter)
