"""The port's GMRES-polynomial preconditioner
(``krypy_tpu_torch.ops.gmres_polynomial_preconditioner``) against the JAX
package on the CPU, on every case of tests/test_polyprecond.py, float64
(complex128 where the reference case is complex).

Tolerances: the Leja-ordered roots to ``1e-9`` relative (harmonic Ritz
values from the two packages' float64 Arnoldi relations, which agree to
~1e-14; the small eigenproblem's conditioning amplifies that); the
application to ``1e-12`` of its norm; the outer solves' counts and
statuses equal and iterates to ``1e-10`` of their largest entry (the
preconditioner built from the JAX roots through
``interop.gmres_polynomial_from_numpy`` and from the port's own roots
agree to ``1e-12``); then each reference case's own assertions on the
port's objects.
"""

import numpy as np
import pytest
import torch

from krypy_tpu_torch import functional as F, interop, ops

jax = pytest.importorskip("jax")
jnp = jax.numpy

ROOT_RTOL, APPLY_RTOL, X_RTOL = 1e-9, 1e-12, 1e-10


def _J():
    from krypy_tpu import functional as JF, ops as jops

    return JF, jops


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _hold_roots(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ROOT_RTOL,
                               atol=ROOT_RTOL * np.abs(want).max())


def _hold_apply(Pt, Pj, v):
    got, want = _np(Pt(_t(v))), np.asarray(Pj(jnp.asarray(v)))
    assert np.linalg.norm(got - want) <= APPLY_RTOL * np.linalg.norm(want)


def _hold_solve(got, want):
    assert int(got.niter) == int(want.niter)
    assert int(got.status) == int(want.status)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(_np(got.x), xw, rtol=0,
                               atol=X_RTOL * np.abs(xw).max())


def _moderate_nonsym(n=600, seed=0):
    rng = np.random.default_rng(seed)
    d = np.linspace(1.0, 100.0, n)
    S = rng.standard_normal((n, n)) * 0.5 / np.sqrt(n)
    A = np.diag(d) + S - S.T
    b = rng.standard_normal(n)
    return A, b


@pytest.fixture(scope="module")
def nonsym():
    """tests/test_polyprecond.py's 600 x 600 nonsymmetric system, both
    packages' degree-8 preconditioners from the seed b, and the JAX
    package's solves."""
    JF, jops = _J()
    A, b = _moderate_nonsym()
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    Pj = jops.gmres_polynomial_preconditioner(Aj, 8, seed=bj)
    Pt = ops.gmres_polynomial_preconditioner(_t(A), 8, seed=_t(b))
    want = {
        "plain": jax.jit(lambda v: JF.gmres(Aj, v, tol=1e-10,
                                            maxiter=400))(bj),
        "gmres": jax.jit(lambda v: JF.gmres(Aj, v, Mr=Pj, tol=1e-10,
                                            maxiter=100))(bj),
        "ca_gmres": jax.jit(lambda v: JF.ca_gmres(
            Aj, v, Mr=Pj, s=4, basis="newton", tol=1e-9,
            maxiter=40))(bj)}
    return A, b, Pj, Pt, want


def test_full_degree_is_exact_inverse_as_jax():
    _, jops = _J()
    d = np.array([1.0, 2.0, 3.0, 5.0, 8.0, 13.0])
    rng = np.random.default_rng(0)
    seed = rng.standard_normal(6)
    Pj = jops.gmres_polynomial_preconditioner(jnp.diag(jnp.asarray(d)), 6,
                                              seed=jnp.asarray(seed))
    P = ops.gmres_polynomial_preconditioner(_t(np.diag(d)), 6, seed=_t(seed))
    _hold_roots(P.roots, Pj.roots)
    assert P.degree == Pj.degree == 6
    assert np.allclose(np.sort(P.roots.real), d, atol=1e-10)
    v = rng.standard_normal(6)
    _hold_apply(P, Pj, v)
    assert float(np.linalg.norm(_np(P(_t(v))) - v / d)) < 1e-12


def test_partial_degree_matches_dense_construction_and_jax():
    _, jops = _J()
    rng = np.random.default_rng(1)
    n = 30
    Am = np.diag(np.linspace(1, 10, n)) + 0.1 * rng.standard_normal((n, n))
    seed = rng.standard_normal(n)
    Pj = jops.gmres_polynomial_preconditioner(jnp.asarray(Am), 6,
                                              seed=jnp.asarray(seed))
    P = ops.gmres_polynomial_preconditioner(_t(Am), 6, seed=_t(seed))
    _hold_roots(P.roots, Pj.roots)
    piA = np.eye(n, dtype=complex)
    for th in P.roots:
        piA = piA @ (np.eye(n) - Am / th)
    pA = (np.eye(n) - piA) @ np.linalg.inv(Am)
    assert np.abs(pA.imag).max() < 1e-10
    v = rng.standard_normal(n)
    out = _np(P(_t(v)))
    assert np.linalg.norm(out - pA.real @ v) <= 1e-12 * np.linalg.norm(
        pA.real @ v)
    _hold_apply(P, Pj, v)


def test_outer_iterations_drop_with_degree_as_jax(nonsym):
    A, b, Pj, Pt, want = nonsym
    _hold_roots(Pt.roots, Pj.roots)
    r0 = F.gmres(_t(A), _t(b), tol=1e-10, maxiter=400)
    _hold_solve(r0, want["plain"])
    r = F.gmres(_t(A), _t(b), Mr=Pt, tol=1e-10, maxiter=100)
    _hold_solve(r, want["gmres"])
    assert int(r.status) == 0
    assert int(r.niter) * 3 < int(r0.niter)
    assert np.linalg.norm(b - A @ _np(r.x)) / np.linalg.norm(b) <= 1e-9


def test_pairs_with_ca_gmres_as_jax(nonsym):
    A, b, Pj, Pt, want = nonsym
    r = F.ca_gmres(_t(A), _t(b), Mr=Pt, s=4, basis="newton", tol=1e-9,
                   maxiter=40)
    _hold_solve(r, want["ca_gmres"])
    assert int(r.status) == 0
    assert np.linalg.norm(b - A @ _np(r.x)) / np.linalg.norm(b) <= 1e-8


def test_roots_cross_from_the_jax_build(nonsym):
    """The port's preconditioner on the JAX build's roots
    (``interop.gmres_polynomial_from_numpy``) applies as the JAX one and
    as the port's own build."""
    A, b, Pj, Pt, _ = nonsym
    Px = interop.gmres_polynomial_from_numpy(_t(A), Pj.roots)
    v = np.random.default_rng(5).standard_normal(A.shape[0])
    _hold_apply(Px, Pj, v)
    got, own = _np(Px(_t(v))), _np(Pt(_t(v)))
    assert np.linalg.norm(got - own) <= 1e-12 * np.linalg.norm(own)
    assert Px.degree == Pj.degree and Px.shape == (600, 600)


def test_complex_operator_as_jax():
    JF, jops = _J()
    rng = np.random.default_rng(2)
    n = 200
    d = np.linspace(1, 40, n) + 1j * rng.standard_normal(n)
    Am = np.diag(d) + 0.1 * (rng.standard_normal((n, n))
                             + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    Pj = jops.gmres_polynomial_preconditioner(jnp.asarray(Am), 8,
                                              seed=jnp.asarray(b))
    P = ops.gmres_polynomial_preconditioner(_t(Am), 8, seed=_t(b))
    _hold_roots(P.roots, Pj.roots)
    _hold_apply(P, Pj, b)
    want = jax.jit(lambda v: JF.gmres(jnp.asarray(Am), v, Mr=Pj, tol=1e-10,
                                      maxiter=60))(jnp.asarray(b))
    r = F.gmres(_t(Am), _t(b), Mr=P, tol=1e-10, maxiter=60)
    _hold_solve(r, want)
    assert int(r.status) == 0
    assert np.linalg.norm(b - Am @ _np(r.x)) / np.linalg.norm(b) <= 1e-9


def test_requires_size_information():
    _, jops = _J()
    with pytest.raises(ValueError, match="seed"):
        jops.gmres_polynomial_preconditioner(lambda v: v, 4)
    with pytest.raises(ValueError, match="seed"):
        ops.gmres_polynomial_preconditioner(lambda v: v, 4)


def test_stability_check_flags_explosive_products_as_jax():
    _, jops = _J()
    rng = np.random.default_rng(3)
    n = 400
    d = np.r_[1e-6 * (1.0 + 1e-3 * np.arange(n - 1)), 1e3]
    seed = rng.standard_normal(n)
    for pkg, A, sd in ((jops, jnp.asarray(np.diag(d)), jnp.asarray(seed)),
                       (ops, _t(np.diag(d)), _t(seed))):
        with pytest.raises(ValueError, match="growth"):
            pkg.gmres_polynomial_preconditioner(A, 12, seed=sd)
    Pj = jops.gmres_polynomial_preconditioner(
        jnp.asarray(np.diag(d)), 12, seed=jnp.asarray(seed),
        stability_check=False)
    P = ops.gmres_polynomial_preconditioner(_t(np.diag(d)), 12, seed=_t(seed),
                                            stability_check=False)
    assert P.degree == Pj.degree == 12
    # the cluster's roots spread over ~1e-9 at 1e-6: relative to the
    # largest root, as the two Arnoldi relations agree
    np.testing.assert_allclose(np.sort_complex(P.roots),
                               np.sort_complex(Pj.roots), rtol=0,
                               atol=ROOT_RTOL * np.abs(Pj.roots).max())


def test_default_seed_follows_operator_dtype_as_jax():
    """No seed: ones in the operator's dtype, which the port reads off one
    application to a float32 zero vector on the operator's device (the
    JAX package's ``jax.eval_shape``)."""
    JF, jops = _J()
    rng = np.random.default_rng(4)
    n = 120
    d = np.linspace(1, 30, n) + 1j * rng.standard_normal(n) * 0.3
    Am = np.diag(d)
    Pj = jops.gmres_polynomial_preconditioner(jnp.asarray(Am), 6)
    P = ops.gmres_polynomial_preconditioner(_t(Am), 6)
    _hold_roots(P.roots, Pj.roots)
    assert np.iscomplexobj(P.roots)
    assert np.abs(P.roots.imag).max() > 1e-3
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = jax.jit(lambda v: JF.gmres(jnp.asarray(Am), v, Mr=Pj, tol=1e-10,
                                      maxiter=60))(jnp.asarray(b))
    r = F.gmres(_t(Am), _t(b), Mr=P, tol=1e-10, maxiter=60)
    _hold_solve(r, want)
    assert int(r.status) == 0
    # a float32 stencil keeps float32; the seed lives on the operator's
    # device (its .diag's here)
    lap = ops.poisson_2d(8, device="cpu")
    P32 = ops.gmres_polynomial_preconditioner(lap, 4)
    assert P32(torch.ones(64)).dtype == torch.float32
    Pj32 = jops.gmres_polynomial_preconditioner(jops.poisson_2d(8), 4)
    # float32 Arnoldi relations on both sides: the roots to 1e-4 of the
    # largest
    np.testing.assert_allclose(P32.roots, Pj32.roots, rtol=0,
                               atol=1e-4 * np.abs(Pj32.roots).max())


def test_default_seed_goes_to_the_card():
    """A bare callable without a device goes to ``"cuda"``: where torch
    sees no card the build raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the seed goes there")
    op = lambda v: v  # noqa: E731
    op.shape = (8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.gmres_polynomial_preconditioner(op, 2)
