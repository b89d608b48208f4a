"""The port's spectral module (krypy_tpu_torch.spectral) against
krypy_tpu.spectral on the cases of tests/test_spectral.py (and the
``angles`` / ``hegedus`` cases of tests/test_core.py), float64 /
complex128 on the same numpy inputs.

Both packages get the same Arnoldi relation (the JAX package's
``arnoldi``, handed over as numpy), so ``ritz`` is compared on the same
``H`` and ``V``.  Tolerances: Ritz values, residual norms and Ritz vectors
1e-12 of ``||A||`` (the non-Hermitian and generalized problems run the
same host LAPACK on both sides; the Hermitian one runs ``eigh`` of two
libraries, so eigenvector columns are compared up to a unit factor);
principal angles 1e-12 (two SVD implementations), the port's principal
vectors by their own identity ``<U, V> = diag(cos theta)`` to 1e-14 as
test_core.py holds the JAX ones; ``hegedus`` 1e-12 relative; the host
numpy tools (gap, intervals, bounds, polynomial, residual replay) equal,
and BASELINE.md's two bound regression values to 1e-12 relative.
"""

import functools
from math import ceil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import utils as ju
from krypy_tpu_torch import spectral as S
from krypy_tpu_torch.core import operators as O

from helpers import (
    get_ip_Bs,
    get_matrices,
    matrix_comp_nonsymm,
    matrix_nonsymm,
    matrix_spd,
)

torch.set_num_threads(1)

_B = np.diag(np.linspace(1, 5, 10))
_matrices = {"spd": matrix_spd(), "nonsymm": matrix_nonsymm(),
             "comp_nonsymm": matrix_comp_nonsymm()}


def _t(a):
    return torch.as_tensor(np.array(a))


def _ip_pair(i):
    Bt = _t(_B)

    def ip(x, y):
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.conj().T.to(dt) @ (Bt.to(dt) @ y.to(dt))

    port = [None, O.MatrixLinearOperator(_B, device="cpu"), ip][i]
    return port, get_ip_Bs()[i]


@functools.lru_cache(maxsize=None)
def _arnoldi(name, vkind, maxiter, ip):
    A = _matrices[name]
    v = np.ones((10, 1)) if vkind == "ones" else np.eye(10, 1)
    ipj = get_ip_Bs()[ip]
    V, H = ju.arnoldi(A, jnp.asarray(v), maxiter=maxiter,
                      ortho="house" if ipj is None else "dmgs", ip_B=ipj)
    return np.asarray(V), np.asarray(H)


@functools.lru_cache(maxsize=None)
def _jax_ritz(name, vkind, maxiter, ip, type):
    """The JAX package's Ritz pairs (its ``V`` only adds ``Z = V U``)."""
    V, H = _arnoldi(name, vkind, maxiter, ip)
    out = ju.ritz(jnp.asarray(H), hermitian=name == "spd", type=type)
    return tuple(np.asarray(a) for a in out)


def _unit_align(U, ref):
    """Columns of ``U`` times the unit factor that best aligns them with
    the columns of ``ref``."""
    phase = np.sum(ref.conj() * U, axis=0)
    phase = np.where(np.abs(phase) == 0, 1.0, phase / np.abs(phase))
    return U / phase[None, :]


@pytest.mark.parametrize("name", list(_matrices))
@pytest.mark.parametrize("vkind", ["ones", "e1"])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("ip", [0, 1, 2])
@pytest.mark.parametrize("with_V", [True, False])
@pytest.mark.parametrize("type", ["ritz", "harmonic", "harmonic_improved"])
def test_ritz_matches_jax(name, vkind, maxiter, ip, with_V, type):
    hermitian = name == "spd"
    V, H = _arnoldi(name, vkind, maxiter, ip)
    An = np.linalg.norm(_matrices[name], 2)
    kw = dict(hermitian=hermitian, type=type)
    tj, Uj, rj = _jax_ritz(name, vkind, maxiter, ip, type)
    if with_V:
        tt, Ut, rt, Zt = S.ritz(_t(H), V=_t(V), **kw)
    else:
        tt, Ut, rt = S.ritz(_t(H), **kw)
    tt, Ut, rt = (a.numpy() for a in (tt, Ut, rt))
    assert tt.shape == tj.shape and Ut.shape == Uj.shape
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12 * An)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-12 * An)
    Ua = _unit_align(Ut, Uj)
    np.testing.assert_allclose(Ua, Uj, rtol=0, atol=1e-12)
    if with_V:
        n = H.shape[1]
        np.testing.assert_allclose(Zt.numpy(), V[:, :n] @ Ut, rtol=0,
                                   atol=1e-13)


_FGs = [np.eye(10, 1), 1j * np.eye(10, 1), np.eye(10, 4),
        np.eye(10)[:, -4:], np.eye(10, 4) @ np.diag([1, 1e1, 1e2, 1e3])]


@functools.lru_cache(maxsize=None)
def _jax_angles(fi, gi, ip):
    """The JAX package's angles (``compute_vectors`` does not change
    them)."""
    return np.asarray(ju.angles(_FGs[fi], _FGs[gi], ip_B=get_ip_Bs()[ip]))


@pytest.mark.parametrize("ip", [0, 1, 2])
@pytest.mark.parametrize("compute_vectors", [False, True])
@pytest.mark.parametrize("fi", range(5))
@pytest.mark.parametrize("gi", range(5))
def test_angles_match_jax(fi, gi, ip, compute_vectors):
    F, G = _FGs[fi], _FGs[gi]
    ipt = _ip_pair(ip)[0]
    out_t = S.angles(_t(F), _t(G), ip_B=ipt, compute_vectors=compute_vectors)
    tj = _jax_angles(fi, gi, ip)
    tt = (out_t[0] if compute_vectors else out_t).numpy()
    assert tt.shape == tj.shape == (max(F.shape[1], G.shape[1]),)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-12)
    if compute_vectors:
        U, V = out_t[1], out_t[2]
        assert tuple(U.shape) == F.shape and tuple(V.shape) == G.shape
        from krypy_tpu_torch.core.products import inner

        UV = inner(U, V, ip_B=ipt).numpy()
        want = np.diag(np.cos(tt))[: F.shape[1], : G.shape[1]]
        assert np.linalg.norm(UV - want) <= 1e-14 * 10


def _get_m():
    m = np.arange(1, 11).astype(float)
    m[-1] = 1.0
    return m


@pytest.mark.parametrize(
    "mi", range(3))
@pytest.mark.parametrize("xi", range(2))
@pytest.mark.parametrize("x0i", range(4))
@pytest.mark.parametrize("with_M", [False, True])
@pytest.mark.parametrize("with_Ml", [False, True])
@pytest.mark.parametrize("ip", [0, 1, 2])
def test_hegedus_matches_jax(mi, xi, x0i, with_M, with_Ml, ip):
    matrix = get_matrices(hpd=False, herm_indef=False,
                          comp_nonsymm=False)[mi]
    xs = [np.ones((10, 1)), np.full((10, 1), 1.0j + 1)]
    x0s = [np.zeros((10, 1)), np.linspace(1, 5, 10).reshape((10, 1))] + xs
    x, x0 = xs[xi], x0s[x0i]
    M = np.diag(_get_m()) if with_M else None
    Ml = np.diag(_get_m()) if with_Ml else None
    b = matrix @ x
    ipt, ipj = _ip_pair(ip)
    want = np.asarray(ju.hegedus(matrix, b, x0, M, Ml, ipj))
    got = S.hegedus(_t(matrix), _t(b), _t(x0),
                    None if M is None else _t(M),
                    None if Ml is None else _t(Ml), ipt).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max(initial=1.0))


def test_gap_and_intervals_match_jax():
    for args in (([1, 2], [-4, 3]), (5, -5), ([-5, 5], -5)):
        assert S.gap(*args) == ju.gap(*args)
    for args in ((5, -5), (5, [-5, 6]), (-5, [-5, 6]), ([-5, 5], [0])):
        assert S.gap(*args, mode="interval") == ju.gap(*args,
                                                        mode="interval")
    pieces = [(-2, -1), (1, 2), (-10, 1.5), (5, 5), (-100, -50), (50, 100)]
    for sel in ([0, 4], [0, 1, 4, 5], [0, 1, 2, 3]):
        it = S.Intervals([S.Interval(*pieces[i]) for i in sel])
        ij = ju.Intervals([ju.Interval(*pieces[i]) for i in sel])
        for q in ("max", "min", "min_pos", "max_neg", "min_abs", "max_abs",
                  "get_endpoints", "__len__"):
            assert np.array_equal(np.asarray(getattr(it, q)()),
                                  np.asarray(getattr(ij, q)()))
        assert it.contains(0) == ij.contains(0)
        assert repr(it) == repr(ij)
    I, J, K = S.Interval(-2, -1), S.Interval(1, 2), S.Interval(-10, 1.5)
    assert (I & J) is None and (I | J) is None
    assert ((J & K).left, (J & K).right) == (1, 1.5)
    assert ((J | K).left, (J | K).right) == (-10, 2)
    assert J.distance(I) == 2


def test_bounds_match_jax_and_baseline_values():
    """BASELINE.md's regression values, to 1e-12 relative."""
    cg = S.BoundCG([1, 2])
    assert abs(cg.eval_step(8) - 1.5018239652065932e-06) <= \
        1e-12 * 1.5018239652065932e-06
    assert ceil(cg.get_step(1e-6)) == 9
    cgi = S.BoundCG(S.Intervals([S.Interval(1, 1.2), S.Interval(2)]))
    assert abs(cgi.eval_step(8) - 1.5018239652065932e-06) <= \
        1e-12 * 1.5018239652065932e-06
    mr = S.BoundMinres([-1, 1, 2])
    assert abs(mr.eval_step(8) - 0.0017331035544401801) <= \
        1e-12 * 0.0017331035544401801
    assert ceil(mr.get_step(2e-3)) == 8
    mri = S.BoundMinres(S.Intervals([S.Interval(-2, -1), S.Interval(2)]))
    assert abs(mri.eval_step(8) - 0.0017331035544401801) <= \
        1e-12 * 0.0017331035544401801
    assert isinstance(S.BoundMinres([1, 2]), S.BoundCG)
    rng = np.random.default_rng(5)
    for evals in (rng.uniform(0.1, 3, 20),
                  np.r_[-rng.uniform(0.1, 1, 4), rng.uniform(1, 5, 30)]):
        for steps in (3, 10, 41):
            assert S.BoundMinres(evals).eval_step(steps) == \
                ju.BoundMinres(evals).eval_step(steps)
        assert S.BoundMinres(evals).get_step(1e-6) == \
            ju.BoundMinres(evals).get_step(1e-6)


@pytest.mark.parametrize(
    "roots", [[1, 2], [1, 1j], [1, 2, 1e8], [1, 2, 1e8, 1e8 + 1e-3]])
def test_normalized_roots_polynomial_matches_jax(roots):
    pt = S.NormalizedRootsPolynomial(np.array(roots))
    pj = ju.NormalizedRootsPolynomial(np.array(roots))
    pts = np.linspace(-3, 3, 41)
    np.testing.assert_array_equal(pt(pts), pj(pts))
    np.testing.assert_array_equal(pt(np.array(roots)), np.zeros(len(roots)))
    assert pt(0) == 1
    np.testing.assert_allclose(np.sort_complex(pt.minmax_candidates()),
                               np.sort_complex(pj.minmax_candidates()))


def test_get_residual_norms_and_strakos_match_jax():
    from krypy_tpu import linsys

    A = matrix_nonsymm()
    ls = linsys.LinearSystem(A, np.ones((10, 1)))
    solver = linsys.Gmres(ls, tol=1e-12, store_arnoldi=True)
    H = np.asarray(solver.H)
    want = ju.get_residual_norms(H)
    np.testing.assert_allclose(S.get_residual_norms(H), want, rtol=1e-13,
                               atol=1e-15)
    np.testing.assert_allclose(S.get_residual_norms(_t(H)), want,
                               rtol=1e-13, atol=1e-15)
    Hs = np.asarray(_arnoldi("spd", "ones", 9, 0)[1])
    np.testing.assert_allclose(
        S.get_residual_norms(Hs, self_adjoint=True),
        ju.get_residual_norms(Hs, self_adjoint=True), rtol=1e-13,
        atol=1e-15)
    np.testing.assert_array_equal(S.strakos(7, device="cpu").numpy(),
                                  np.asarray(ju.strakos(7)))


def test_bound_perturbed_gmres_matches_jax():
    from krypy_tpu import pseudospectra

    ps = pseudospectra.NormalEvals(np.array([1.0, 4.0, 6.0]))
    p = ju.NormalizedRootsPolynomial(np.array([1.0, 5.0]))
    got = S.bound_perturbed_gmres(ps, S.NormalizedRootsPolynomial(
        np.array([1.0, 5.0])), 0.01, [0.1, 0.5])
    want = ju.bound_perturbed_gmres(ps, p, 0.01, [0.1, 0.5])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(S.ArgumentError):
        S.bound_perturbed_gmres(ps, p, 0.5, [0.1])


@pytest.mark.parametrize("kind", ["normal", "nonnormal"])
def test_bound_perturbed_gmres_with_port_pseudospectra(kind):
    """The bound with the port's own pseudospectra (``NormalEvals`` and
    ``NonnormalAuto`` of :mod:`krypy_tpu_torch.pseudospectra`) against the
    JAX package's bound with its own, 1e-10 relative."""
    from krypy_tpu import pseudospectra as jps
    from krypy_tpu_torch import pseudospectra as tps

    if kind == "normal":
        evals = np.array([1.0, 2.0, 3.0])
        jp, tp = jps.NormalEvals(evals), tps.NormalEvals(evals)
        eps, deltas = 1e-3, [1e-2, 5e-2]
    else:
        A = np.diag([1.0, 2.0, 3.0]) + np.triu(np.ones((3, 3)), 1)
        evals = np.linalg.eigvals(A)
        jp = jps.NonnormalAuto(A, 0.05, 0.5, n_points=41)
        tp = tps.NonnormalAuto(A, 0.05, 0.5, n_points=41, device="cpu")
        eps, deltas = 0.01, [0.1, 0.3]
    want = ju.bound_perturbed_gmres(
        jp, ju.NormalizedRootsPolynomial(evals), eps, deltas)
    got = S.bound_perturbed_gmres(
        tp, S.NormalizedRootsPolynomial(evals), eps, deltas)
    assert np.isfinite(got).all() and len(got) == len(deltas)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
