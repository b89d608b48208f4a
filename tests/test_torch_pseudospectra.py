"""The port's ``pseudospectra`` module and the prediction machinery of its
``deflation`` (``Arnoldifyer``, ``bound_pseudo``) against the JAX package,
float64 / complex128 on the same numpy inputs.

* pseudospectra: tests/test_spectral.py:245-286's cases through both
  packages (``NormalEvals`` paths and lengths to 1e-12,
  ``NonnormalMeshgrid.Vals`` to 1e-12), the port's level sets against the
  JAX package's (which extracts them with contourpy): vertex sets to
  1e-12 and lengths to 1e-10, on fields with saddle cells too, and
  ``NonnormalAuto``'s box;
* ``Arnoldifyer``: tests/test_deflation.py:173-278's cases at that file's
  stride through both packages, ``get(Wt, full=True)`` to 1e-10 (``F``
  compared as its matrix), a miss passing only under the rounding witness
  of tests/torch_compat_cases.py, then the test's own checks on the
  port's relation;
* ``bound_pseudo``: tests/test_aux.py:189-245's cases through both
  packages, bounds to 1e-8 relative.
"""

import types
import warnings

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp

from krypy_tpu import deflation as jdeflation, linsys as jlinsys
from krypy_tpu import pseudospectra as jps
from krypy_tpu.errors import ConvergenceError as JaxConvergenceError
from krypy_tpu_torch import deflation, errors, interop, linsys, utils
from krypy_tpu_torch import pseudospectra as ps

import test_deflation
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


def _vertex_set(paths):
    """The distinct vertices of ``paths`` as sorted (re, im) rows."""
    v = paths.vertices()
    pts = np.stack([v.real, v.imag], axis=1)
    return pts[np.lexsort((pts[:, 1], pts[:, 0]))]


def _same_vertex_sets(want, got, atol):
    """Every vertex of each set lies within ``atol`` of one of the other
    (a closed line repeats its first point, in either package)."""
    for a, b in ((want, got), (got, want)):
        if len(a) == 0:
            assert len(b) == 0
            continue
        dist = np.min(np.abs(a[:, None, 0] - b[None, :, 0])
                      + np.abs(a[:, None, 1] - b[None, :, 1]), axis=1)
        assert dist.max() <= atol, dist.max()


# ---------------------------------------------------------------------------
# pseudospectra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("evals,eps", [
    (np.array([0.0, 10.0]), 1.0),
    (np.array([0.0, 0.5]), 1.0),
    (np.array([1.0, 4.0, 6.0]), 0.5),
    (np.array([1.0, 1.5 + 0.1j, 1.5 - 0.1j, 2.0]), 0.3),
])
def test_normal_evals_match_jax(evals, eps):
    """tests/test_spectral.py:245's disk unions (and two more) through
    both packages: the same arcs, their vertices and lengths to 1e-12."""
    want = jps.NormalEvals(evals).contour_paths(eps)
    got = ps.NormalEvals(evals).contour_paths(eps)
    assert len(got.paths) == len(want.paths)
    np.testing.assert_allclose(got.vertices(), want.vertices(), rtol=0,
                               atol=1e-12)
    assert abs(got.length() - want.length()) <= 1e-12
    for g, w in zip(got.paths, want.paths):
        assert abs(g.length() - w.length()) <= 1e-12
    if len(evals) == 2 and evals[1] == 10.0:
        assert abs(got.length() - 4 * np.pi) <= 1e-10
    if len(evals) == 2 and evals[1] == 0.5:
        verts = got.vertices()
        dmin = np.minimum(np.abs(verts), np.abs(verts - 0.5))
        assert np.allclose(dmin, 1.0, atol=1e-12)


def _jordan(**kw):
    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    box = dict(real_min=-2, real_max=2, real_n=101, imag_min=-2, imag_max=2,
               imag_n=101)
    box.update(kw)
    return A, box


@pytest.mark.parametrize("eps", [0.1, 0.5, 1.0])
def test_nonnormal_meshgrid_matches_jax(eps):
    """tests/test_spectral.py:268's Jordan block through both packages:
    ``Vals`` to 1e-12, the level set's vertices to 1e-12 and its length to
    1e-10, and the test's own radius check on the port's paths."""
    A, box = _jordan()
    jm = jps.NonnormalMeshgrid(A, **box)
    pm = ps.NonnormalMeshgrid(A, **box, device="cpu")
    np.testing.assert_allclose(pm.Vals, jm.Vals, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(pm.Real, jm.Real)
    np.testing.assert_array_equal(pm.Imag, jm.Imag)
    want, got = jm.contour_paths(eps), pm.contour_paths(eps)
    assert len(got.paths) == len(want.paths)
    _same_vertex_sets(_vertex_set(want), _vertex_set(got), 1e-12)
    assert abs(got.length() - want.length()) <= 1e-10
    if eps == 0.5:
        radii = np.abs(got.vertices())
        assert radii.std() < 0.05
        expected = np.sqrt(0.5 * np.sqrt(0.25 + 1) + 0.25)
        assert abs(radii.mean() - expected) < 0.05


def _saddle_fields():
    """Fields whose level sets cross saddle cells, each with its level:
    a 2x2 saddle read on both sides of its middle, and a checkerboard-
    modulated random field."""
    X, Y = np.meshgrid([0.0, 1.0], [0.0, 1.0])
    Z = np.array([[1.0, 0.0], [0.0, 1.0]])
    out = [(X, Y, Z, 0.4), (X, Y, Z, 0.6), (X, Y, Z.T[::-1], 0.4),
           (X, Y, Z.T[::-1], 0.6)]
    rng = np.random.RandomState(0)
    X, Y = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-2, 1, 7))
    checker = np.indices(X.shape).sum(axis=0) % 2
    Z = 0.5 + 0.4 * (2 * checker - 1) + 0.05 * rng.randn(*X.shape)
    out += [(X, Y, Z, lev) for lev in (0.45, 0.5, 0.55)]
    for _ in range(8):
        ny, nx = rng.randint(2, 14, 2)
        X, Y = np.meshgrid(np.linspace(-1, 1, nx), np.linspace(0, 3, ny))
        out.append((X, Y, rng.rand(ny, nx), rng.uniform(0.2, 0.8)))
    return out


@pytest.mark.parametrize("case", range(len(_saddle_fields())))
def test_level_lines_match_contourpy(case):
    """The port's marching squares against contourpy's default algorithm
    (the JAX package's extractor) on the same field: the same number of
    lines, vertex sets to 1e-12 and lengths to 1e-10, saddle cells
    included (the first seven fields)."""
    from contourpy import contour_generator

    X, Y, Z, level = _saddle_fields()[case]
    want = [np.asarray(ln) for ln in
            contour_generator(x=X, y=Y, z=Z).lines(level)]
    got = ps._level_lines(X, Y, Z, level)
    assert len(got) == len(want)

    def as_paths(lines):
        return ps.Paths([ps.Path(ln[:, 0] + 1j * ln[:, 1]) for ln in lines])

    _same_vertex_sets(_vertex_set(as_paths(want)), _vertex_set(
        as_paths(got)), 1e-12)
    assert abs(as_paths(got).length() - as_paths(want).length()) <= 1e-10
    # lines are closed where contourpy's are
    assert sorted(bool(np.array_equal(ln[0], ln[-1])) for ln in got) == \
        sorted(bool(np.allclose(ln[0], ln[-1], atol=1e-12)) for ln in want)


def test_nonnormal_auto_box_matches_jax():
    rng = np.random.RandomState(1)
    A = np.diag(np.linspace(1, 2, 6)) + np.triu(rng.rand(6, 6), 1)
    jm = jps.NonnormalAuto(A, 0.01, 0.3, n_points=21)
    pm = ps.NonnormalAuto(A, 0.01, 0.3, n_points=21, device="cpu")
    np.testing.assert_array_equal(pm.Real, jm.Real)
    np.testing.assert_array_equal(pm.Imag, jm.Imag)
    np.testing.assert_allclose(pm.Vals, jm.Vals, rtol=0, atol=1e-12)
    # a tensor keeps its device, and the grid is the same
    pt = ps.NonnormalAuto(torch.tensor(A), 0.01, 0.3, n_points=21)
    assert pt.device.type == "cpu"
    np.testing.assert_allclose(pt.Vals, pm.Vals, rtol=0, atol=0)
    for eps in (0.05, 0.2):
        want, got = jm.contour_paths(eps), pm.contour_paths(eps)
        _same_vertex_sets(_vertex_set(want), _vertex_set(got), 1e-12)
        assert abs(got.length() - want.length()) <= 1e-10


def test_numpy_input_goes_to_the_card():
    """A numpy matrix without ``device=`` goes to ``"cuda"``: without a
    card that raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        ps.NonnormalMeshgrid(np.eye(2), real_n=3, imag_n=3)


# ---------------------------------------------------------------------------
# Arnoldifyer
# ---------------------------------------------------------------------------

def _recorded_arnoldifyer_cases():
    """tests/test_deflation.py's Arnoldifyer cases as ``(A, b, kwargs, U,
    A_norm, Wt_sel)``: its builder runs with a LinearSystem that keeps the
    numpy arguments it was built from."""
    class Recorded(jlinsys.LinearSystem):
        def __init__(self, A, b, **kwargs):
            super().__init__(A, b, **kwargs)
            self.recorded = (A, b, kwargs)

    real = test_deflation.linsys
    test_deflation.linsys = types.SimpleNamespace(LinearSystem=Recorded)
    try:
        cases = list(test_deflation.generate_arnoldifyer_cases())
    finally:
        test_deflation.linsys = real
    return [(*ls.recorded, U, A_norm, sel) for ls, U, A_norm, sel in cases]


ARNOLDIFYER_CASES = _recorded_arnoldifyer_cases()


def _deflated(defl, lin, A, b, kw, U, exc, **skw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return defl.DeflatedGmres(lin.LinearSystem(A, b, **kw, **skw),
                                      U=U, store_arnoldi=True, maxiter=5)
        except exc as caught:
            return caught.solver


def _wt(ritz_coeffs, ritz_values, sel):
    coeffs = ritz_coeffs[:, np.argsort(np.abs(ritz_values))]
    if sel == "none":
        return np.zeros((coeffs.shape[0], 0))
    Wt = coeffs[:, :2] if sel == "smallest" else coeffs[:, -2:]
    return scipy.linalg.qr(Wt, mode="economic")[0]


def _jax_get(A, b, kw, U, Wt):
    """The JAX package's ``get(Wt, full=True)`` as numpy; ``F`` as its
    matrix."""
    sol = _deflated(jdeflation, jlinsys, A, b, kw, U, JaxConvergenceError)
    out = jdeflation.Arnoldifyer(sol).get(Wt, full=True)
    N = b.shape[0]
    return dict(zip(("Hh", "Rh", "q_norm", "vdiff_norm", "PWAW_norm", "Vh"),
                    [np.asarray(v) for v in out[:6]]),
                F=np.asarray(out[6] * jnp.eye(N)))


def _port_get(arn, Wt, N):
    out = arn.get(Wt, full=True)
    res = dict(zip(("Hh", "Rh", "q_norm", "vdiff_norm", "PWAW_norm"),
                   [np.asarray(v) for v in out[:5]]))
    res["Vh"] = interop.to_numpy(out[5])
    res["F"] = interop.to_numpy(out[6] * torch.eye(N, dtype=torch.float64))
    return res


def _witnesses(A, b, kw, U, Wt):
    """The JAX package's ``get`` under one ulp of b, one ulp of A, and the
    reversed order of the unknowns (its N-row results permuted back)."""
    out = [_jax_get(A, cc.one_ulp(b), kw, U, Wt),
           _jax_get(cc.one_ulp(A), b, kw, U, Wt)]
    fwd, _ = cc.reversal(b.shape[0])
    back = np.argsort(np.arange(b.shape[0])[::-1])
    rev = _jax_get(fwd(A), fwd(b), {k: fwd(v) for k, v in kw.items()},
                   fwd(U), Wt)
    rev["Vh"] = rev["Vh"][back]
    rev["F"] = rev["F"][back][:, back]
    out.append(rev)
    return out


@pytest.mark.parametrize("case", range(len(ARNOLDIFYER_CASES)))
def test_arnoldifyer_matches_jax(case):
    A, b, kw, U, A_norm, sel = ARNOLDIFYER_CASES[case]
    N = b.shape[0]
    jsol = _deflated(jdeflation, jlinsys, A, b, kw, U, JaxConvergenceError)
    jritz = jdeflation.Ritz(jsol)
    Wt = _wt(jritz.coeffs, jritz.values, sel)
    jout = jdeflation.Arnoldifyer(jsol).get(Wt, full=True)
    want = dict(zip(("Hh", "Rh", "q_norm", "vdiff_norm", "PWAW_norm", "Vh"),
                    [np.asarray(v) for v in jout[:6]]),
                F=np.asarray(jout[6] * jnp.eye(N)))

    dsolver = _deflated(deflation, linsys, A, b, kw, U,
                        errors.ConvergenceError, device="cpu")
    arn = deflation.Arnoldifyer(dsolver)
    got = _port_get(arn, Wt, N)
    steered = cc.hold(want, got, lambda: _witnesses(A, b, kw, U, Wt))
    if steered:
        print("passed by the rounding witness:", steered)

    # tests/test_deflation.py's own checks, on the port's relation
    ls = dsolver.linear_system
    ip = ls.get_ip_Minv_B()
    host = interop.to_numpy
    Z = arn.Z
    np.testing.assert_array_almost_equal(
        host(utils.inner(Z, Z, ip_B=ip)), np.eye(Z.shape[1]), 7)
    Hh, Rh, q_norm, vdiff_norm, PWAW_norm, Vh, F = arn.get(Wt, full=True)
    n = dsolver.H.shape[1]
    d = dsolver.projection.U.shape[1]
    k = Wt.shape[1]
    VU = torch.cat([dsolver.V[:, :n], dsolver.projection.U], dim=1)
    W = VU @ torch.as_tensor(Wt, dtype=VU.dtype)
    PW = utils.Projection(ls.MlAMr * W, W, device="cpu").operator_complement()
    At = ls.M * (PW * ls.MlAMr)
    rel = torch.linalg.norm((At + F) * Vh - Vh @ torch.as_tensor(
        Hh, dtype=Vh.dtype), 2)
    assert float(rel) / A_norm < 1e-7
    np.testing.assert_array_almost_equal(
        host(utils.inner(Vh, (At + F) * Vh, ip_B=ip)), Hh, 7)
    np.testing.assert_array_almost_equal(
        host(utils.inner(Vh, Vh, ip_B=ip)), np.eye(n + d - k), 7)
    Q, _ = utils.qr(torch.eye(N, dtype=torch.float64), ip_B=ip)
    opnorm = float(utils.norm((ls.M * PW * ls.Minv) * Q, ip_B=ip))
    np.testing.assert_almost_equal(PWAW_norm, opnorm)


# ---------------------------------------------------------------------------
# bound_pseudo
# ---------------------------------------------------------------------------

def _bound_case(kind):
    """tests/test_aux.py:189-245's systems: ``(A, b, flags, maxiter, pick)``
    with ``pick`` the Ritz index rule of the candidate (None: no
    candidate)."""
    N = 20
    d = np.linspace(1, 2, N)
    d[0] = 1e-2
    if kind == "nonnormal":
        A = np.diag(np.linspace(1, 2, 16))
        A[0, -1] = 0.5
        return A, np.ones((16, 1)), {}, 8, None
    if kind == "normal":
        A = np.diag(d).astype(complex)
        A[3, 3] = 1.5 + 0.1j
        A[4, 4] = 1.5 - 0.1j
        return A, np.ones((N, 1)), dict(normal=True), 12, "sm"
    return (np.diag(d), np.ones((N, 1)),
            dict(normal=True, self_adjoint=True, positive_definite=True),
            12, "sm")


def _bounds(defl, lin, exc, kind, pseudo_type, **skw):
    A, b, flags, maxiter, pick = _bound_case(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            sol = defl.DeflatedGmres(lin.LinearSystem(A, b, **flags, **skw),
                                     tol=1e-10, maxiter=maxiter,
                                     store_arnoldi=True)
        except exc as caught:
            sol = caught.solver
        ritz = defl.Ritz(sol)
        arn = defl.Arnoldifyer(sol)
        if pick is None:
            Wt = np.zeros((ritz.coeffs.shape[0], 0))
        else:
            Wt = ritz.coeffs[:, [int(np.argmin(np.abs(ritz.values)))]]
            Wt, _ = np.linalg.qr(Wt)
        return np.asarray(defl.bound_pseudo(arn, Wt, tol=1e-10,
                                            pseudo_type=pseudo_type))


@pytest.mark.parametrize("kind,pseudo_type", [
    ("hermitian", "omit"), ("hermitian", "hermitian"), ("normal", "normal"),
    ("hermitian", "auto"), ("normal", "auto"), ("nonnormal", "nonnormal"),
    ("nonnormal", "auto")])
def test_bound_pseudo_matches_jax(kind, pseudo_type):
    """Each ``pseudo_type`` of tests/test_aux.py's cases (and ``auto``'s
    resolutions) through both packages: the bounds to 1e-8 relative, and
    the test's own checks on the port's."""
    want = _bounds(jdeflation, jlinsys, JaxConvergenceError, kind,
                   pseudo_type)
    got = _bounds(deflation, linsys, errors.ConvergenceError, kind,
                  pseudo_type, device="cpu")
    assert len(got) == len(want) >= 1
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=0)
    assert np.isfinite(got).all() and (got >= 0).all()


def test_bound_pseudo_contain_raises_as_jax():
    A, b, flags, _, _ = _bound_case("hermitian")
    out = []
    for defl, lin, kw in ((jdeflation, jlinsys, {}),
                          (deflation, linsys, dict(device="cpu"))):
        sol = defl.DeflatedGmres(lin.LinearSystem(A, b, **flags, **kw),
                                 tol=1e-6, store_arnoldi=True)
        arn = defl.Arnoldifyer(sol)
        Wt = np.zeros((arn.n + arn.d, 0))
        with pytest.raises(NotImplementedError, match="contain") as e:
            defl.bound_pseudo(arn, Wt, pseudo_type="contain")
        out.append(type(e.value).__name__)
        with pytest.raises(Exception) as e:
            defl.bound_pseudo(arn, Wt, g_norm=1e9)
        out.append(type(e.value).__name__)
    assert out[:2] == out[2:]
