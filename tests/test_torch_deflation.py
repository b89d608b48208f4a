"""The port's deflation module (krypy_tpu_torch.functional.deflation)
against krypy_tpu.functional.deflation in float64 on the same numpy
inputs.

Tolerances: iteration counts and status equal; residual histories
``rtol=1e-8`` plus ``atol=1e-13`` (the final entries are explicit residuals
at the round-off floor); iterates and small matrices ``1e-10`` relative.
Eigenvectors of two float paths may differ in sign and, for close Ritz
values, in order, so Ritz bases are compared as subspaces (largest
principal angle below 1e-8) or both sides are fed the same internals
through :mod:`krypy_tpu_torch.interop`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu.functional import deflation as jdefl
from krypy_tpu_torch import functional as F, interop, ops
from krypy_tpu_torch.functional import deflation as defl

torch.set_num_threads(1)

NX = 15
N = NX * NX


def _t(a):
    return interop.from_numpy(np.asarray(a), "cpu")


def _angle(X, Y):
    """Sine of the largest principal angle between two column spaces of
    equal dimension: the norm of the part of one orthonormal basis that
    lies outside the other space."""
    Qx, _ = np.linalg.qr(np.asarray(X, np.float64))
    Qy, _ = np.linalg.qr(np.asarray(Y, np.float64))
    return float(np.linalg.norm(Qy - Qx @ (Qx.T @ Qy), 2))


def _hist_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-8, atol=1e-13)


def _compare(rj, rt):
    assert int(rt.niter) == int(rj.niter)
    assert int(rt.status) == int(rj.status)
    _hist_close(interop.to_numpy(rt.resnorms), rj.resnorms)
    xj, xt = np.asarray(rj.x), interop.to_numpy(rt.x)
    assert xt.dtype == np.float64
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


def _problem():
    """Shifted Laplacian at 15^2 (indefinite: 3 eigenvalues below the
    shift), a random rhs and a random 4-column basis."""
    rng = np.random.default_rng(0)
    b = rng.standard_normal(N)
    U = rng.standard_normal((N, 4))
    At = ops.shifted_laplacian_2d(NX, sigma=60.0, device="cpu")
    Aj = jops.shifted_laplacian_2d(NX, sigma=60.0)
    return At, Aj, b, U


def _precond(kind):
    """Keyword sets ``(port, jax)`` for one preconditioner layout."""
    rng = np.random.default_rng(11)
    if kind == "none":
        return {}, {}
    if kind == "MlMr":
        dl, dr = rng.uniform(0.5, 2.0, N), rng.uniform(0.5, 2.0, N)
        return (dict(Ml=lambda v: _t(dl) * v, Mr=lambda v: _t(dr) * v),
                dict(Ml=lambda v: jnp.asarray(dl) * v,
                     Mr=lambda v: jnp.asarray(dr) * v))
    dm = rng.uniform(0.5, 2.0, N)
    return (dict(M=ops.diagonal(_t(dm)), Minv=ops.diagonal(_t(1.0 / dm))),
            dict(M=jops.diagonal(jnp.asarray(dm)),
                 Minv=jops.diagonal(jnp.asarray(1.0 / dm))))


@pytest.mark.parametrize("impl,jax_impl", [("torch", "jnp"),
                                           ("cuda", "pallas")])
@pytest.mark.parametrize("nx,ny", [(16, 16), (8, 24)])
def test_shifted_laplacian_matches_jax(nx, ny, impl, jax_impl):
    """Both lanes of ``ops.shifted_laplacian_2d`` (the cuda lane's plain
    K1 version on the CPU against the Pallas stencil interpreted), in
    float64 to 1e-12 relative and in float32 to ``4 eps32 sum|terms|``
    of the stencil; ``.shape`` and ``.diag``."""
    sigma = 35.0
    At = ops.shifted_laplacian_2d(nx, ny, sigma=sigma, impl=impl,
                                  device="cpu")
    Aj = jops.shifted_laplacian_2d(nx, ny, sigma=sigma, impl=jax_impl)
    assert At.shape == tuple(Aj.shape) == (nx * ny, nx * ny)
    np.testing.assert_allclose(interop.to_numpy(At.diag),
                               np.asarray(Aj.diag), rtol=1e-14)
    x = np.random.default_rng(nx + ny).standard_normal(nx * ny)
    want = np.asarray(jops.shifted_laplacian_2d(nx, ny, sigma=sigma)(
        jnp.asarray(x)))
    np.testing.assert_allclose(interop.to_numpy(At(_t(x))), want,
                               rtol=0, atol=1e-12 * np.abs(want).max())
    x32 = x.astype(np.float32)
    got32 = interop.to_numpy(At(_t(x32)))
    want32 = np.asarray(Aj(jnp.asarray(x32)))
    assert got32.dtype == np.float32
    scale = (4 * max((nx + 1) ** 2, (ny + 1) ** 2) + sigma) \
        * np.abs(x).max()
    assert np.abs(got32.astype(np.float64) - want32).max() \
        <= 4 * np.finfo(np.float32).eps * 2 * scale


def test_shifted_laplacian_options():
    with pytest.raises(NotImplementedError, match="mesh"):
        ops.shifted_laplacian_2d(8, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        ops.shifted_laplacian_2d(8, impl="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.shifted_laplacian_2d(8)


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_qr_matches_jax(weighted):
    rng = np.random.default_rng(1)
    U = rng.standard_normal((N, 5))
    Bd = rng.uniform(1.0, 3.0, N)
    ipt = torch.diag(_t(Bd)) if weighted else None
    ipj = jnp.diag(jnp.asarray(Bd)) if weighted else None
    Qt, Rt = F.weighted_qr(_t(U), ipt)
    Qj, Rj = JF.weighted_qr(jnp.asarray(U), ipj)
    assert Qt.shape == (N, 5) and Qt.T.is_contiguous()
    np.testing.assert_allclose(interop.to_numpy(Qt), np.asarray(Qj),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(interop.to_numpy(Rt), np.asarray(Rj),
                               rtol=1e-12, atol=1e-12)
    Q = interop.to_numpy(Qt)
    gram = Q.T @ (Bd[:, None] * Q if weighted else Q)
    np.testing.assert_allclose(gram, np.eye(5), atol=1e-12)
    E, Z = F.weighted_qr(_t(U[:, :0]))
    assert E.shape == (N, 0) and Z.shape == (0, 0)


def test_weighted_qr_scalar_callable_ip_matches_jax():
    rng = np.random.default_rng(2)
    U = rng.standard_normal((40, 3))
    w = rng.uniform(1.0, 2.0, 40)
    Qt, Rt = F.weighted_qr(_t(U), lambda x, y: torch.vdot(x, _t(w) * y))
    Qj, Rj = JF.weighted_qr(jnp.asarray(U),
                            lambda x, y: jnp.vdot(x, jnp.asarray(w) * y))
    np.testing.assert_allclose(interop.to_numpy(Qt), np.asarray(Qj),
                               atol=1e-12)
    np.testing.assert_allclose(interop.to_numpy(Rt), np.asarray(Rj),
                               atol=1e-12)


@pytest.mark.parametrize("kind", ["none", "MlMr", "M"])
def test_build_deflation_matches_jax(kind):
    At, Aj, _, U = _problem()
    kt, kj = _precond(kind)
    dt = defl.build_deflation(At, _t(U), **kt)
    dj = jdefl.build_deflation(Aj, jnp.asarray(U), **kj)
    for name in ("Uo", "AU", "W2", "G", "E"):
        got, want = interop.to_numpy(getattr(dt, name)), np.asarray(
            getattr(dj, name))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())
    assert dt.Uo.T.is_contiguous() and dt.W2.T.is_contiguous()
    empty = defl.build_deflation(At, _t(U[:, :0]))
    assert empty.G.shape == (0, 0) and empty.Uo.shape == (N, 0)
    if kind == "M":
        with pytest.raises(ValueError, match="Minv"):
            defl.build_deflation(At, _t(U), M=kt["M"])


@pytest.mark.parametrize("ortho", ["cgs2", "cgs", "cgs2_pallas", "auto"])
@pytest.mark.parametrize("kind", ["none", "MlMr", "M"])
def test_deflated_gmres_matches_jax(kind, ortho):
    At, Aj, b, U = _problem()
    kt, kj = _precond(kind)
    # with a right preconditioner the reference corrects the iterate in
    # x-space with a basis that lives in y-space (x = Mr y): its explicit
    # residual stalls near 0.6 here while the recurrence goes on to 1e-10
    # (ROADMAP.md queue C).  The port does the same; that case is held to
    # the reference over 60 iterations, not to convergence.
    kw = dict(tol=1e-10, maxiter=60 if kind == "MlMr" else N, ortho=ortho)
    rt, it = F.deflated_gmres(At, _t(b), _t(U), return_internal=True,
                              **kw, **kt)
    rj, ij = JF.deflated_gmres(Aj, jnp.asarray(b), jnp.asarray(U),
                               return_internal=True, **kw, **kj)
    assert int(rt.status) == (F.MAXITER if kind == "MlMr" else F.CONVERGED)
    _compare(rj, rt)
    # the small matrices and the basis over the first 12 iterations (two
    # float64 Arnoldi recurrences drift apart as they go on: a relative
    # 1e-4 in the rows past 100 here)
    k = min(int(rt.niter), 12)
    for name, sl in (("H", np.s_[: k + 1, :k]), ("R", np.s_[: k + 1, :k]),
                     ("C", np.s_[:k]), ("E", np.s_[:]),
                     ("V", np.s_[: k + 1])):
        got, want = interop.to_numpy(it[name]), np.asarray(ij[name])
        assert got.shape == want.shape
        np.testing.assert_allclose(got[sl], want[sl], rtol=0,
                                   atol=1e-9 * np.abs(want[sl]).max())
    assert (it["P"] is None) == (ij["P"] is None) == (kind != "M")
    assert set(it) == set(ij)


def test_deflated_gmres_beats_plain_and_handles_empty_basis():
    At, Aj, b, U = _problem()
    # the eigenvectors below the shift: deflating them removes the
    # indefiniteness
    lap1 = (np.diag(np.full(NX, 2.0)) - np.diag(np.ones(NX - 1), 1)
            - np.diag(np.ones(NX - 1), -1)) * (NX + 1) ** 2
    dense = np.kron(lap1, np.eye(NX)) + np.kron(np.eye(NX), lap1)
    lam, vec = np.linalg.eigh(dense)
    low = vec[:, lam < 60.0]
    assert low.shape[1] == 3
    plain = F.gmres(At, _t(b), tol=1e-10, maxiter=120)
    deflated = F.deflated_gmres(At, _t(b), _t(low), tol=1e-10, maxiter=120)
    assert int(deflated.status) == F.CONVERGED
    assert int(deflated.niter) < int(plain.niter)
    empty = F.deflated_gmres(At, _t(b), _t(low[:, :0]), tol=1e-10,
                             maxiter=120)
    assert torch.equal(empty.x, plain.x)
    with pytest.raises(NotImplementedError, match="cgs2_1r"):
        F.deflated_gmres(At, _t(b), _t(low), ortho="cgs2_1r")
    with pytest.raises(ValueError):
        F.deflated_gmres(At, _t(b), _t(low), ortho="cgs2_fused",
                         M=lambda v: v, Minv=lambda v: v)


@pytest.mark.parametrize("kind", ["none", "M"])
def test_deflated_cg_matches_jax(kind):
    """Poisson at 7^2 (about 20 iterations: a longer float64 CG
    recurrence drifts from its twin by more than the 1e-8 the histories
    are held to)."""
    nx = 7
    n = nx * nx
    rng = np.random.default_rng(3)
    b = rng.standard_normal(n)
    At, Aj = ops.poisson_2d(nx, device="cpu"), jops.poisson_2d(nx)
    U = rng.standard_normal((n, 3))
    kt, kj = {}, {}
    if kind == "M":
        dm = rng.uniform(0.5, 2.0, n)
        kt = dict(M=ops.diagonal(_t(dm)), Minv=ops.diagonal(_t(1.0 / dm)))
        kj = dict(M=jops.diagonal(jnp.asarray(dm)),
                  Minv=jops.diagonal(jnp.asarray(1.0 / dm)))
    kw = dict(tol=1e-10, maxiter=200)
    rt = F.deflated_cg(At, _t(b), _t(U), **kw, **kt)
    rj = JF.deflated_cg(Aj, jnp.asarray(b), jnp.asarray(U), **kw, **kj)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt)
    auto = F.deflated_cg(At, _t(b), _t(U), variant="auto", **kw, **kt)
    assert torch.equal(auto.x, rt.x)
    empty = F.deflated_cg(At, _t(b), _t(U[:, :0]), **kw)
    assert torch.equal(empty.x, F.cg(At, _t(b), **kw).x)
    with pytest.raises(NotImplementedError):
        F.deflated_cg(At, _t(b), _t(U), variant="1r")
    # the exact low eigenvectors deflated: fewer iterations than plain CG
    lam, vec = np.linalg.eigh(np.asarray(
        [interop.to_numpy(At(_t(e))) for e in np.eye(n)]))
    low = F.deflated_cg(At, _t(b), _t(vec[:, :3]), **kw)
    assert int(low.niter) < int(F.cg(At, _t(b), **kw).niter)


def _solve_pair(kind="none", deflate=False, maxiter=40):
    """A converged float64 solve on both sides with its internals."""
    At, Aj, b, U = _problem()
    kt, kj = _precond(kind)
    kw = dict(tol=1e-9, maxiter=maxiter, return_internal=True)
    if deflate:
        rt, it = F.deflated_gmres(At, _t(b), _t(U), **kw, **kt)
        rj, ij = JF.deflated_gmres(Aj, jnp.asarray(b), jnp.asarray(U),
                                   **kw, **kj)
    else:
        rt, it = F.gmres(At, _t(b), **kw, **kt)
        rj, ij = JF.gmres(Aj, jnp.asarray(b), **kw, **kj)
    ij = dict(ij)
    it["niter"] = ij["niter"] = int(rt.niter)
    assert int(rt.niter) == int(rj.niter)
    return it, ij


@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("deflate", [False, True])
def test_ritz_pairs_match_jax(deflate, hermitian):
    it, ij = _solve_pair(deflate=deflate)
    if not deflate:
        ij["E"] = jnp.zeros((0, 0))
    tt, ct, nt, dt = F.ritz_pairs(it, hermitian=hermitian)
    tj, cj, nj, dj = JF.ritz_pairs(ij, hermitian=hermitian)
    assert (nt, dt) == (nj, dj) == (it["niter"], 4 if deflate else 0)
    assert ct.shape == cj.shape == (nt + dt, nt + dt)
    np.testing.assert_allclose(np.sort_complex(tt), np.sort_complex(tj),
                               rtol=0, atol=1e-7 * np.abs(tj).max())


@pytest.mark.parametrize("which", ["sm", "lm", "sr", "lr"])
@pytest.mark.parametrize("deflate", [False, True])
def test_ritz_deflation_vectors_match_jax(deflate, which):
    """Both directions of the hand-off: the port's extraction on its own
    internals against the JAX one on its own (subspaces), and each side's
    extraction on the OTHER side's internals, carried by interop."""
    it, ij = _solve_pair(deflate=deflate)
    if not deflate:
        ij["E"] = jnp.zeros((0, 0))
    kw = dict(n_vectors=3, which=which, hermitian=True)
    Ut = F.ritz_deflation_vectors(it, **kw)
    Uj = JF.ritz_deflation_vectors(ij, **kw)
    assert Ut.shape == (N, 3) and Ut.T.is_contiguous()
    assert _angle(interop.to_numpy(Ut), Uj) <= 1e-8
    # JAX internals -> the port's extraction
    carried = interop.internals_from_numpy(
        {k: (None if v is None else np.asarray(v)) if k != "niter" else v
         for k, v in ij.items()}, "cpu")
    assert _angle(interop.to_numpy(F.ritz_deflation_vectors(carried, **kw)),
                  Uj) <= 1e-8
    # the port's internals -> the JAX extraction
    back = {k: (v if v is None or k == "niter" else jnp.asarray(v))
            for k, v in interop.internals_to_numpy(it).items()}
    assert _angle(JF.ritz_deflation_vectors(back, **kw),
                  interop.to_numpy(Ut)) <= 1e-8


def test_ritz_basis_crosses_between_the_packages():
    """The JAX Ritz basis drives the port's deflated_gmres and the port's
    basis the JAX one: same iteration count and iterate as each side's
    own."""
    At, Aj, b, _ = _problem()
    it, ij = _solve_pair()
    ij["E"] = jnp.zeros((0, 0))
    kw = dict(n_vectors=4, which="sm", hermitian=True)
    Ut = F.ritz_deflation_vectors(it, **kw)
    Uj = JF.ritz_deflation_vectors(ij, **kw)
    skw = dict(tol=1e-10, maxiter=120)
    own = F.deflated_gmres(At, _t(b), Ut, **skw)
    carried = F.deflated_gmres(At, _t(b),
                               interop.basis_from_numpy(Uj, "cpu"), **skw)
    jown = JF.deflated_gmres(Aj, jnp.asarray(b), Uj, **skw)
    jcarried = JF.deflated_gmres(Aj, jnp.asarray(b),
                                 jnp.asarray(interop.to_numpy(Ut)), **skw)
    B = interop.basis_from_numpy(Uj, "cpu")
    assert B.shape == (N, 4) and B.T.is_contiguous()
    assert int(own.niter) == int(carried.niter) == int(jown.niter) \
        == int(jcarried.niter)
    for r in (carried, ):
        assert torch.linalg.vector_norm(r.x - own.x) <= \
            1e-9 * torch.linalg.vector_norm(own.x)
    assert np.linalg.norm(np.asarray(jcarried.x) - interop.to_numpy(own.x)) \
        <= 1e-9 * np.linalg.norm(np.asarray(jown.x))


def test_realify_columns_on_a_planted_conjugate_pair():
    """A conjugate Ritz pair maps to its real and imaginary parts, not to
    two equal columns (which would make E singular); same block as the
    JAX function's, with and without ``theta``."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal(7) + 1j * rng.standard_normal(7)
    real = rng.standard_normal(7)
    sel = np.stack([v, real + 0j, np.conj(v)], axis=1)
    theta = np.array([0.3 + 0.2j, 0.5, 0.3 - 0.2j])
    for th in (theta, None):
        got = defl._realify_columns(sel, th)
        want = jdefl._realify_columns(sel, th)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (7, 3) and np.isrealobj(got)
    got = defl._realify_columns(sel, theta)
    assert np.linalg.matrix_rank(got) == 3
    assert _angle(got, np.stack([v.real, v.imag, real], axis=1)) <= 1e-12
    # two adjacent equal-phase columns, no eigenvalues: the second turns
    # to its imaginary part
    pair = np.stack([v, np.conj(v)], axis=1)
    assert np.linalg.matrix_rank(defl._realify_columns(pair)) == 2


def test_assemble_ritz_vectors_realifies_complex_coefficients():
    """Complex coefficients on a real basis give a real, full-rank block
    that spans the same space as the JAX assembly."""
    it, ij = _solve_pair()
    ij["E"] = jnp.zeros((0, 0))
    n = it["niter"]
    rng = np.random.default_rng(5)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    sel = np.stack([v, np.conj(v)], axis=1)
    theta = np.array([0.1 + 0.4j, 0.1 - 0.4j])
    Ut = F.assemble_ritz_vectors(it, sel, n, 0, theta=theta)
    Uj = JF.assemble_ritz_vectors(ij, sel, n, 0, theta=theta)
    assert Ut.dtype == torch.float64 and Ut.shape == (N, 2)
    np.testing.assert_allclose(interop.to_numpy(Ut), np.asarray(Uj),
                               atol=1e-12)


def test_recycling_gmres_on_the_diagonal_sequence_matches_jax():
    """examples/deflation_recycling.py's functional lane: four slowly
    varying diagonal systems, three Ritz vectors recycled."""
    n = 200
    base = np.linspace(1, 2, n)
    base[:4] = [1e-6, 1e-3, 5e-3, 2e-2]
    rt = F.RecyclingGmres(n_vectors=3, which="sm", hermitian=True)
    rj = JF.RecyclingGmres(n_vectors=3, which="sm", hermitian=True)
    bt, bj = torch.ones(n, dtype=torch.float64), jnp.ones(n)
    iters = []
    for i in range(4):
        d = base * (1.0 + 0.01 * i)
        op = ops.diagonal(_t(d))
        assert op.family == "diagonal" and op.shape == (n, n)
        assert torch.equal(op.rebuild(op.params)(bt), op(bt))
        got = rt.solve(op, bt, tol=1e-6, maxiter=n)
        want = rj.solve(jops.diagonal(jnp.asarray(d)), bj, tol=1e-6,
                        maxiter=n)
        _compare(want, got)
        iters.append(int(got.niter))
    assert iters[0] > iters[1] and iters[1:] == [iters[1]] * 3
    Ut, Uj = interop.to_numpy(rt._U), np.asarray(rj._U)
    assert Ut.shape == Uj.shape == (n, 3)
    assert _angle(Ut, Uj) <= 1e-8


def test_recycling_gmres_nonsymmetric_with_preconditioner():
    """hermitian=False on a nonsymmetric operator with a left
    preconditioner, and the warm-up, which changes no result."""
    nx = 15
    At = ops.convection_diffusion_2d(nx, device="cpu")
    Aj = jops.convection_diffusion_2d(nx)
    dl = 1.0 / np.asarray(Aj.diag)
    b = np.random.default_rng(6).standard_normal(nx * nx)
    kw = dict(tol=1e-9, maxiter=80)
    rt = F.RecyclingGmres(n_vectors=4, which="sm", hermitian=False)
    assert rt.warmup(At, _t(b), Ml=lambda v: _t(dl) * v, **kw) is rt
    rj = JF.RecyclingGmres(n_vectors=4, which="sm", hermitian=False)
    for scale in (1.0, 1.05, 1.1):
        got = rt.solve(At, _t(scale * b), Ml=lambda v: _t(dl) * v, **kw)
        want = rj.solve(Aj, jnp.asarray(scale * b),
                        Ml=lambda v: jnp.asarray(dl) * v, **kw)
        assert int(got.status) == int(want.status) == F.CONVERGED
        assert int(got.niter) == int(want.niter)
        xj = np.asarray(want.x)
        assert np.linalg.norm(interop.to_numpy(got.x) - xj) <= \
            1e-8 * np.linalg.norm(xj)


@pytest.mark.parametrize("name", ["deflated_minres", "AutoRecyclingGmres"])
def test_unported_names_raise(name):
    fn = getattr(F, name)
    args = (torch.eye(2), torch.ones(2), torch.ones(2, 1)) \
        if name == "deflated_minres" else ()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn(*args)


def test_functional_exports_the_jax_names():
    for name in ("deflated_gmres", "deflated_cg", "deflated_minres",
                 "RecyclingGmres", "AutoRecyclingGmres",
                 "ritz_deflation_vectors", "ritz_pairs",
                 "assemble_ritz_vectors", "weighted_qr", "as_matvec",
                 "make_inner"):
        assert name in F.__all__ and name in JF.__all__
        assert hasattr(F, name)
