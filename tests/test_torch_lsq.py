"""The port's least-squares solvers (``functional.lsq``: ``lsqr``,
``lsmr``) against krypy_tpu.functional's on the same numpy inputs.

Every case of tests/test_lsq.py, float64 on both sides: ``status``
equal; ``niter`` equal, ``x`` to ``1e-10`` relative (norm-wise) and the
estimated residual history to ``1e-10`` relative above the floor ``1e3
eps``, or, where one misses it, the rounding-witness rule of
tests/torch_compat_cases.py (the JAX package's own solve moves beyond the
bound under one ulp of ``b[0]``, of ``b[N // 2]``, of ``A[0, 0]``, or with
the unknowns in reverse order: LSQR and LSMR run past the dimension of
the space on the consistent diagonal, where each iteration's summation
order steers the history), then the JAX test's own oracle (dense ``numpy.linalg.lstsq``,
the pseudoinverse, the augmented damped problem) on the port's result.
The float32 floor case holds the port to the JAX test's own claims
(no false convergence, a finite iterate): float32 reductions differ
(ROADMAP.md C).  The mesh form runs in tests/test_torch_parallel.py.

The slice end to end: the north star's operator at 63^2 (K1 with
``impl="cuda"``, its plain version on the CPU) with ``Ah =
northstar.cd_transpose`` against the JAX package on the same padded
stencil with the transpose of ``jax.linear_transpose``, float64.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_compat_cases as cc
from krypy_tpu import functional as JF
from krypy_tpu_torch import functional as F, northstar, ops
from krypy_tpu_torch.functional import lsq

torch.set_num_threads(1)

SOLVERS = ("lsqr", "lsmr")
#: the card phase's Tikhonov parameter on the north star's h^2-scaled
#: operator (sigma_max ~ 8): LSQR and LSMR stop by tol 1e-5 in ~290 and
#: ~230 float32 iterations at every grid (63^2 and 255^2 on the CPU)
LSQ_DAMP = 0.1

#: one jitted JAX solve per solver, operator and option set, a function
#: of ``b`` (kept for the witnesses' reruns)
_JAX = {}


def _key(v):
    if isinstance(v, (np.ndarray, jnp.ndarray)):
        a = np.asarray(v)
        return (a.shape, a.dtype.str, a.tobytes())
    return id(v) if callable(v) else v


def _jax(solver, A, b, **kw):
    key = (solver, _key(A), tuple(sorted((k, _key(v))
                                         for k, v in kw.items())))
    fn = _JAX.get(key)
    if fn is None:
        if len(_JAX) > 8:
            _JAX.clear()
        Aj = jnp.asarray(A) if isinstance(A, np.ndarray) else A
        kwj = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        fn = _JAX[key] = jax.jit(
            lambda bb: getattr(JF, solver)(Aj, bb, **kwj))
    r = fn(jnp.asarray(b))
    return {"x": np.asarray(r.x), "resnorms": np.asarray(r.resnorms),
            "niter": int(r.niter), "status": int(r.status)}


def _torch(solver, A, b, **kw):
    A = torch.tensor(A) if isinstance(A, np.ndarray) else A
    kw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    r = getattr(F, solver)(A, torch.tensor(b), **kw)
    return {"x": r.x.numpy(), "resnorms": r.resnorms.numpy(),
            "niter": int(r.niter), "status": int(r.status)}


def _hold(solver, A, b, At=None, Aht=None, rev=None, **kw):
    """The port's solve against the JAX package's (module docstring):
    ``At`` and ``Aht`` are the port's operator and adjoint where ``A`` and
    ``Ah`` are the JAX package's callables, ``rev`` the JAX package's
    ``(A, Ah)`` on the reversed unknowns where they are callables; returns
    the port's results."""
    want = _jax(solver, A, b, **kw)
    got = _torch(solver, A if At is None else At, b,
                 **dict(kw, **({} if Aht is None else {"Ah": Aht})))
    assert got["status"] == want["status"]

    def quantities(r):
        res = r["resnorms"]
        return {"xk": r["x"], "resnorms": res[~np.isnan(res)],
                "niter": np.array(float(r["niter"]))}

    def witness():
        mid = b.copy()
        mid[len(b) // 2:] = cc.one_ulp(b[len(b) // 2:])
        out = [quantities(_jax(solver, A, w, **kw))
               for w in (cc.one_ulp(b), mid)]
        square = isinstance(A, np.ndarray) and A.shape[0] == A.shape[1]
        if isinstance(A, np.ndarray):
            out.append(quantities(_jax(solver, cc.one_ulp(A), b, **kw)))
        if square or rev is not None:
            # the same system with its unknowns in reverse order
            r = _jax(solver, A[::-1, ::-1].copy() if square else rev[0],
                     b[::-1].copy(),
                     **dict(kw, **({} if square else {"Ah": rev[1]})))
            out.append(quantities(dict(r, x=r["x"][::-1])))
        return out

    bn = float(np.linalg.norm(b))
    cc.hold(quantities(want), quantities(got), witness, b_norm=bn,
            mmlb_norm=bn)
    return got


def _overdetermined(seed=0, mrows=300, ncols=120, noise=0.01):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((mrows, ncols))
    x = rng.standard_normal(ncols)
    b = A @ x + noise * rng.standard_normal(mrows)
    return A, b


@pytest.mark.parametrize("solver", SOLVERS)
def test_overdetermined_matches_jax_and_lstsq(solver):
    A, b = _overdetermined()
    got = _hold(solver, A, b, tol=1e-12, maxiter=400)
    xref, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert got["status"] == 0
    assert np.linalg.norm(got["x"] - xref) <= 1e-8 * np.linalg.norm(xref)


@pytest.mark.parametrize("solver", SOLVERS)
def test_damped_matches_jax_and_augmented_lstsq(solver):
    A, b = _overdetermined()
    damp = 0.5
    got = _hold(solver, A, b, damp=damp, tol=1e-12, maxiter=400)
    Aaug = np.vstack([A, damp * np.eye(A.shape[1])])
    baug = np.r_[b, np.zeros(A.shape[1])]
    xref, *_ = np.linalg.lstsq(Aaug, baug, rcond=None)
    assert got["status"] == 0
    assert np.linalg.norm(got["x"] - xref) <= 1e-8 * np.linalg.norm(xref)


@pytest.mark.parametrize("solver", SOLVERS)
def test_consistent_callable_resnorms_track_truth(solver):
    """A diagonal as a callable with ``Ah``: the residual estimate at the
    end agrees with the true residual (the JAX test's claim)."""
    d = np.linspace(1.0, 30.0, 200)
    b = np.random.default_rng(1).standard_normal(200)
    dj, dt = jnp.asarray(d), torch.tensor(d)
    op_j, op_t = (lambda v: dj * v), (lambda v: dt * v)
    rev_j = lambda v: dj[::-1] * v
    got = _hold(solver, op_j, b, At=op_t, Aht=op_t, rev=(rev_j, rev_j),
                Ah=op_j, tol=1e-12, maxiter=300)
    r = getattr(F, solver)(op_t, torch.tensor(b), Ah=op_t, tol=1e-12,
                           maxiter=300)
    true_rel = np.linalg.norm(b - d * r.x.numpy()) / np.linalg.norm(b)
    assert got["status"] == 0 and true_rel <= 1e-10
    assert abs(float(r.resnorms[int(r.niter)]) - true_rel) <= 1e-9


@pytest.mark.parametrize("solver", SOLVERS)
def test_underdetermined_minimum_norm(solver):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((60, 150))
    b = rng.standard_normal(60)
    got = _hold(solver, A, b, tol=1e-13, maxiter=400)
    xref, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert np.linalg.norm(got["x"] - xref) <= 1e-7 * np.linalg.norm(xref)


@pytest.mark.parametrize("solver", SOLVERS)
def test_complex(solver):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((80, 40)) + 1j * rng.standard_normal((80, 40))
    b = rng.standard_normal(80) + 1j * rng.standard_normal(80)
    got = _hold(solver, A, b, tol=1e-12, maxiter=300)
    xref, *_ = np.linalg.lstsq(A, b, rcond=None)
    assert np.linalg.norm(got["x"] - xref) <= 1e-8 * np.linalg.norm(xref)


@pytest.mark.parametrize("solver", SOLVERS)
def test_zero_rhs(solver):
    got = _hold(solver, np.eye(16), np.zeros(16), tol=1e-12)
    assert got["status"] == 0 and got["niter"] == 0
    assert np.linalg.norm(got["x"]) == 0.0


@pytest.mark.parametrize("solver", SOLVERS)
def test_callable_requires_Ah(solver):
    with pytest.raises(ValueError, match="Ah"):
        getattr(JF, solver)(lambda v: v, jnp.ones(8))
    with pytest.raises(ValueError, match="Ah"):
        getattr(F, solver)(lambda v: v, torch.ones(8, dtype=torch.float64))


@pytest.mark.parametrize("solver", SOLVERS)
def test_f32_floor_honesty(solver):
    """A below-floor tolerance: no false convergence, a finite iterate
    (the JAX test's claims, on both packages)."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((200, 100)).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32)
    kw = dict(tol=1e-14, btol=1e-14, maxiter=2000, stagnation_window=30)
    for r in (_jax(solver, A, b, **kw), _torch(solver, A, b, **kw)):
        assert r["status"] != 0
        assert np.all(np.isfinite(r["x"]))
        assert r["x"].dtype == np.float32


def test_damp_with_x0_centered_objective():
    rng = np.random.default_rng(11)
    A = rng.standard_normal((200, 80))
    b = rng.standard_normal(200)
    x0 = rng.standard_normal(80)
    damp = 0.5
    Aaug = np.vstack([A, damp * np.eye(80)])
    baug = np.r_[b, damp * x0]
    xref, *_ = np.linalg.lstsq(Aaug, baug, rcond=None)
    for solver in SOLVERS:
        kw = dict(damp=damp, tol=1e-12, maxiter=400)
        j = getattr(JF, solver)(jnp.asarray(A), jnp.asarray(b),
                                x0=jnp.asarray(x0), **kw)
        r = getattr(F, solver)(torch.tensor(A), torch.tensor(b),
                               x0=torch.tensor(x0), **kw)
        assert int(r.status) == int(j.status) == 0, solver
        assert int(r.niter) == int(j.niter), solver
        err = np.linalg.norm(r.x.numpy() - np.asarray(j.x))
        assert err <= 1e-10 * np.linalg.norm(np.asarray(j.x)), solver
        err = np.linalg.norm(r.x.numpy() - xref)
        assert err <= 1e-7 * np.linalg.norm(xref), solver


def test_rectangular_shaped_callable_without_x0():
    rng = np.random.default_rng(12)
    Am = rng.standard_normal((120, 50))
    At = torch.tensor(Am)

    class ShapedOp:
        shape = (120, 50)

        def __call__(self, v):
            return At @ v

    b = rng.standard_normal(120)
    xref, *_ = np.linalg.lstsq(Am, b, rcond=None)
    for solver in SOLVERS:
        r = getattr(F, solver)(ShapedOp(), torch.tensor(b),
                               Ah=lambda y: At.T @ y, tol=1e-12,
                               maxiter=300)
        j = getattr(JF, solver)(jnp.asarray(Am), jnp.asarray(b), tol=1e-12,
                                maxiter=300)
        assert int(r.niter) == int(j.niter), solver
        err = np.linalg.norm(r.x.numpy() - xref)
        assert err <= 1e-7 * np.linalg.norm(xref), solver


def test_shapeless_callable_warns_square():
    """No ``.shape`` and no ``x0``: the square fallback, with the JAX
    package's warning."""
    d = torch.linspace(1.0, 2.0, 12, dtype=torch.float64)
    with pytest.warns(UserWarning, match="SQUARE"):
        r = F.lsqr(lambda v: d * v, torch.ones(12, dtype=torch.float64),
                   Ah=lambda v: d * v, tol=1e-12)
    assert r.x.shape == (12,) and int(r.status) == 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_singular_symmetric_pseudoinverse(solver):
    rng = np.random.default_rng(7)
    n, rank = 80, 50
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = np.r_[np.linspace(5, 1, rank), np.zeros(n - rank)]
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    pinv = np.linalg.pinv(A, hermitian=True)
    b_cons = A @ rng.standard_normal(n)
    b_inc = b_cons + Q[:, rank + 1] * np.linalg.norm(b_cons)
    for b in (b_cons, b_inc):
        got = _hold(solver, A, b, tol=1e-13, maxiter=600)
        xr = pinv @ b
        assert np.linalg.norm(got["x"] - xr) <= 1e-6 * np.linalg.norm(xr)


def test_matrix_rhs_column_shape():
    """A ``(M, 1)`` right-hand side returns an ``(N, 1)`` iterate, as in
    the JAX package."""
    A, b = _overdetermined(ncols=40)
    for solver in SOLVERS:
        r = getattr(F, solver)(torch.tensor(A), torch.tensor(b)[:, None],
                               tol=1e-10)
        j = getattr(JF, solver)(jnp.asarray(A), jnp.asarray(b)[:, None],
                                tol=1e-10)
        assert tuple(r.x.shape) == tuple(j.x.shape) == (40, 1)


def test_lsmr_normal_residual_estimate_never_rises(monkeypatch):
    """LSMR minimizes ||A^H r_k|| over the Krylov space, so its estimate
    never rises (lsq's module docstring); LSQR's may.  Read where the
    solver hands each iteration's estimate to its stop tests, on the
    overdetermined and the damped cases."""
    A, b = _overdetermined()
    stop_tests = lsq._Problem.stop_tests
    for damp in (0.0, 0.5):
        seen = []

        def observed(pb, normar, *rest):
            seen.append(float(normar))
            return stop_tests(pb, normar, *rest)

        monkeypatch.setattr(lsq._Problem, "stop_tests", observed)
        F.lsmr(torch.tensor(A), torch.tensor(b), damp=damp, tol=1e-12,
               maxiter=400)
        ar = np.array(seen)
        assert len(ar) > 10 and np.all(np.diff(ar) <= 0)


def test_numpy_operands_go_to_the_card():
    """numpy ``A`` and ``b`` go to the default CUDA device, as the other
    solvers' numpy operands do (here: raises, no card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        F.lsqr(np.eye(4), np.ones(4))


def _jax_northstar(nx):
    """The JAX package's padded north-star operator (its h^2-scaled
    stencil, float64) and its transpose by ``jax.linear_transpose``."""
    from krypy_tpu import ops as jops

    cc, cu, cd, cl, cr = northstar.cd_coeffs(nx)
    h = 1.0 / (nx + 1)
    A = jops.convection_diffusion_2d(nx, wind=(h * h, 0.5 * h * h),
                                     eps=h * h, impl="jnp", pad_cols=True)
    N = A.shape[0]
    t = jax.linear_transpose(A, jnp.zeros(N))
    # cd_transpose's pads are zero (its docstring): the same here
    mask = jops.pad_grid_vec(jnp.ones(nx * nx), nx, nx)
    return A, lambda y: mask * t(y)[0], N


@pytest.mark.parametrize("solver", SOLVERS)
def test_northstar_with_cd_transpose_matches_jax(solver):
    """The card phase's problem at 63^2: the north star's padded operator
    (``impl="cuda"``: K1's plain version on the CPU) with ``Ah =
    northstar.cd_transpose`` and the phase's Tikhonov ``damp``, float64,
    against the JAX package on its padded stencil with the reverse-mode
    transpose (the rule of this file); then the normal-equations residual
    of the port's result, recomputed."""
    nx, damp = 63, LSQ_DAMP
    h2 = 1.0 / (nx + 1) ** 2
    A = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                    impl="cuda", pad_cols=True, device="cpu")
    At = northstar.cd_transpose(nx, "cuda")
    jA, jAt, N = _jax_northstar(nx)
    assert A.shape[0] == N
    b = ops.pad_grid_vec(torch.tensor(
        np.random.default_rng(16).standard_normal(nx * nx)), nx, nx)
    got = _hold(solver, jA, b.numpy(), At=A, Aht=At, Ah=jAt, damp=damp,
                tol=1e-8, maxiter=2000)
    assert got["status"] == 0
    x = torch.tensor(got["x"])
    g = At(b - A(x)) - damp ** 2 * x
    assert float(torch.linalg.vector_norm(g)) <= \
        1e-6 * float(torch.linalg.vector_norm(At(b)))


def test_estimate_runs_without_warning_on_zero_damp_rows():
    """The host recurrences divide only through the guarded division:
    no numpy warning escapes on a zero right-hand side or a breakdown."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for solver in SOLVERS:
            getattr(F, solver)(torch.eye(6, dtype=torch.float64),
                               torch.zeros(6, dtype=torch.float64))
            r = getattr(F, solver)(torch.eye(6, dtype=torch.float64),
                                   torch.ones(6, dtype=torch.float64),
                                   tol=1e-14)
            assert int(r.status) in (0, 2)
