"""The port's nonsymmetric short recurrences (``bicgstab``, ``tfqmr``,
``qmr`` with ``transpose_matvec``, ``idrs``, ``fgmres``) against
krypy_tpu.functional's on the same numpy inputs.

Float64 cases (the JAX tests' own: dense nonsymmetric, complex, warm
start, zero right-hand side, an unreachable tolerance, a breakdown; a
Jacobi-preconditioned stencil; each solver's options): ``status`` and
``niter`` equal, ``x`` and the residual history to ``1e-10`` relative
(the history above the absolute floor ``1e3 eps`` of a relative
residual), by the rule of tests/torch_compat_cases.py: a quantity that
misses ``1e-10`` passes only where the JAX package's own solve moves
beyond it when one ulp is added to ``b[0]``, to ``b[N // 2]`` (on a
stencil one ulp of a boundary entry may round away) or to ``A[0, 0]``,
and the port by at most ``1e4`` times that.  BiCGStab's, TFQMR's and IDR's
residual polynomials are rounding-steered (the JAX package's own
BiCGStab history moves by 1.5e-2 under one ulp of b on the dense case).

IDR(s) draws its shadow panel with ``jax.random`` in the JAX package and
with a ``torch.Generator`` in the port; the parity cases carry the JAX
panel across through the port's ``idr._shadow_block`` (monkeypatched),
and :func:`test_idrs_own_draw_counts` holds the port's own draw to the
JAX counts within one cycle of ``s + 1`` matvecs per ten.

The padded lane at 63^2 in float64 (the north star's h^2-scaled operator
and padded V-cycle; the JAX side built with ``impl="pallas"``, the port's
with ``impl="cuda"``, both of which take their plain stencils in
float64) and the slice end to end at 127^2
(:func:`krypy_tpu_torch.northstar.make_nonsym` on the CPU, K1-K3's plain
versions, against the same pipeline in JAX with its Pallas kernels
interpreted): float32 inner solves, so equal refinement cycles, inner
iterations per cycle within 1 (ROADMAP.md C, float32 reductions; for
IDR(s), whose count is matvecs, one cycle of ``s + 1``), and both below
1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_compat_cases as cc
from krypy_tpu import functional as JF, ops as jops
from krypy_tpu.functional import idr as jidr
from krypy_tpu.functional.common import SolveResult as JResult
from krypy_tpu_torch import functional as F, interop, ops
from krypy_tpu_torch.functional import idr as tidr
from krypy_tpu_torch.northstar import (
    NONSYM_SOLVERS,
    cd_coeffs,
    cd_transpose,
    make_nonsym,
)

torch.set_num_threads(1)

SOLVERS = ("bicgstab", "tfqmr", "qmr", "idrs", "fgmres")
#: maxiter per solver on the dense cases (idrs counts matvecs)
MAXITER = {"bicgstab": 300, "tfqmr": 300, "qmr": 300, "idrs": 500,
           "fgmres": 100}


def _dense(n, seed=0, spread=(1, 20), skew=0.3, cplx=False):
    """The JAX tests' triangular-plus-diagonal nonsymmetric matrix (a
    complex one adds ``0.05 (randn + i randn)``), and its generator."""
    rng = np.random.RandomState(seed)
    A = (np.diag(np.linspace(*spread, n))
         + skew * np.triu(rng.randn(n, n), 1) / np.sqrt(n))
    if cplx:
        A = A + 0.05 * (rng.randn(n, n) + 1j * rng.randn(n, n))
    return A, rng


def _jax_panel(seed, s, N, dtype, r0):
    """The JAX package's shadow panel for the port's ``r0``."""
    jdt = jnp.dtype(str(dtype).replace("torch.", ""))
    P = jidr._shadow_block(jax.random.PRNGKey(seed), s, N, jdt,
                           jnp.asarray(interop.to_numpy(r0)))
    return torch.from_numpy(np.array(P)).to(r0.device)


@pytest.fixture
def jax_panel(monkeypatch):
    monkeypatch.setattr(tidr, "_shadow_block", _jax_panel)


def _tensor(a):
    return None if a is None else interop.from_numpy(np.asarray(a), "cpu")


def _run(pkg, solver, A, b, kw):
    """One solve by ``pkg`` ("jax" or "torch") on numpy inputs (``A`` a
    matrix or ``{"jax": op, "torch": op}``); its results as numpy."""
    kw = dict(kw)
    for key in ("x0", "AT", "MT", "M"):
        v = kw.get(key)
        if isinstance(v, dict):
            kw[key] = v[pkg]
        elif isinstance(v, np.ndarray):
            kw[key] = jnp.asarray(v) if pkg == "jax" else _tensor(v)
    if isinstance(A, dict):
        A = A[pkg]
    elif pkg == "jax":
        A = jnp.asarray(A)
    else:
        A = _tensor(A)
    if pkg == "jax":
        r = _jax_solver(solver, A, kw)(jnp.asarray(b))
        x, res = np.asarray(r.x), np.asarray(r.resnorms)
    else:
        r = getattr(F, solver)(A, _tensor(b), **kw)
        x, res = interop.to_numpy(r.x), interop.to_numpy(r.resnorms)
    return {"x": x, "resnorms": res, "niter": int(r.niter),
            "status": int(r.status)}


_JITTED = {}


def _key(v):
    if isinstance(v, (np.ndarray, jnp.ndarray)):
        a = np.asarray(v)
        return (a.shape, a.dtype.str, a.tobytes())
    return id(v) if callable(v) else v


def _jax_solver(solver, A, kw):
    """The JAX solve as one compiled function of ``b``, kept for the
    witnesses' reruns on the same operator (an eager call compiles its
    loop anew each time)."""
    key = (solver, _key(A), tuple(sorted((k, _key(v)) for k, v in
                                         kw.items())))
    if key not in _JITTED:
        if len(_JITTED) > 8:
            _JITTED.clear()
        _JITTED[key] = jax.jit(
            lambda bb: getattr(JF, solver)(A, bb, **kw))
    return _JITTED[key]


def _hold(solver, A, b, **kw):
    """The port's solve against the JAX package's (module docstring);
    returns the JAX package's results."""
    want = _run("jax", solver, A, b, kw)
    got = _run("torch", solver, A, b, kw)
    assert (got["status"], got["niter"]) == (want["status"], want["niter"])
    assert got["resnorms"].shape == want["resnorms"].shape
    np.testing.assert_array_equal(np.isnan(got["resnorms"]),
                                  np.isnan(want["resnorms"]))
    assert got["x"].shape == want["x"].shape
    live = ~np.isnan(want["resnorms"])

    def quantities(r):
        return {"xk": r["x"], "resnorms": r["resnorms"][live]}

    def witness():
        mid = b.copy()
        mid[len(b) // 2:] = cc.one_ulp(b[len(b) // 2:])
        out = [quantities(_run("jax", solver, A, w, kw))
               for w in (cc.one_ulp(b), mid)]
        if isinstance(A, np.ndarray):
            out.append(quantities(_run("jax", solver, cc.one_ulp(A), b,
                                       kw)))
        return out

    bn = float(np.linalg.norm(b))
    cc.hold(quantities(want), quantities(got), witness, b_norm=bn,
            mmlb_norm=bn)
    return want


# ---------------------------------------------------------------------------
# the JAX tests' cases, every solver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", SOLVERS)
def test_dense_nonsymmetric_matches_jax(solver, jax_panel):
    A, rng = _dense(120, skew=0.3)
    A = A + 0.05 * rng.randn(120, 120)
    b = rng.randn(120)
    want = _hold(solver, A, b, tol=1e-10, maxiter=MAXITER[solver])
    assert want["status"] == 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_complex_matches_jax(solver, jax_panel):
    A, rng = _dense(80, spread=(1, 8), skew=0.2, cplx=True)
    b = rng.randn(80) + 1j * rng.randn(80)
    want = _hold(solver, A, b, tol=1e-9, maxiter=MAXITER[solver])
    assert want["status"] == 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_warm_start_matches_jax(solver, jax_panel):
    A, rng = _dense(80, seed=5, spread=(1, 8), skew=0.2)
    b, x0 = rng.randn(80), rng.randn(80)
    want = _hold(solver, A, b, x0=x0, tol=1e-10, maxiter=MAXITER[solver])
    assert want["status"] == 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_zero_rhs_matches_jax(solver, jax_panel):
    A, _ = _dense(40, seed=2)
    kw = {"maxiter": 8} if solver == "fgmres" else {}
    want = _hold(solver, A, np.zeros(40), tol=1e-10, **kw)
    assert (want["status"], want["niter"]) == (0, 0)
    assert not np.any(want["x"])


@pytest.mark.parametrize("solver", SOLVERS)
def test_unreachable_tolerance_matches_jax(solver, jax_panel):
    A, rng = _dense(150, seed=9, spread=(1, 3000), skew=0.5)
    b = rng.randn(150)
    want = _hold(solver, A, b, tol=1e-14, maxiter=10)
    assert want["status"] in (1, 2)


@pytest.mark.parametrize("solver", SOLVERS)
def test_breakdown_matches_jax(solver, jax_panel):
    """The cyclic shift with b = e_0: every shadow coupling vanishes
    (BiCGStab's omega, TFQMR's pivot, QMR's q^T A p, IDR's M[k, k]);
    FGMRES meets an invariant space on a singular system whose b has a
    null-space component."""
    n = 12
    if solver == "fgmres":
        A = np.diag(np.r_[0.0, np.repeat([1.0, 2.0, 3.0], 4)[:n - 1]])
        b = np.ones(n)
    else:
        A = np.roll(np.eye(n), 1, axis=0)
        b = np.eye(n)[0]
    want = _hold(solver, A, b, tol=1e-10, maxiter=MAXITER[solver])
    assert want["status"] == 2


@pytest.mark.parametrize("solver", ("bicgstab", "tfqmr", "qmr", "idrs"))
def test_jacobi_preconditioned_stencil_matches_jax(solver, jax_panel):
    """The convection-diffusion stencil with a Jacobi right preconditioner
    (QMR transposes ``A M`` itself, through both packages' automatic
    transpose)."""
    nx = 16
    A = {"jax": jops.convection_diffusion_2d(nx, nx),
         "torch": ops.convection_diffusion_2d(nx, nx, device="cpu")}
    M = {"jax": jops.jacobi_preconditioner(A["jax"]),
         "torch": ops.jacobi_preconditioner(A["torch"])}
    b = np.random.RandomState(4).randn(nx * nx)
    want = _hold(solver, A, b, M=M, tol=1e-9, maxiter=400)
    assert want["status"] == 0


def test_column_rhs_keeps_its_shape(jax_panel):
    A, rng = _dense(30, seed=1)
    b = rng.randn(30, 1)
    for solver in SOLVERS:
        got = _run("torch", solver, A, b, {"tol": 1e-9, "maxiter": 200})
        assert got["x"].shape == (30, 1)


# ---------------------------------------------------------------------------
# each solver's own options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["classic", "1r"])
@pytest.mark.parametrize("cplx", [False, True])
def test_qmr_variants_match_jax(variant, cplx):
    A, rng = _dense(100, seed=3, spread=(1, 10), skew=0.2, cplx=cplx)
    b = rng.randn(100) + (1j * rng.randn(100) if cplx else 0)
    _hold("qmr", A, b, tol=1e-9, maxiter=300, variant=variant)


@pytest.mark.parametrize("transposes", ["AT", "AT MT", "MT", "none"])
def test_qmr_transposes_match_jax(transposes):
    """``AT``/``MT`` given or derived: with ``M`` and neither, the
    transpose of ``A M`` is taken whole; with one, the other is derived
    alone."""
    A, rng = _dense(80, seed=4, spread=(1, 50), skew=0.2)
    Dinv = 1.0 / np.diag(A)
    b = rng.randn(80)
    M = {"jax": lambda x: jnp.asarray(Dinv) * x,
         "torch": lambda x: _tensor(Dinv) * x}
    kw = {"M": M}
    if "AT" in transposes.split():
        kw["AT"] = A.T.copy()
    if "MT" in transposes.split():
        kw["MT"] = M
    want = _hold("qmr", A, b, tol=1e-10, maxiter=300, **kw)
    assert want["status"] == 0


@pytest.mark.parametrize("cplx", [False, True])
def test_transpose_matvec_matches_jax(cplx):
    """The bilinear transpose (no conjugation) of a dense matvec."""
    rng = np.random.RandomState(0)
    A = rng.randn(40, 40) + (1j * rng.randn(40, 40) if cplx else 0)
    x = rng.randn(40) + (1j * rng.randn(40) if cplx else 0)
    Aj, At = jnp.asarray(A), _tensor(A)
    want = np.asarray(JF.transpose_matvec(lambda v: Aj @ v, 40, Aj.dtype)(
        jnp.asarray(x)))
    got = interop.to_numpy(F.transpose_matvec(
        lambda v: At @ v, 40, At.dtype, device="cpu")(_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got, A.T @ x, rtol=1e-12)


def _padded(nx, impl, pkg):
    h2 = (1.0 / (nx + 1)) ** 2
    mod = jops if pkg == "jax" else ops
    dev = {} if pkg == "jax" else {"device": "cpu"}
    return mod.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                       pad_cols=True, impl=impl, **dev)


def test_padded_auto_transpose_matches_jax_pads_included():
    """The reverse-mode transpose of the padded plain operator writes the
    pad column (and row) that the forward stencil reads as its Dirichlet
    ghosts, as ``jax.linear_transpose`` does; K1 with the swapped
    coefficients (:func:`~krypy_tpu_torch.northstar.cd_transpose`)
    agrees on the logical grid and leaves the pads zero."""
    nx = 63
    jA, tA = _padded(nx, "jnp", "jax"), _padded(nx, "torch", "torch")
    N = jA.shape[0]
    x = np.zeros((64, 128))
    x[:nx, :nx] = np.random.RandomState(2).randn(nx, nx)
    x = x.reshape(-1)
    want = np.asarray(JF.transpose_matvec(jA, N, jnp.float64)(
        jnp.asarray(x)))
    got = interop.to_numpy(F.transpose_matvec(tA, N, torch.float64,
                                              device="cpu")(_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    pads = want.reshape(64, 128).copy()
    pads[:nx, :nx] = 0.0
    assert np.max(np.abs(pads)) > 1.0
    swapped = interop.to_numpy(cd_transpose(nx, "torch")(_tensor(x)))
    logical = np.zeros((64, 128), bool)
    logical[:nx, :nx] = True
    np.testing.assert_allclose(swapped.reshape(64, 128)[logical],
                               want.reshape(64, 128)[logical], rtol=1e-12,
                               atol=1e-12)
    assert not np.any(swapped.reshape(64, 128)[~logical])


def test_qmr_padded_auto_transpose_matches_jax():
    """QMR on the padded operator with no ``AT``: its shadow vectors
    carry the pad entries on both sides."""
    nx = 31
    A = {"jax": _padded(nx, "jnp", "jax"),
         "torch": _padded(nx, "torch", "torch")}
    b = np.zeros((32, 128))
    b[:nx, :nx] = np.random.RandomState(6).randn(nx, nx)
    want = _hold("qmr", A, b.reshape(-1), tol=1e-10, maxiter=300)
    assert want["status"] == 0


def test_qmr_on_k1_without_AT_raises_as_jax():
    """K1 has no reverse mode, as the JAX package's Pallas K1 has no
    transpose rule: qmr on a float32 kernel operator needs ``AT=``."""
    nx = 15
    b = np.zeros((16, 128), np.float32)
    b[:nx, :nx] = 1.0
    b = b.reshape(-1)
    with pytest.raises(AssertionError):
        JF.qmr(_padded(nx, "pallas", "jax"), jnp.asarray(b), maxiter=3)
    with pytest.raises(NotImplementedError, match="AT="):
        F.qmr(_padded(nx, "cuda", "torch"), _tensor(b), maxiter=3)
    res = F.qmr(_padded(nx, "cuda", "torch"), _tensor(b), maxiter=3,
                AT=cd_transpose(nx, "cuda"))
    assert res.x.dtype == torch.float32 and int(res.niter) == 3


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("variant", ["classic", "1r"])
def test_idrs_carried_panel_matches_jax(s, variant, jax_panel):
    A, rng = _dense(100, seed=3, spread=(1, 10), skew=0.2)
    A = A + 0.03 * rng.randn(100, 100)
    b = rng.randn(100)
    want = _hold("idrs", A, b, s=s, tol=1e-10, maxiter=400,
                 variant=variant)
    assert want["status"] == 0


@pytest.mark.parametrize("s", [1, 4, 8])
def test_idrs_own_draw_counts(s):
    """The port's own panel (a seeded torch.Generator): orthonormal, row
    0 the normalized residual, and the JAX package's matvec count within
    one cycle per ten (``ceil(niter / 10)`` cycles of ``s + 1``)."""
    A, rng = _dense(120, seed=0)
    A = A + 0.05 * rng.randn(120, 120)
    b = rng.randn(120)
    r0 = _tensor(b)
    P = tidr._shadow_block(0, s, 120, torch.float64, r0)
    np.testing.assert_allclose(interop.to_numpy(P @ P.T), np.eye(s),
                               atol=1e-14)
    np.testing.assert_allclose(interop.to_numpy(P[0]),
                               b / np.linalg.norm(b), atol=1e-15)
    want = _run("jax", "idrs", A, b, {"s": s, "tol": 1e-10, "maxiter": 500})
    got = _run("torch", "idrs", A, b, {"s": s, "tol": 1e-10, "maxiter": 500})
    assert want["status"] == got["status"] == 0
    assert abs(got["niter"] - want["niter"]) <= \
        (s + 1) * -(-want["niter"] // 10)


@pytest.mark.parametrize("ortho", ["cgs", "cgs2", "bmgs", "bmgs2"])
def test_fgmres_orthos_match_jax(ortho):
    A, rng = _dense(80, seed=0, spread=(1, 20), skew=0.3)
    A = A + 0.1 * rng.randn(80, 80)
    b = rng.randn(80)
    Minv = np.diag(1.0 / np.diag(A))
    # maxiter 40 > 16: bmgs sweeps three panels
    want = _hold("fgmres", A, b, M=Minv, tol=1e-12, maxiter=40,
                 ortho=ortho)
    assert want["status"] in (0, 1)


def test_fgmres_varying_M_matches_jax():
    """A preconditioner that depends on its input (tests/test_fgmres.py's
    ``wobbly``) and one that alternates between two scalings by call."""
    A, rng = _dense(60, seed=1, spread=(1, 20), skew=0.0)
    A = A + 0.05 * rng.randn(60, 60)
    b = rng.randn(60)
    d = 1.0 / np.diag(A)
    dj, dt = jnp.asarray(d), _tensor(d)
    M = {"jax": lambda v: dj * v * (1.0 + 0.3 * jnp.tanh(jnp.sum(v))),
         "torch": lambda v: dt * v * (1.0 + 0.3 * torch.tanh(torch.sum(v)))}
    want = _hold("fgmres", A, b, M=M, tol=1e-11, maxiter=60)
    assert want["status"] == 0

    def alternating(scale, mul):
        calls = [0]

        def M(v):
            calls[0] += 1
            return mul(v) * (scale if calls[0] % 2 else 1.0)

        return M

    # inside a JAX while_loop the body is traced once; the alternation by
    # call runs in the port only: held to its own fixed-M solve's residual
    got = F.fgmres(_tensor(A), _tensor(b), tol=1e-11, maxiter=60,
                   M=alternating(0.5, lambda v: dt * v))
    assert int(got.status) == 0
    rel = np.linalg.norm(b - A @ interop.to_numpy(got.x)) / np.linalg.norm(b)
    assert rel <= 1e-10


# ---------------------------------------------------------------------------
# the padded lane and the slice end to end
# ---------------------------------------------------------------------------


def _vcycle(nx, impl, pkg):
    h2 = (1.0 / (nx + 1)) ** 2
    mod = jops if pkg == "jax" else ops
    dev = {} if pkg == "jax" else {"device": "cpu"}
    return mod.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        scale=1.0 / h2, **dev)


def _jax_transpose(nx):
    from krypy_tpu.ops import _padded_stencil_matvec

    cc_, cu, cd, cl, cr = cd_coeffs(nx)
    return _padded_stencil_matvec(nx, nx, (cc_, cd, cu, cr, cl), "pallas")[0]


#: the chip phase's solvers but their "1r" forms, which the dense and
#: panel cases hold to JAX
CLASSIC = [label for label in NONSYM_SOLVERS if not label.endswith(" 1r")]


@pytest.mark.parametrize("label", CLASSIC)
def test_padded_vcycle_lane_matches_jax(label, jax_panel):
    """Each solver of the card's phase on the padded operator with the
    padded V-cycle as ``M`` at 63^2, float64 (qmr with ``AT`` the swapped
    stencil and ``MT = M``)."""
    nx = 63
    name, kw = NONSYM_SOLVERS[label]
    A = {"jax": _padded(nx, "pallas", "jax"),
         "torch": _padded(nx, "cuda", "torch")}
    M = {"jax": _vcycle(nx, "pallas", "jax"),
         "torch": _vcycle(nx, "cuda", "torch")}
    # the chip phase's caps are for its float32 refinement cycles; a
    # float64 solve to 1e-10 takes more
    kw = dict(kw, M=M, maxiter=4 * kw["maxiter"])
    if name == "qmr":
        kw.update(AT={"jax": _jax_transpose(nx),
                      "torch": cd_transpose(nx, "cuda")}, MT=M)
    b = np.zeros((64, 128))
    b[:nx, :nx] = np.random.RandomState(11).randn(nx, nx)
    want = _hold(name, A, b.reshape(-1), tol=1e-10, **kw)
    assert want["status"] == 0


def _jax_pipeline(nx, label):
    """The slice's pipeline as the JAX package runs it: float64
    refinement around ONE jitted float32 inner solve per cycle (at 127^2
    every call converges, so ``make_nonsym``'s restart control makes no
    second call)."""
    name, kw = NONSYM_SOLVERS[label]
    h2 = (1.0 / (nx + 1)) ** 2
    h2_f32 = jnp.float32(h2)
    cd32 = _padded(nx, "pallas", "jax")
    cd64 = jops.convection_diffusion_2d(nx, wind=(1.0, 0.5), eps=1.0)
    kw = dict(kw, M=_vcycle(nx, "pallas", "jax"))
    if name == "qmr":
        kw.update(AT=_jax_transpose(nx), MT=kw["M"])
    calls = []

    @jax.jit
    def inner(r32):
        rs = jops.pad_grid_vec(r32 * h2_f32, nx, nx)
        res = getattr(JF, name)(cd32, rs, tol=1e-3, **kw)
        return jops.unpad_grid_vec(res.x, nx, nx), res.niter

    def inner_solve(r32):
        x, n = inner(r32)
        calls.append(int(n))
        return JResult(x=x, resnorms=jnp.zeros(1), niter=n,
                       status=jnp.asarray(1))

    b = jnp.ones(nx * nx)
    res, info = JF.refine_to(cd64, b, inner_solve, tol=1e-8)
    rel = float(jnp.linalg.norm(b - cd64(res.x)) / jnp.linalg.norm(b))
    return calls, rel


@pytest.mark.parametrize("label", CLASSIC)
def test_slice_matches_jax(label, monkeypatch):
    """``make_nonsym`` at 127^2 on the kernel lane's plain versions
    against the JAX pipeline (idrs on the JAX panel of each inner
    solve's residual)."""
    nx = 127
    name, kw = NONSYM_SOLVERS[label]
    monkeypatch.setattr(tidr, "_shadow_block", _jax_panel)
    want, want_rel = _jax_pipeline(nx, label)
    solve, cd64 = make_nonsym(nx, "cuda", label, "cpu")
    b = torch.ones(nx * nx, dtype=torch.float64)
    res, info = solve(b, warm=False)
    rel = float(torch.linalg.vector_norm(b - cd64(res.x))
                / torch.linalg.vector_norm(b))
    # one converged call per cycle (no restart), as the JAX pipeline runs
    assert [c["status"] for c in info["calls"]] == [0] * info["cycles"]
    got = info["inner"]
    assert len(got) == len(want) == info["cycles"]
    # one iteration; IDR(s) counts matvecs, s + 1 to its cycle
    slack = kw.get("s", 0) + 1 if name == "idrs" else 1
    assert all(abs(p - q) <= slack for p, q in zip(got, want)), (got, want)
    assert rel <= 1e-8 and want_rel <= 1e-8


def test_make_nonsym_counts_its_applications():
    """The applications ``make_nonsym`` records are those the iteration
    counts predict (the identity chip_smoke.py gates K1-K3's launches
    on)."""
    from chip_smoke import _nonsym_applications

    for label, (name, _) in NONSYM_SOLVERS.items():
        solve, _ = make_nonsym(31, "torch", label, "cpu")
        _, info = solve(torch.ones(31 * 31, dtype=torch.float64),
                        warm=False)
        for call in info["calls"]:
            want, e = _nonsym_applications(name, call)
            assert {k: call[k] for k in want} == want, (label, call)
            assert e >= (call["status"] == 0)
