"""The port's GMRES (krypy_tpu_torch.functional.gmres) against
krypy_tpu.functional.gmres in float64 on the same numpy inputs.

Problems: 2-D convection-diffusion at 31^2, unpadded (no preconditioner),
grid-padded with the padded multigrid V-cycle on the left (the analog of
tests/test_padded.py's padded GMRES solve), and padded with the V-cycle
on the right; each with ``ortho="cgs2"`` and ``"cgs2_fused"`` (the JAX
side runs its Pallas kernels in interpret mode, as it does off the TPU).

Also the options of the deflation slice: the ``cgs``/``cgs_pallas``/
``cgs2_pallas`` schemes (K7's plain version against the Pallas kernel
interpreted), the dual basis of ``M``, ``return_internal`` and the three
deflation hooks.

Tolerances: iteration counts and status equal; residual histories
``rtol=1e-8`` plus ``atol=1e-14``, because the final entries are explicit
residuals near 1e-11 whose own float64 rounding is ~1e-17 absolute (a
relative 1e-8 of them is below it); iterates ``1e-10`` relative.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, interop, ops
from krypy_tpu_torch.functional.gmres import _resolve_ortho

torch.set_num_threads(1)

NX = 31
PROBLEMS = ("unpadded", "padded_Ml", "padded_Mr")


@functools.lru_cache(maxsize=None)
def _problem(name):
    """(port operators, JAX operators, rhs, exact solution of the
    problem's own layout) for one problem."""
    pad = name != "unpadded"
    At = ops.convection_diffusion_2d(NX, pad_cols=pad, device="cpu")
    Aj = jops.convection_diffusion_2d(NX, pad_cols=pad)
    kt, kj = {}, {}
    if pad:
        side = name[-2:]
        kt[side] = ops.multigrid_poisson_preconditioner(
            NX, coarsest=7, pad_cols=True, device="cpu")
        kj[side] = jops.multigrid_poisson_preconditioner(
            NX, coarsest=7, pad_cols=True)
    rng = np.random.default_rng(len(name))
    b = rng.standard_normal(NX * NX)
    xs = rng.standard_normal(NX * NX)
    if pad:
        b, xs = (np.asarray(jops.pad_grid_vec(jnp.asarray(v), NX, NX))
                 for v in (b, xs))
    return (At, kt), (Aj, kj), b, xs


@functools.lru_cache(maxsize=None)
def _jax(name, ortho, maxiter=60, explicit_residual=False):
    _, (Aj, kj), b, xs = _problem(name)
    return JF.gmres(Aj, jnp.asarray(b), tol=1e-10, maxiter=maxiter,
                    ortho=ortho, explicit_residual=explicit_residual,
                    exact_solution=jnp.asarray(xs), **kj)


def _torch(name, ortho, maxiter=60, **kw):
    (At, kt), _, b, xs = _problem(name)
    return F.gmres(At, interop.from_numpy(b, "cpu"), tol=1e-10,
                   maxiter=maxiter, ortho=ortho,
                   exact_solution=interop.from_numpy(xs, "cpu"), **kt, **kw)


def _hist_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14)


def _compare(rj, rt):
    assert int(rt.niter) == int(rj.niter)
    assert int(rt.status) == int(rj.status)
    _hist_close(interop.to_numpy(rt.resnorms), rj.resnorms)
    xj, xt = np.asarray(rj.x), interop.to_numpy(rt.x)
    assert xt.dtype == np.float64
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_fused"])
@pytest.mark.parametrize("name", PROBLEMS)
def test_gmres_matches_jax(name, ortho):
    """Also ``exact_solution``'s error norms, one per iteration."""
    rj, rt = _jax(name, ortho), _torch(name, ortho)
    _compare(rj, rt)
    _hist_close(interop.to_numpy(rt.errnorms), rj.errnorms)
    if name != "unpadded":
        assert int(rt.status) == F.CONVERGED


def test_explicit_residual_matches_jax():
    rj = _jax("padded_Ml", "cgs2", explicit_residual=True)
    rt = _torch("padded_Ml", "cgs2", explicit_residual=True)
    _compare(rj, rt)


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_fused"])
@pytest.mark.parametrize("compiled", [False, True])
def test_restarted_gmres_matches_jax(compiled, ortho):
    """GMRES(6) restarted on the left-preconditioned padded problem: the
    host form's per-iteration history across cycles, the compiled form's
    one entry per cycle and total inner iterations."""
    (At, kt), (Aj, kj), b, _ = _problem("padded_Ml")
    kw = dict(max_restarts=5, maxiter=6, tol=1e-10, compiled=compiled,
              ortho=ortho)
    rj = JF.restarted_gmres(Aj, jnp.asarray(b), **kw, **kj)
    rt = F.restarted_gmres(At, interop.from_numpy(b, "cpu"), **kw, **kt)
    assert rt.resnorms.shape == tuple(np.shape(rj.resnorms))
    if compiled:
        assert rt.resnorms.shape == (7,) and rt.errnorms is None
    _compare(rj, rt)


def test_restarted_gmres_2d_rhs_keeps_shape():
    (At, _), _, b, _ = _problem("unpadded")
    b2 = interop.from_numpy(b[:, None], "cpu")
    for compiled in (False, True):
        res = F.restarted_gmres(At, b2, max_restarts=1, maxiter=4,
                                compiled=compiled)
        assert res.x.shape == (NX * NX, 1)
    assert F.gmres(At, b2, maxiter=3).x.shape == (NX * NX, 1)


def test_auto_rule():
    """``ortho="auto"``: the fused kernels for a float32 system on a CUDA
    device whose basis fits them, batched cgs2 otherwise; on the CPU the
    solve is cgs2's, bit for bit."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _resolve_ortho("auto", torch.float32, cuda, 26) == "cgs2_fused"
    assert _resolve_ortho("auto", torch.float64, cuda, 26) == "cgs2"
    assert _resolve_ortho("auto", torch.float32, cpu, 26) == "cgs2"
    (At, kt), _, b, _ = _problem("padded_Ml")
    b32 = interop.from_numpy(b.astype(np.float32), "cpu")
    ra = F.gmres(At, b32, Ml=kt["Ml"], tol=1e-5, maxiter=20, ortho="auto")
    rc = F.gmres(At, b32, Ml=kt["Ml"], tol=1e-5, maxiter=20, ortho="cgs2")
    assert ra.x.dtype == torch.float32
    assert torch.equal(ra.x, rc.x) and int(ra.niter) == int(rc.niter)


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1709),
                                         (torch.float64, 854)])
def test_fused_rule_checks_the_kernels_row_limit(dtype, limit):
    """A basis taller than K5's shared memory takes (``max_rows``) sends
    ``auto`` to cgs2, and makes an explicit ``cgs2_fused`` raise before
    the first iteration on a CUDA device; the CPU's plain versions have
    no limit."""
    from krypy_tpu_torch.kernels import orthogonalize as korth

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert korth.max_rows(torch.empty(0, dtype=dtype).element_size()) \
        == limit
    assert _resolve_ortho("cgs2_fused", dtype, cuda, limit) == "cgs2_fused"
    assert _resolve_ortho("cgs2_fused", dtype, cpu, limit + 1) \
        == "cgs2_fused"
    with pytest.raises(ValueError, match="maxiter"):
        _resolve_ortho("cgs2_fused", dtype, cuda, limit + 1)
    if dtype == torch.float32:
        assert _resolve_ortho("auto", dtype, cuda, limit) == "cgs2_fused"
        assert _resolve_ortho("auto", dtype, cuda, limit + 1) == "cgs2"


def test_breakdown_status_matches_jax():
    """A diagonal operator with 3 distinct eigenvalues: the Krylov space
    becomes invariant after 3 iterations."""
    d = np.repeat([1.0, 2.0, 5.0], 4)
    b = np.arange(1.0, 13.0)
    rj = JF.gmres(jnp.asarray(np.diag(d)), jnp.asarray(b), tol=1e-300,
                  maxiter=8)
    rt = F.gmres(torch.tensor(np.diag(d)), torch.tensor(b), tol=1e-300,
                 maxiter=8)
    assert int(rj.status) == int(rt.status) == F.BREAKDOWN
    assert int(rt.niter) == int(rj.niter) == 3
    np.testing.assert_allclose(interop.to_numpy(rt.x), np.asarray(rj.x),
                               rtol=1e-12)


def test_progress_prints_each_iteration(capsys):
    (At, _), _, b, _ = _problem("unpadded")
    F.gmres(At, interop.from_numpy(b, "cpu"), maxiter=3, progress=True)
    assert capsys.readouterr().out.count("gmres iter") == 3


@pytest.mark.parametrize("ortho", ["cgs", "cgs_pallas", "cgs2_pallas"])
@pytest.mark.parametrize("name", ["unpadded", "padded_Ml"])
def test_gmres_new_ortho_names_match_jax(name, ortho):
    """One and two passes of batched CGS, and K7 once or twice over the
    active prefix against the Pallas kernel's full-height sweep."""
    rj, rt = _jax(name, ortho), _torch(name, ortho)
    _compare(rj, rt)


def _m_problem():
    """An SPD diagonal ``M`` (and a left preconditioner) on the unpadded
    convection-diffusion problem."""
    (At, _), (Aj, _), b, _ = _problem("unpadded")
    rng = np.random.default_rng(21)
    dm = rng.uniform(0.5, 2.0, NX * NX)
    dl = rng.uniform(0.5, 2.0, NX * NX)
    kt = dict(M=ops.diagonal(interop.from_numpy(dm, "cpu")),
              Ml=lambda v: interop.from_numpy(dl, "cpu") * v)
    kj = dict(M=jops.diagonal(jnp.asarray(dm)),
              Ml=lambda v: jnp.asarray(dl) * v)
    return At, Aj, b, kt, kj


@pytest.mark.parametrize("ortho", ["cgs2", "cgs", "cgs2_pallas", "auto"])
def test_gmres_dual_basis_matches_jax(ortho):
    """``M`` keeps two bases, ``V = M P``: the projections subtract along
    ``P`` (K7 with ``basis=P``), the norms are M-norms; ``return_internal``
    hands out both bases and the small matrices under the reference's
    keys."""
    At, Aj, b, kt, kj = _m_problem()
    kw = dict(tol=1e-10, maxiter=60, ortho=ortho, return_internal=True)
    rj, ij = JF.gmres(Aj, jnp.asarray(b), **kw, **kj)
    rt, it = F.gmres(At, interop.from_numpy(b, "cpu"), **kw, **kt)
    _compare(rj, rt)
    assert list(it) == ["V", "P", "H", "R", "y", "C", "MMlr0_norm",
                        "MMlb_norm"] == list(ij)
    n = int(rt.niter)
    for key in it:
        got, want = interop.to_numpy(it[key]), np.asarray(ij[key])
        assert got.shape == want.shape, key
        if not got.size:
            continue
        sl = np.s_[: n + 1] if key in ("V", "P") else np.s_[...]
        np.testing.assert_allclose(got[sl], want[sl], rtol=0,
                                   atol=1e-9 * max(np.abs(want).max(), 1.0),
                                   err_msg=key)
    # V = M P, row by row
    V, P = it["V"][: n + 1], it["P"][: n + 1]
    MP = torch.stack([kt["M"](p) for p in P])
    assert torch.allclose(V, MP, rtol=1e-12, atol=1e-14)
    assert it["C"].shape == (60, 0)


def test_return_internal_without_M():
    (At, kt), (Aj, kj), b, _ = _problem("padded_Ml")
    kw = dict(tol=1e-10, maxiter=30, return_internal=True)
    rj, ij = JF.gmres(Aj, jnp.asarray(b), **kw, **kj)
    rt, it = F.gmres(At, interop.from_numpy(b, "cpu"), **kw, **kt)
    assert it["P"] is None and ij["P"] is None
    n = int(rt.niter)
    for key in ("H", "R", "y", "MMlr0_norm", "MMlb_norm"):
        np.testing.assert_allclose(interop.to_numpy(it[key]),
                                   np.asarray(ij[key]), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(
                                       ij[key])).max(), err_msg=key)
    # the Arnoldi relation in the raw Hessenberg: Ml A V_n = V_{n+1} H
    V, H = it["V"], it["H"]
    AV = torch.stack([kt["Ml"](At(v)) for v in V[:n]])
    assert torch.allclose(AV, H[: n + 1, :n].T @ V[: n + 1], atol=1e-9)


def test_deflation_hooks_match_jax():
    """``operator_with_capture``/``capture_width`` (the C buffer, row k
    written at iteration k), ``projected_r0`` and ``correct_xk``, with a
    rank-one projection along a fixed direction; hook outputs in float32
    are cast to the float64 system."""
    (At, _), (Aj, _), b, _ = _problem("unpadded")
    u = np.random.default_rng(80).standard_normal(NX * NX)
    u /= np.linalg.norm(u)
    ut, uj = interop.from_numpy(u, "cpu"), jnp.asarray(u)

    hooks_t = dict(
        operator_with_capture=lambda v: (
            At(v) - ut * torch.dot(ut, At(v)),
            torch.stack([torch.dot(ut, At(v)), torch.dot(ut, v)]).float()),
        capture_width=2,
        projected_r0=lambda r: r - ut * torch.dot(ut, r),
        correct_xk=lambda x: x + 0.5 * ut,
    )
    hooks_j = dict(
        operator_with_capture=lambda v: (
            Aj(v) - uj * jnp.dot(uj, Aj(v)),
            jnp.stack([jnp.dot(uj, Aj(v)),
                       jnp.dot(uj, v)]).astype(jnp.float32)),
        capture_width=2,
        projected_r0=lambda r: r - uj * jnp.dot(uj, r),
        correct_xk=lambda x: x + 0.5 * uj,
    )
    kw = dict(tol=1e-12, maxiter=25, return_internal=True)
    rj, ij = JF.gmres(Aj, jnp.asarray(b), **kw, **hooks_j)
    rt, it = F.gmres(At, interop.from_numpy(b, "cpu"), **kw, **hooks_t)
    _compare(rj, rt)
    C = interop.to_numpy(it["C"])
    assert C.shape == (25, 2) and C.dtype == np.float64
    np.testing.assert_allclose(C, np.asarray(ij["C"]), rtol=0,
                               atol=1e-6 * np.abs(C).max())
    assert int(rt.niter) == 25 and np.all(C[:, 0] != 0)
    np.testing.assert_allclose(interop.to_numpy(it["H"]),
                               np.asarray(ij["H"]), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(ij["H"])).max())


def test_kernel_schemes_reject_ip_and_fused_rejects_M():
    A = torch.eye(4, dtype=torch.float64)
    b = torch.ones(4, dtype=torch.float64)
    for ortho in ("cgs_pallas", "cgs2_pallas", "cgs2_fused"):
        with pytest.raises(ValueError, match="Euclidean"):
            F.gmres(A, b, ip=torch.eye(4, dtype=torch.float64), ortho=ortho)
    with pytest.raises(ValueError, match="dual-basis"):
        F.gmres(A, b, M=lambda v: v, ortho="cgs2_fused")
    cuda = torch.device("cuda")
    assert _resolve_ortho("auto", torch.float32, cuda, 26, with_M=True) \
        == "cgs2"
    assert _resolve_ortho("cgs2_pallas", torch.float32, cuda, 7264) \
        == "cgs2_pallas"
    with pytest.raises(ValueError, match="maxiter"):
        _resolve_ortho("cgs_pallas", torch.float32, cuda, 7265)


_UNPORTED = [
    dict(ip=torch.eye(2)), dict(basis_dtype=torch.bfloat16),
    dict(fused_deflation=object()),
] + [dict(ortho=o) for o in ("mgs", "dmgs", "bmgs", "bmgs2", "cgs2_1r")]


@pytest.mark.parametrize("kw", _UNPORTED,
                         ids=[k + ("=" + v if isinstance(v, str) else "")
                              for d in _UNPORTED for k, v in d.items()])
def test_unported_options_raise(kw):
    A = torch.eye(2, dtype=torch.float64)
    b = torch.ones(2, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        F.gmres(A, b, **kw)


def test_unknown_ortho_raises():
    with pytest.raises(ValueError):
        F.gmres(torch.eye(2), torch.ones(2), ortho="householder")
