"""The port's GMRES (krypy_tpu_torch.functional.gmres) against
krypy_tpu.functional.gmres in float64 on the same numpy inputs.

Problems: 2-D convection-diffusion at 31^2, unpadded (no preconditioner),
grid-padded with the padded multigrid V-cycle on the left (the analog of
tests/test_padded.py's padded GMRES solve), and padded with the V-cycle
on the right; each with ``ortho="cgs2"`` and ``"cgs2_fused"`` (the JAX
side runs its Pallas kernels in interpret mode, as it does off the TPU).

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


_UNPORTED = [
    dict(M=lambda v: v), dict(ip=torch.eye(2)),
    dict(basis_dtype=torch.bfloat16),
    dict(operator_with_capture=lambda v: (v, v)), dict(capture_width=1),
    dict(projected_r0=lambda v: v), dict(correct_xk=lambda v: v),
    dict(return_internal=True), dict(fused_deflation=object()),
] + [dict(ortho=o) for o in ("cgs", "mgs", "dmgs", "bmgs", "bmgs2",
                             "cgs_pallas", "cgs2_pallas", "cgs2_1r")]


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
