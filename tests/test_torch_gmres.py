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
deflation hooks; and of the one-reduce slice: every other scheme
(``mgs``, ``dmgs``, ``bmgs``, ``bmgs2``, ``cgs2_1r``), ``ip`` (a matrix
and a scalar callable), ``basis_dtype=torch.bfloat16`` on float32
systems (tests/test_bf16_basis.py's bounds: the true residual of a
kappa = 50 solve below 5e-2, the float32 basis strictly better, and the
JAX package's within a factor 2) and ``restarted_gmres`` with
``cgs2_1r``.

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


ORTHOS = ("cgs2", "cgs2_fused", "cgs", "mgs", "dmgs", "bmgs", "bmgs2",
          "cgs2_1r")


@pytest.mark.parametrize("ortho", ORTHOS)
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


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_fused", "cgs2_1r"])
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


@pytest.mark.parametrize("ortho", ["cgs2", "cgs", "cgs2_pallas", "auto",
                                   "dmgs", "bmgs2", "cgs2_1r"])
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
    from krypy_tpu_torch.kernels import orthogonalize as korth

    cuda = torch.device("cuda")
    assert _resolve_ortho("auto", torch.float32, cuda, 26, with_M=True) \
        == "cgs2"
    top = korth.max_rows(4, "cgs_project")
    assert _resolve_ortho("cgs2_pallas", torch.float32, cuda, top) \
        == "cgs2_pallas"
    with pytest.raises(ValueError, match="maxiter"):
        _resolve_ortho("cgs_pallas", torch.float32, cuda, top + 1)


@pytest.mark.parametrize("ortho", ["cgs2_fused", "auto"])
def test_fused_rule_on_a_mesh(ortho):
    """On a mesh ``cgs2_fused`` runs K9, which takes the ranks' blocks
    whether or not N divides over the mesh (where it does not, the JAX
    package runs its two-pass ``fused_force_jnp``); ``M`` still raises.
    ``auto`` prices K9's saved sweep against its two extra all-reduces
    (``policy.fused_sharded_wins``): ``cgs2_fused`` on a bandwidth-bound
    shard, ``cgs2_1r`` on a latency-bound one, ``cgs2_1r`` with ``M``,
    an ``ip`` matrix or ``basis_dtype`` (the JAX package's rule; the
    choice on real meshes against the JAX package:
    tests/test_torch_parallel.py)."""
    from types import SimpleNamespace

    from krypy_tpu_torch.functional import policy

    mesh, cuda = SimpleNamespace(size=2), torch.device("cuda")
    for n_local in (1_000, 8_388_608):
        want = ("cgs2_fused" if ortho == "cgs2_fused"
                or policy.fused_sharded_wins(26, n_local, 4, 2, cuda)
                else "cgs2_1r")
        assert _resolve_ortho(ortho, torch.float32, cuda, 26, mesh=mesh,
                              n_local=n_local) == want
    if ortho == "auto":
        assert want == "cgs2_fused"  # the large shard
        for kw in (dict(with_M=True), dict(ip=torch.eye(2)),
                   dict(mixed=True)):
            assert _resolve_ortho("auto", torch.float32, cuda, 26,
                                  mesh=mesh, n_local=8_388_608,
                                  **kw) == "cgs2_1r"
        # a scalar ip takes the one-device rule, which it sends to cgs2
        assert _resolve_ortho("auto", torch.float32, cuda, 26, mesh=mesh,
                              ip=lambda x, y: x @ y) == "cgs2"
    with pytest.raises(ValueError, match="dual-basis"):
        _resolve_ortho("cgs2_fused", torch.float32, cuda, 26, with_M=True,
                       mesh=mesh)


_UNPORTED = [
    dict(ip=torch.eye(2)), dict(basis_dtype=torch.bfloat16),
    dict(fused_deflation=object()),
] + [dict(ortho=o) for o in ("mgs", "dmgs", "bmgs", "bmgs2", "cgs2_1r")]


@pytest.mark.parametrize("kw", _UNPORTED,
                         ids=[k + ("=" + v if isinstance(v, str) else "")
                              for d in _UNPORTED for k, v in d.items()])
def test_unported_options_raise(kw):
    """The options that raised before the one-reduce lane was ported:
    each runs now and matches the JAX package's solve, or raises the JAX
    package's error (``fused_deflation`` with ``ortho="cgs2"``)."""
    A = np.diag([1.0, 3.0])
    b = np.ones(2)
    kj = {k: (jnp.eye(2) if k == "ip" else jnp.bfloat16
              if k == "basis_dtype" else v) for k, v in kw.items()}
    try:
        rj = JF.gmres(jnp.asarray(A), jnp.asarray(b), tol=1e-10, **kj)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            F.gmres(torch.tensor(A), torch.tensor(b), tol=1e-10, **kw)
        assert "fused_deflation" in kw
        return
    rt = F.gmres(torch.tensor(A), torch.tensor(b), tol=1e-10, **kw)
    assert int(rt.niter) == int(rj.niter) == 2
    # the bfloat16 basis breaks down at its floor, 1e-3, in both packages
    assert int(rt.status) == int(rj.status) == (
        F.BREAKDOWN if "basis_dtype" in kw else F.CONVERGED)
    np.testing.assert_allclose(interop.to_numpy(rt.x), np.asarray(rj.x),
                               rtol=1e-2 if "basis_dtype" in kw else 1e-12)


@pytest.mark.parametrize("ip", ["matrix", "callable"])
@pytest.mark.parametrize("ortho", ["cgs", "cgs2", "mgs", "dmgs", "bmgs",
                                   "bmgs2"])
def test_gmres_inner_product_matches_jax(ortho, ip):
    """``ip`` with the plain schemes: a diagonal weight as a matrix and
    as a scalar callable ``<x, B y>``, on the unpadded problem; the
    matrix with ``cgs2_1r`` too (the one-reduce product applies ``B``);
    a scalar callable there raises the JAX package's ``ValueError``."""
    (At, _), (Aj, _), b, _ = _problem("unpadded")
    d = np.random.default_rng(3).uniform(0.5, 2.0, NX * NX)
    dj, dt = jnp.asarray(d), interop.from_numpy(d, "cpu")
    if ip == "matrix":
        ipj, ipt = jnp.diag(dj), torch.diag(dt)
    else:
        def ipj(x, y):
            return jnp.vdot(x, dj * y)

        def ipt(x, y):
            return torch.vdot(x, dt * y)
    kw = dict(tol=1e-10, maxiter=30 if ip == "callable" else 60)
    for o in (ortho, "cgs2_1r") if ortho == "cgs2" else (ortho,):
        if o == "cgs2_1r" and ip == "callable":
            for fn, A_, bb, p in ((JF.gmres, Aj, jnp.asarray(b), ipj),
                                  (F.gmres, At, interop.from_numpy(b, "cpu"),
                                   ipt)):
                with pytest.raises(ValueError, match="scalar callable"):
                    fn(A_, bb, ip=p, ortho=o, **kw)
            continue
        rj = JF.gmres(Aj, jnp.asarray(b), ip=ipj, ortho=o, **kw)
        rt = F.gmres(At, interop.from_numpy(b, "cpu"), ip=ipt, ortho=o, **kw)
        _compare(rj, rt)


def _bf16_system():
    """tests/test_bf16_basis.py's system: diag(linspace(1, 50, 512)) with
    a float32 random rhs."""
    d = np.linspace(1.0, 50.0, 512)
    b = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    return d, b


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_1r", "bmgs2"])
def test_bf16_basis_matches_jax(ortho):
    """A bfloat16 basis on a float32 system, 40 iterations at tol 0: the
    true float64 residual below tests/test_bf16_basis.py's 5e-2 floor
    bound, the float32 basis strictly better, the JAX package's residual
    within a factor of 2 (the bfloat16 rounding of two products summed in
    another order moves it), the basis stored narrow and every iteration
    run."""
    d, b = _bf16_system()
    Dj, Dt = jnp.asarray(d, jnp.float32), torch.tensor(d, dtype=torch.float32)

    def true_rel(x):
        x = np.asarray(x, np.float64)
        return np.linalg.norm(b - d * x) / np.linalg.norm(b)

    kw = dict(tol=0.0, maxiter=40, ortho=ortho)
    rj = JF.gmres(lambda v: Dj * v, jnp.asarray(b),
                  basis_dtype=jnp.bfloat16, **kw)
    rt, it = F.gmres(lambda v: Dt * v, torch.tensor(b),
                     basis_dtype=torch.bfloat16, return_internal=True, **kw)
    r32 = F.gmres(lambda v: Dt * v, torch.tensor(b), **kw)
    assert it["V"].dtype == torch.bfloat16 and rt.x.dtype == torch.float32
    assert int(rt.niter) == int(rj.niter) == 40
    rel, rel_j = true_rel(interop.to_numpy(rt.x)), true_rel(rj.x)
    assert rel < 5e-2 and true_rel(interop.to_numpy(r32.x)) < rel
    assert 0.5 < rel / rel_j < 2.0


def test_bf16_basis_errors_match_jax():
    """tests/test_bf16_basis.py's guards, and the one-reduce scheme's
    with ``M``: the same ``ValueError`` in both packages."""
    d, b = _bf16_system()
    cases = [dict(ip="eye"), dict(ortho="mgs"), dict(ortho="cgs2_pallas"),
             dict(ortho="cgs2_1r", M=True), dict(complex=True)]
    for case in cases:
        msgs = []
        for lib, t, bf in ((JF, jnp.asarray, jnp.bfloat16),
                           (F, torch.tensor, torch.bfloat16)):
            kw = dict(maxiter=4, basis_dtype=bf,
                      ortho=case.get("ortho", "cgs2"))
            bb = t(b.astype(np.complex64) if case.get("complex") else b)
            if case.get("ip"):
                kw["ip"] = t(np.eye(512, dtype=np.float32))
            if case.get("M"):
                kw["M"] = lambda v: v
            with pytest.raises(ValueError) as err:
                lib.gmres(lambda v: v, bb, **kw)
            msgs.append(str(err.value)[:25])
        assert msgs[0] == msgs[1], case


def test_unknown_ortho_raises():
    with pytest.raises(ValueError):
        F.gmres(torch.eye(2), torch.ones(2), ortho="householder")
