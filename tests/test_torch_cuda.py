"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the multigrid-CG and north-star solves through the
kernels.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The module imports neither jax nor the JAX package, so on a machine
that has no jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance of the stencil kernels: float32 ``rtol=2e-6`` and ``atol``
of :func:`krypy_tpu_torch.kernels.parity.fma_atol`, the larger of
``2e-7 * max|want|`` and four times the plain version's own float32
rounding error (its distance from the float64 plain version).  The
kernels and their plain versions share constants and add order, but nvcc
contracts multiply-adds to FMA, which moves a few ulps of the stencil's
intermediate terms; where the terms cancel, that exceeds a few ulps of
the output.

The prefix-sweep kernels K4-K6 sum in another order than their plain
versions (cuBLAS): each output is held to its float64 value by
:class:`krypy_tpu_torch.kernels.parity.PrefixCheck` (its docstring
derives the tolerances), and each test also plants faults (a zeroed or
dropped coefficient or update, a float32 sum of float64 inputs) that the
check must reject.
"""

import numpy as np
import pytest
import torch

from krypy_tpu_torch import functional as F, interop, kernels, ops
from krypy_tpu_torch.kernels import orthogonalize as korth
from krypy_tpu_torch.kernels import stencil as kst
from krypy_tpu_torch.kernels.parity import PrefixCheck, fma_atol
from krypy_tpu_torch.northstar import cd_coeffs, make_northstar

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _padded_noise(rng, nx, ny, device):
    R, P = ops.pad_rows_width(nx), ops.pad_cols_width(ny)
    buf = rng.standard_normal((R, P))
    buf[:nx, :ny] = rng.standard_normal((nx, ny))
    return interop.from_numpy(buf.astype(np.float32).reshape(-1),
                              device), R, P


def _affine_uses(A, w):
    """K1's four uses for the operator coefficients A: matvec, damped
    Jacobi step, residual, collapsed presmooth."""
    return (
        (A, False, 0.0, 0.0),
        (tuple(-w * c for c in A), True, 1.0, w),
        (tuple(-c for c in A), True, 0.0, 1.0),
        (tuple(-w * w * c for c in A), False, 2.0 * w, 0.0),
    )


def _cases():
    cases = []
    # the north star's nonsymmetric stencil, at its own buffer and at an
    # edge shape: a swapped neighbour shows only here
    for nx, ny in ((4095, 4095), (9, 120)):
        cd = cd_coeffs(nx)
        for params in _affine_uses(cd, 0.8 / cd[0]):
            cases.append(("stencil5_affine", nx, ny, params))
    for nx, ny in ((1023, 1023), (511, 511), (255, 255), (9, 120)):
        h2 = (1.0 / (nx + 1)) ** 2
        lapc = (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)
        w = 0.8 / (4.0 / h2)
        for params in _affine_uses(lapc, w):
            cases.append(("stencil5_affine", nx, ny, params))
        for s in (1.0, 3.25):
            cases.append(("stencil5_jacobi2", nx, ny, (lapc, w, s)))
        cases.append(("stencil5_resrestrict_rows", nx, ny,
                      tuple(-c for c in lapc)))
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(cuda_device, case):
    name, nx, ny, params = CASES[case]
    rng = np.random.default_rng(7 + case)
    u, R, P = _padded_noise(rng, nx, ny, cuda_device)
    g, _, _ = _padded_noise(rng, nx, ny, cuda_device)
    kw = dict(nx=R, ny=P, ncols=ny, nrows=nx)

    def plain(u, g):
        u2, g2 = u.view(R, P), g.view(R, P)
        if name == "stencil5_affine":
            co, has_g, al, be = params
            return kst.stencil5_affine_torch(u2, g2 if has_g else None, co,
                                             nx, ny, al, be)
        if name == "stencil5_jacobi2":
            return kst.stencil5_jacobi2_torch(u2, g2, *params, nx, ny)
        return kst.stencil5_resrestrict_rows_torch(u2, g2, params, nx, ny)

    before = kst.launch_counts()[name]
    if name == "stencil5_affine":
        co, has_g, al, be = params
        got = kst.stencil5_affine(u, g if has_g else None, coeffs=co,
                                  alpha=al, beta=be, **kw)
    elif name == "stencil5_jacobi2":
        lapc, w, s = params
        got = kst.stencil5_jacobi2(u, g, coeffs=lapc, w=w, s=s, **kw)
    else:
        got = kst.stencil5_resrestrict_rows(u, g, coeffs=params, **kw)
    torch.cuda.synchronize()
    assert kst.launch_counts()[name] == before + 1
    want, want64 = plain(u, g), plain(u.double(), g.double())
    atol = fma_atol(want, want64)
    got, want = interop.to_numpy(got), interop.to_numpy(want.reshape(-1))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


# (m, N, rows, k): small, ragged, a grid-stride loop past the 1024-block
# cap, and a prefix too tall for K5's full-width tile (fewer threads, over
# 48 KB of shared memory)
ORTHO_SHAPES = [(9, 256, 8, 5), (5, 1000, 5, 2), (26, 4097, 13, 10),
                (8, 600001, 8, 6), (120, 5000, 120, 100)]


def _prefix_sweeps(V, w, c, mask, rows):
    """K4-K6's outputs and their plain versions', as PrefixCheck takes
    them."""
    got = {"project_prefix": (korth.project_prefix(V, w, mask, rows=rows),),
           "apply_project": korth.apply_project(V, w, c, mask, rows=rows),
           "update_prefix": (korth.update_prefix(V, w, c, rows=rows),)}
    plain = {"project_prefix": (korth.project_prefix_torch(V, w, mask,
                                                           rows),),
             "apply_project": korth.apply_project_torch(V, w, c, mask, rows),
             "update_prefix": (korth.update_prefix_torch(V, w, c, rows),)}
    return got, plain


def _random_prefix_inputs(m, N, k, dtype, device, seed):
    rng = np.random.default_rng(seed)
    V = torch.tensor(rng.standard_normal((m, N)), dtype=dtype, device=device)
    w = torch.tensor(rng.standard_normal(N), dtype=dtype, device=device)
    c = torch.tensor(rng.standard_normal(m), dtype=dtype, device=device)
    mask = (torch.arange(m, device=device) <= k).to(dtype)
    return V, w, c, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", ORTHO_SHAPES)
def test_prefix_kernels_match_plain(cuda_device, shape, dtype):
    m, N, rows, k = shape
    V, w, c, mask = _random_prefix_inputs(m, N, k, dtype, cuda_device,
                                          m + N + rows)
    before = kernels.launch_counts()
    got, plain = _prefix_sweeps(V, w, c, mask, rows)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("project_prefix", "apply_project", "update_prefix"):
        assert after[name] == before[name] + 1
    check = PrefixCheck(V, w, c, mask, rows, plain)
    assert check.failures(got) == []
    assert torch.all(got["project_prefix"][0][mask == 0] == 0)
    # the check rejects each planted fault (6, and 2 more in float64)
    assert check.assert_faults_caught(got) == (
        8 if dtype == torch.float64 else 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prefix_kernels_at_the_row_limit(cuda_device, dtype):
    """At ``max_rows`` (1709 float32, 854 float64 rows) K4 asks for more
    than the default 48 KB of shared memory and K5 runs one warp per
    block: both opt in and launch; one row more raises before launch."""
    top = korth.max_rows(torch.empty(0, dtype=dtype).element_size())
    N = 3001
    V, w, c, mask = _random_prefix_inputs(top + 1, N, top - 3, dtype,
                                          cuda_device, top)
    got, plain = _prefix_sweeps(V, w, c, mask, top)
    check = PrefixCheck(V, w, c, mask, top, plain)
    assert check.failures(got) == []
    # K4's own limit is higher; K5 is the one that binds
    korth.project_prefix(V, w, mask, rows=top + 1)
    with pytest.raises(ValueError, match="shared memory"):
        korth.apply_project(V, w, c, mask, rows=top + 1)


def test_prefix_kernels_are_deterministic(cuda_device):
    """No float atomics: the same call gives the same bits."""
    rng = np.random.default_rng(3)
    V = torch.tensor(rng.standard_normal((26, 1 << 20)), dtype=torch.float32,
                     device=cuda_device)
    w = torch.tensor(rng.standard_normal(1 << 20), dtype=torch.float32,
                     device=cuda_device)
    mask = torch.ones(26, device=cuda_device)
    a = korth.cgs2_fused(V, w, mask, rows=13)
    b = korth.cgs2_fused(V, w, mask, rows=13)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_prefix_kernels_raise_on_other_dtypes(cuda_device):
    for dtype in (torch.complex64, torch.float16):
        V = torch.zeros(4, 64, dtype=dtype, device=cuda_device)
        w = torch.zeros(64, dtype=dtype, device=cuda_device)
        with pytest.raises(TypeError):
            korth.project_prefix(V, w, torch.ones(4), rows=2)
        with pytest.raises(TypeError):
            korth.update_prefix(V, w, torch.zeros(4, dtype=dtype,
                                                  device=cuda_device))


def test_northstar_through_kernels_matches_plain_lane(cuda_device):
    """nx=511, the smallest grid whose V-cycle reaches K2 and K3: the
    north-star pipeline on the kernel lane launches all six kernels and
    agrees with the plain lane (cgs2) on the card."""
    nx = 511
    b = torch.ones(nx * nx, dtype=torch.float64, device=cuda_device)
    out = {}
    for impl, ortho in (("cuda", "cgs2_fused"), ("torch", "cgs2")):
        solve, cd64 = make_northstar(nx, impl, ortho, cuda_device)
        kernels.reset_launch_counts()
        out[impl] = solve(b)
        out[impl + "_launches"] = kernels.launch_counts()
    assert all(c > 0 for c in out["cuda_launches"].values())
    assert all(c == 0 for c in out["torch_launches"].values())
    (rc, ic), (rt, it) = out["cuda"], out["torch"]
    assert ic["cycles"] == it["cycles"]
    assert abs(ic["matvecs"] - it["matvecs"]) <= 3
    for r in (rc, rt):
        rel = torch.linalg.vector_norm(b - cd64(r.x)) / \
            torch.linalg.vector_norm(b)
        assert float(rel) <= 1e-8


def test_wrappers_raise_on_float64(cuda_device):
    u = torch.zeros(16 * 128, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        kst.stencil5_affine(u, nx=16, ny=128, coeffs=(4.0,) + (-1.0,) * 4,
                            ncols=9, nrows=9)


def test_readme_example_on_bare_cuda_device(cuda_device):
    """README.md's example as written: operators built on their default
    device, ``"cuda"`` with no index, applied to vectors on the current
    device."""
    nx = 1023
    lap = ops.poisson_2d(nx)
    lap32 = ops.poisson_2d(nx, pad_cols=True, impl="cuda")
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda")

    def inner(r32):
        res = F.cg(lap32, ops.pad_grid_vec(r32, nx, nx), M=M, tol=1e-4,
                   maxiter=12, stagnation_window=4)
        return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

    b = torch.ones(nx * nx, dtype=torch.float64, device="cuda")
    result, info = F.refine_to(lap, b, inner, tol=1e-8, compiled=True)
    rel = torch.linalg.vector_norm(b - lap(result.x)) / \
        torch.linalg.vector_norm(b)
    assert float(rel) <= 1e-8
    assert info["cycles"] == 3 and 17 <= info["inner_iters"] <= 21


def test_solve_through_kernels_matches_torch_lane(cuda_device):
    """nx=511: bench.py's padded solve on the cuda lane launches all
    three kernels and agrees with the plain torch lane on the card."""
    nx = 511
    b = torch.ones(nx * nx, dtype=torch.float64, device=cuda_device)
    lap = ops.poisson_2d(nx, device=cuda_device)
    out = {}
    for impl in ("cuda", "torch"):
        lap32 = ops.poisson_2d(nx, pad_cols=True, impl=impl,
                               device=cuda_device)
        M = ops.multigrid_poisson_preconditioner(
            nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
            device=cuda_device)

        def inner(r32, lap32=lap32, M=M):
            res = F.cg(lap32, ops.pad_grid_vec(r32, nx, nx), M=M, tol=1e-4,
                       maxiter=12, stagnation_window=4)
            return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

        kernels.reset_launch_counts()
        out[impl] = F.refine_to(lap, b, inner, tol=1e-8, compiled=True)
        out[impl + "_launches"] = kernels.launch_counts()
    stencil = ("stencil5_affine", "stencil5_jacobi2",
               "stencil5_resrestrict_rows")
    assert all(out["cuda_launches"][k] > 0 for k in stencil)
    assert all(c == 0 for c in out["torch_launches"].values())
    (rc, ic), (rt, it) = out["cuda"], out["torch"]
    assert ic["cycles"] == it["cycles"] == 3
    assert abs(ic["inner_iters"] - it["inner_iters"]) <= 2
    assert float(rc.resnorms.min()) <= 1e-8
    dx = torch.linalg.vector_norm(rc.x - rt.x) / torch.linalg.vector_norm(
        rt.x)
    assert float(dx) <= 1e-6
