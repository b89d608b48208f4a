"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the multigrid-CG solve through the kernels.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The module imports neither jax nor the JAX package, so on a machine
that has no jax it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: float32 ``rtol=2e-6`` and ``atol`` the larger of ``2e-7 *
max|want|`` and four times the plain version's own float32 rounding
error (its distance from the float64 plain version).  The kernels and
their plain versions share constants and add order, but nvcc contracts
multiply-adds to FMA, which moves a few ulps of the stencil's
intermediate terms; where the terms cancel, that exceeds a few ulps of
the output.
"""

import numpy as np
import pytest
import torch

from krypy_tpu_torch import functional as F, interop, kernels, ops
from krypy_tpu_torch.kernels import stencil as kst

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


def _cases():
    cases = []
    for nx, ny in ((1023, 1023), (511, 511), (255, 255), (9, 120)):
        h2 = (1.0 / (nx + 1)) ** 2
        lapc = (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)
        w = 0.8 / (4.0 / h2)
        for co, has_g, al, be in (
            (lapc, False, 0.0, 0.0),
            (tuple(-w * c for c in lapc), True, 1.0, w),
            (tuple(-c for c in lapc), True, 0.0, 1.0),
            (tuple(-w * w * c for c in lapc), False, 2.0 * w, 0.0),
        ):
            cases.append(("stencil5_affine", nx, ny, (co, has_g, al, be)))
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
    own = float((want.double() - want64).abs().max())
    got, want = interop.to_numpy(got), interop.to_numpy(want.reshape(-1))
    atol = max(2e-7 * float(np.max(np.abs(want))), 4.0 * own)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


def test_wrappers_raise_on_float64(cuda_device):
    u = torch.zeros(16 * 128, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        kst.stencil5_affine(u, nx=16, ny=128, coeffs=(4.0,) + (-1.0,) * 4,
                            ncols=9, nrows=9)


def test_readme_example_on_bare_cuda_device(cuda_device):
    """README.md's example as written: operators built with
    ``torch.device("cuda")``, which has no index, applied to vectors on
    the current device."""
    nx, dev = 1023, torch.device("cuda")
    lap = ops.poisson_2d(nx, device=dev)
    lap32 = ops.poisson_2d(nx, pad_cols=True, impl="cuda", device=dev)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        device=dev)

    def inner(r32):
        res = F.cg(lap32, ops.pad_grid_vec(r32, nx, nx), M=M, tol=1e-4,
                   maxiter=12, stagnation_window=4)
        return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

    b = torch.ones(nx * nx, dtype=torch.float64, device=dev)
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
    assert all(c > 0 for c in out["cuda_launches"].values())
    assert all(c == 0 for c in out["torch_launches"].values())
    (rc, ic), (rt, it) = out["cuda"], out["torch"]
    assert ic["cycles"] == it["cycles"] == 3
    assert abs(ic["inner_iters"] - it["inner_iters"]) <= 2
    assert float(rc.resnorms.min()) <= 1e-8
    dx = torch.linalg.vector_norm(rc.x - rt.x) / torch.linalg.vector_norm(
        rt.x)
    assert float(dx) <= 1e-6
