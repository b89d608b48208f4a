"""The north-star operator and the unpadded K1 lanes against the JAX
package on the same numpy inputs: ``ops.convection_diffusion_2d`` on
every lane, the unpadded ``ops.poisson_2d(impl="cuda")``, and the two
thin entries over K1 (``stencil5_pipelined``, ``laplacian_2d_pipelined``)
against the JAX functions with their Pallas kernel in interpret mode.

The convection-diffusion stencil is the first with ``cu != cd`` and
``cl != cr`` (upwind terms on the up and left neighbours), so a swapped
neighbour shows here.

Tolerances: float64 ``1e-12`` relative to the largest output entry
(the same formula on both sides, rounded in another order); float32
(the kernels' lanes) ``4 eps32 sum|c_i| max|u|``, four roundings of the
largest term of the stencil.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import ops as jops
from krypy_tpu.kernels import stencil as jst
from krypy_tpu_torch import interop, kernels, ops

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _cd_coeffs(nx, ny, wind=(1.0, 0.5), eps=1.0):
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    wx, wy = wind
    return (eps * (2 / hx ** 2 + 2 / hy ** 2) + wx / hx + wy / hy,
            -eps / hx ** 2 - wx / hx, -eps / hx ** 2,
            -eps / hy ** 2 - wy / hy, -eps / hy ** 2)


def _close(got, want, bound):
    """``bound`` is ``sum|c_i| max|u|``, the largest term's size."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float64:
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * EPS32 * bound)


def _vec(n, dtype, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nx,ny", [(8, 128), (16, 40), (32, 24)])
def test_stencil5_pipelined_matches_jax(nx, ny, dtype):
    co = _cd_coeffs(nx, ny)
    x = _vec(nx * ny, dtype, nx + ny)
    want = jst.stencil5_pipelined(jnp.asarray(x), nx=nx, ny=ny, coeffs=co,
                                  interpret=True)
    got = kernels.stencil5_pipelined(interop.from_numpy(x, "cpu"), nx=nx,
                                     ny=ny, coeffs=co)
    bound = sum(abs(c) for c in co) * float(np.max(np.abs(x)))
    _close(interop.to_numpy(got), want, bound)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nx,ny", [(8, 8), (16, 31), (24, 128)])
def test_laplacian_2d_pipelined_matches_jax(nx, ny, dtype):
    x = _vec(nx * ny, dtype, 3 * nx + ny)
    want = jst.laplacian_2d_pipelined(jnp.asarray(x), nx=nx, ny=ny,
                                      interpret=True)
    got = kernels.laplacian_2d_pipelined(interop.from_numpy(x, "cpu"),
                                         nx=nx, ny=ny)
    hx2, hy2 = (1 / (nx + 1)) ** 2, (1 / (ny + 1)) ** 2
    bound = (4 / hx2 + 4 / hy2) * float(np.max(np.abs(x)))
    _close(interop.to_numpy(got), want, bound)


# (label, port kwargs, JAX kwargs, dtype)
LANES = [
    ("unpadded plain f64", dict(impl="torch"), dict(impl="jnp"), np.float64),
    ("unpadded kernel f32", dict(impl="cuda"), dict(impl="pallas"),
     np.float32),
    ("unpadded kernel f64", dict(impl="cuda"), dict(impl="pallas"),
     np.float64),
    ("padded plain f64", dict(impl="torch", pad_cols=True),
     dict(impl="jnp", pad_cols=True), np.float64),
    ("padded kernel f32", dict(impl="cuda", pad_cols=True),
     dict(impl="pallas", pad_cols=True), np.float32),
]


@pytest.mark.parametrize("nx,ny", [(16, 16), (15, 9)])
@pytest.mark.parametrize("lane", range(len(LANES)))
def test_convection_diffusion_matches_jax(lane, nx, ny):
    _, kw, jkw, dtype = LANES[lane]
    wind, eps = (0.7, 0.25), 0.5
    At = ops.convection_diffusion_2d(nx, ny, wind=wind, eps=eps,
                                     device="cpu", **kw)
    Aj = jops.convection_diffusion_2d(nx, ny, wind=wind, eps=eps, **jkw)
    assert At.shape == Aj.shape
    np.testing.assert_allclose(interop.to_numpy(At.diag), np.asarray(Aj.diag),
                               rtol=1e-15)
    if kw.get("pad_cols"):
        assert At.grid == Aj.grid
        assert (At.nx_pad, At.ny_pad) == (Aj.nx_pad, Aj.ny_pad)
        x = np.asarray(jops.pad_grid_vec(
            jnp.asarray(_vec(nx * ny, dtype, 5)), nx, ny))
    else:
        x = _vec(nx * ny, dtype, 5)
    got = interop.to_numpy(At(interop.from_numpy(x, "cpu")))
    if kw.get("pad_cols"):
        u = got.reshape(At.nx_pad, At.ny_pad)
        assert np.all(u[nx:, :] == 0.0) and np.all(u[:, ny:] == 0.0)
    bound = sum(abs(c) for c in _cd_coeffs(nx, ny, wind, eps)) * \
        float(np.max(np.abs(x)))
    _close(got, np.asarray(Aj(jnp.asarray(x))), bound)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_poisson_unpadded_kernel_lane_matches_jax(dtype):
    """The unpadded ``impl="cuda"`` Poisson lane (K1 through
    laplacian_2d_pipelined on float32, the plain grouped stencil
    otherwise) against JAX's ``impl="pallas"``."""
    nx, ny = 16, 24
    x = _vec(nx * ny, dtype, 9)
    At = ops.poisson_2d(nx, ny, impl="cuda", device="cpu")
    Aj = jops.poisson_2d(nx, ny, impl="pallas")
    assert At.shape == Aj.shape
    got = interop.to_numpy(At(interop.from_numpy(x, "cpu")))
    hx2, hy2 = (1 / (nx + 1)) ** 2, (1 / (ny + 1)) ** 2
    _close(got, np.asarray(Aj(jnp.asarray(x))),
           (4 / hx2 + 4 / hy2) * float(np.max(np.abs(x))))
