"""The port's three stencil kernels (krypy_tpu_torch.kernels.stencil)
against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the Pallas kernel in interpret mode on the same numpy inputs.
The buffers carry NOISE in their pad rows and columns: neither the
Pallas kernels nor the port's kernels may read the pads, so the
comparison also checks that the outputs' pads come back as exact zeros.

Tolerances: float32 ``rtol=2e-6, atol=2e-7 * max|want|`` (the JAX
package's own bound for chained stencil kernels, tests/test_padded.py);
float64 ``1e-12 * max|want|``.  The CUDA kernels themselves are held to
these plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu.kernels import stencil as jst
from krypy_tpu_torch import interop, ops
from krypy_tpu_torch.kernels import stencil as tst

torch.set_num_threads(1)

COEFFS = (4.1, -1.0, -0.9, -1.1, -0.8)
DTYPES = {"f32": np.float32, "f64": np.float64}


def _padded_noise(rng, nx, ny, dtype, pad_noise=True):
    """(R, P) buffer: normal values on the (nx, ny) logical region, and
    noise (or zeros) in the pads."""
    R, P = ops.pad_rows_width(nx), ops.pad_cols_width(ny)
    buf = rng.standard_normal((R, P)) * (1.0 if pad_noise else 0.0)
    buf[:nx, :ny] = rng.standard_normal((nx, ny))
    return buf.astype(dtype).reshape(-1), R, P


def _close(got, want, dtype):
    scale = float(np.max(np.abs(want)))
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


def _pads_zero(flat, R, P, nrows, ncols):
    u = flat.reshape(R, P)
    assert np.all(u[nrows:, :] == 0.0) and np.all(u[:, ncols:] == 0.0)


def _affine_use(use):
    """(coeffs, g used?, alpha, beta) of one of K1's four uses."""
    w = 0.2
    return {
        "matvec": (COEFFS, False, 0.0, 0.0),
        "step": (tuple(-w * c for c in COEFFS), True, 1.0, w),
        "residual": (tuple(-c for c in COEFFS), True, 0.0, 1.0),
        "presmooth": (tuple(-w * w * c for c in COEFFS), False, 2.0 * w,
                      0.0),
    }[use]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("use", ["matvec", "step", "residual",
                                 "presmooth"])
@pytest.mark.parametrize("nx,ny", [(9, 120), (17, 100), (16, 100)])
def test_stencil5_affine_matches_pallas(nx, ny, use, dt):
    dtype = DTYPES[dt]
    rng = np.random.default_rng(100 + nx + ny)
    u, R, P = _padded_noise(rng, nx, ny, dtype)
    g, _, _ = _padded_noise(rng, nx, ny, dtype)
    coeffs, has_g, alpha, beta = _affine_use(use)
    kw = dict(nx=R, ny=P, coeffs=coeffs, ncols=ny, nrows=nx, alpha=alpha,
              beta=beta)
    want = np.asarray(jst.stencil5_affine(
        jnp.asarray(u), jnp.asarray(g) if has_g else None, interpret=True,
        **kw,
    ))
    got = interop.to_numpy(tst.stencil5_affine(
        interop.from_numpy(u, "cpu"),
        interop.from_numpy(g, "cpu") if has_g else None, **kw,
    ))
    assert got.dtype == dtype
    _pads_zero(got, R, P, nx, ny)
    _close(got, want, dtype)


def test_stencil5_affine_pad_invariant_repeated():
    """Three chained applications keep the pads exactly zero and track
    the Pallas kernel's chain."""
    nx, ny = 9, 100
    rng = np.random.default_rng(3)
    u, R, P = _padded_noise(rng, nx, ny, np.float32, pad_noise=False)
    kw = dict(nx=R, ny=P, coeffs=(4.0, -1.0, -1.0, -1.0, -1.0), ncols=ny,
              nrows=nx)
    xj, xt = jnp.asarray(u), interop.from_numpy(u, "cpu")
    for _ in range(3):
        xj = jst.stencil5_affine(xj, interpret=True, **kw)
        xt = tst.stencil5_affine(xt, **kw)
    got = interop.to_numpy(xt)
    _pads_zero(got, R, P, nx, ny)
    _close(got, np.asarray(xj), np.float32)


def _poisson255():
    n = 255
    h2 = (1.0 / (n + 1)) ** 2
    lapc = (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)
    return n, lapc, 0.8 / (4.0 / h2)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("s", [1.0, 3.25])
def test_stencil5_jacobi2_matches_pallas(s, dt):
    dtype = DTYPES[dt]
    n, lapc, w = _poisson255()
    rng = np.random.default_rng(31)
    u, R, P = _padded_noise(rng, n, n, dtype)
    g, _, _ = _padded_noise(rng, n, n, dtype)
    kw = dict(nx=R, ny=P, coeffs=lapc, w=w, s=s, ncols=n, nrows=n)
    want = np.asarray(jst.stencil5_jacobi2(
        jnp.asarray(u), jnp.asarray(g), interpret=True, **kw))
    got = interop.to_numpy(tst.stencil5_jacobi2(
        interop.from_numpy(u, "cpu"), interop.from_numpy(g, "cpu"), **kw))
    _pads_zero(got, R, P, n, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_stencil5_resrestrict_rows_matches_pallas(dt):
    dtype = DTYPES[dt]
    n, lapc, _ = _poisson255()
    rc = tuple(-c for c in lapc)
    rng = np.random.default_rng(21)
    u, R, P = _padded_noise(rng, n, n, dtype)
    g, _, _ = _padded_noise(rng, n, n, dtype)
    kw = dict(nx=R, ny=P, coeffs=rc, ncols=n, nrows=n)
    want = np.asarray(jst.stencil5_resrestrict_rows(
        jnp.asarray(u), jnp.asarray(g), interpret=True, **kw))
    got = interop.to_numpy(tst.stencil5_resrestrict_rows(
        interop.from_numpy(u, "cpu"), interop.from_numpy(g, "cpu"), **kw))
    assert got.shape == (R // 2 * P,)
    _pads_zero(got, R // 2, P, (n - 1) // 2, n)
    _close(got, want, dtype)


def test_wrappers_reject_bad_operands():
    u = torch.zeros(16 * 128, dtype=torch.float32)
    kw = dict(nx=16, ny=128, coeffs=COEFFS, ncols=9, nrows=9)
    with pytest.raises(ValueError):
        tst.stencil5_affine(u[:-1], **kw)
    with pytest.raises(ValueError):
        tst.stencil5_affine(u, u.to(torch.float64), **kw)
    with pytest.raises(ValueError):
        tst.stencil5_affine(u.reshape(16, 128).t(), **kw)
    with pytest.raises(ValueError):
        tst.stencil5_affine(u, nx=16, ny=128, coeffs=COEFFS, nrows=17)
    with pytest.raises(ValueError):
        tst.stencil5_resrestrict_rows(
            u[:15 * 128], u[:15 * 128], nx=15, ny=128, coeffs=COEFFS,
            ncols=9, nrows=9,
        )


def test_cpu_path_counts_no_launch():
    """The plain version on a CPU tensor is not a kernel launch."""
    tst.reset_launch_counts()
    u = torch.ones(16 * 128, dtype=torch.float32)
    tst.stencil5_affine(u, nx=16, ny=128, coeffs=COEFFS, ncols=9, nrows=9)
    assert tst.launch_counts() == {k: 0 for k in tst.LAUNCHES}
