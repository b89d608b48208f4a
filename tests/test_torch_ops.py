"""The port's operators (krypy_tpu_torch.ops) against krypy_tpu.ops on
the same numpy inputs: the grid-padded layout helpers, the Poisson
matvecs and the grid-padded multigrid V-cycle.

Tolerances: float64 ``1e-12`` (relative to the largest output entry);
the float32 V-cycle ``atol = 5e-6 * max(1, max|want|)``, the JAX
package's own bound for its Pallas V-cycle against its jnp one
(tests/test_padded.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import ops as jops
from krypy_tpu_torch import interop, ops
from krypy_tpu_torch.functional.common import cast_matvec

torch.set_num_threads(1)


def _grid_vec(rng, nx, ny, dtype=np.float64):
    return rng.standard_normal(nx * ny).astype(dtype)


def _padded(rng, nx, ny, dtype=np.float64):
    x = _grid_vec(rng, nx, ny, dtype)
    return np.asarray(jops.pad_grid_vec(jnp.asarray(x), nx, ny))


def _close64(got, want):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


def test_pad_widths_match_jax():
    for n in (1, 7, 8, 9, 127, 128, 129, 511, 1023, 8191):
        assert ops.pad_rows_width(n) == jops.pad_rows_width(n)
        assert ops.pad_cols_width(n) == jops.pad_cols_width(n)


@pytest.mark.parametrize("nx,ny", [(7, 7), (9, 5), (16, 128), (31, 31)])
def test_pad_unpad_roundtrip(nx, ny):
    rng = np.random.default_rng(nx * ny)
    x = _grid_vec(rng, nx, ny)
    xp = ops.pad_grid_vec(interop.from_numpy(x, "cpu"), nx, ny)
    np.testing.assert_array_equal(
        interop.to_numpy(xp), np.asarray(jops.pad_grid_vec(jnp.asarray(x),
                                                           nx, ny)))
    np.testing.assert_array_equal(
        interop.to_numpy(ops.unpad_grid_vec(xp, nx, ny)), x)


@pytest.mark.parametrize("nx,ny", [(7, 7), (15, 15), (9, 5), (8, 128),
                                   (31, 31)])
def test_padded_poisson_matches_jax(nx, ny):
    rng = np.random.default_rng(1 + nx)
    xp = _padded(rng, nx, ny)
    Aj = jops.poisson_2d(nx, ny, pad_cols=True)
    At = ops.poisson_2d(nx, ny, pad_cols=True, device="cpu")
    assert At.shape == Aj.shape and At.grid == Aj.grid
    assert (At.nx_pad, At.ny_pad) == (Aj.nx_pad, Aj.ny_pad)
    np.testing.assert_array_equal(interop.to_numpy(At.diag),
                                  np.asarray(Aj.diag))
    got = interop.to_numpy(At(interop.from_numpy(xp, "cpu")))
    u = got.reshape(At.nx_pad, At.ny_pad)
    assert np.all(u[nx:, :] == 0.0) and np.all(u[:, ny:] == 0.0)
    _close64(got, np.asarray(Aj(jnp.asarray(xp))))


@pytest.mark.parametrize("nx,ny", [(7, 7), (15, 9), (32, 16)])
def test_poisson_matches_jax(nx, ny):
    rng = np.random.default_rng(2 + nx)
    x = _grid_vec(rng, nx, ny)
    Aj = jops.poisson_2d(nx, ny)
    At = ops.poisson_2d(nx, ny, device="cpu")
    assert At.shape == Aj.shape
    _close64(interop.to_numpy(At(interop.from_numpy(x, "cpu"))),
             np.asarray(Aj(jnp.asarray(x))))


def test_padded_cuda_lane_float64_is_plain():
    """float64 never reaches the K1 kernel: the impl='cuda' operator's
    f64 matvec is the plain stencil, bit for bit."""
    nx = 31
    rng = np.random.default_rng(5)
    x = interop.from_numpy(_padded(rng, nx, nx), "cpu")
    a = ops.poisson_2d(nx, pad_cols=True, impl="cuda", device="cpu")(x)
    b = ops.poisson_2d(nx, pad_cols=True, impl="torch", device="cpu")(x)
    assert a.dtype == torch.float64
    assert torch.equal(a, b)


@pytest.mark.parametrize("nx", [15, 31, 63])
def test_padded_vcycle_float64_matches_jax(nx):
    kw = dict(coarsest=7, coarse_sweeps=12, pad_cols=True)
    Mj = jops.multigrid_poisson_preconditioner(nx, impl="jnp", **kw)
    Mt = ops.multigrid_poisson_preconditioner(nx, impl="torch", device="cpu",
                                              **kw)
    assert Mt.shape == Mj.shape and Mt.grid == Mj.grid
    rng = np.random.default_rng(4 + nx)
    rp = _padded(rng, nx, nx)
    got = interop.to_numpy(Mt(interop.from_numpy(rp, "cpu")))
    u = got.reshape(Mt.nx_pad, Mt.ny_pad)
    assert np.all(u[nx:, :] == 0.0) and np.all(u[:, nx:] == 0.0)
    _close64(got, np.asarray(Mj(jnp.asarray(rp))))


@pytest.mark.parametrize("nu_post", [1, 2, 3])
def test_padded_vcycle_scale_fold_matches_jax(nu_post):
    nx, s = 31, 7.5
    kw = dict(coarsest=7, coarse_sweeps=12, pad_cols=True, scale=s,
              nu_post=nu_post)
    Mj = jops.multigrid_poisson_preconditioner(nx, **kw)
    Mt = ops.multigrid_poisson_preconditioner(nx, device="cpu", **kw)
    rp = _padded(np.random.default_rng(11), nx, nx)
    _close64(interop.to_numpy(Mt(interop.from_numpy(rp, "cpu"))),
             np.asarray(Mj(jnp.asarray(rp))))


@pytest.mark.parametrize("nu_post", [2, 3])
def test_padded_vcycle_cuda_lane_matches_pallas(nu_post):
    """float32, fine level past the n >= 256 cutoff: the port's cuda lane
    (the kernels' plain versions on the CPU) runs the presmooth2,
    resrestrict and step2 legs against the JAX Pallas lane in interpret
    mode.  nu_post=3 adds the odd single step before the pair and the
    scale fold into the pair."""
    nx = 511
    kw = dict(nu_pre=2, nu_post=nu_post, coarsest=255, coarse_sweeps=2,
              pad_cols=True, scale=1.0 if nu_post == 2 else 3.0)
    Mj = jops.multigrid_poisson_preconditioner(nx, impl="pallas", **kw)
    Mt = ops.multigrid_poisson_preconditioner(nx, impl="cuda", device="cpu",
                                              **kw)
    rp = _padded(np.random.default_rng(23), nx, nx, np.float32)
    want = np.asarray(Mj(jnp.asarray(rp)))
    got = interop.to_numpy(Mt(interop.from_numpy(rp, "cpu")))
    assert got.dtype == np.float32
    scale_ref = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, atol=5e-6 * scale_ref)


def test_jacobi_preconditioner_matches_jax():
    nx = 15
    Aj = jops.poisson_2d(nx, pad_cols=True)
    At = ops.poisson_2d(nx, pad_cols=True, device="cpu")
    rp = _padded(np.random.default_rng(6), nx, nx)
    Mt = ops.jacobi_preconditioner(At)
    assert Mt.shape == At.shape
    np.testing.assert_array_equal(
        interop.to_numpy(Mt(interop.from_numpy(rp, "cpu"))),
        np.asarray(jops.jacobi_preconditioner(Aj)(jnp.asarray(rp))))


def test_cast_matvec_keeps_system_dtype():
    """torch promotes a float64 diagonal times a float32 vector to
    float64, as JAX does; cast_matvec pins the result back to float32.
    A 0-dim float64 factor does not promote in torch at all."""
    At = ops.poisson_2d(7, pad_cols=True, device="cpu")
    M = ops.jacobi_preconditioner(At)
    x32 = torch.ones(At.shape[0], dtype=torch.float32)
    assert M(x32).dtype == torch.float64
    assert cast_matvec(M, torch.float32)(x32).dtype == torch.float32
    s64 = torch.tensor(2.0, dtype=torch.float64)
    assert cast_matvec(lambda v: s64 * v, torch.float32)(x32).dtype == \
        torch.float32


def test_multigrid_rejects_unported_and_faulty_options():
    """The options the JAX package refuses, refused alike.  (The unpadded
    lane, the ``rbgs`` smoother and the padded lane's ``nu_pre < 2`` and
    ``coarse_sweeps=0`` run now: tests/test_torch_multigrid.py.)"""
    for kw in (dict(smoother="rbgs"), dict(coarse_solver="dst")):
        with pytest.raises(ValueError, match="jacobi smoother"):
            ops.multigrid_poisson_preconditioner(15, pad_cols=True,
                                                 device="cpu", **kw)
        with pytest.raises(ValueError, match="jacobi smoother"):
            jops.multigrid_poisson_preconditioner(15, pad_cols=True, **kw)
    for pad in (True, False):
        with pytest.raises(ValueError):
            ops.multigrid_poisson_preconditioner(16, pad_cols=pad,
                                                 device="cpu")
    with pytest.raises(ValueError):
        ops.multigrid_poisson_preconditioner(15, smoother="sor",
                                             device="cpu")
    with pytest.raises(ValueError):
        ops.poisson_2d(15, impl="pallas")
    with pytest.raises(ValueError):
        ops.convection_diffusion_2d(15, impl="pallas", device="cpu")


_CONSTRUCTORS = {
    "poisson": lambda **kw: ops.poisson_2d(15, **kw),
    "poisson_padded": lambda **kw: ops.poisson_2d(15, pad_cols=True, **kw),
    "convdiff": lambda **kw: ops.convection_diffusion_2d(15, **kw),
    "convdiff_padded": lambda **kw: ops.convection_diffusion_2d(
        15, pad_cols=True, **kw),
    "multigrid": lambda **kw: ops.multigrid_poisson_preconditioner(
        15, coarsest=7, pad_cols=True, **kw),
    "multigrid_unpadded": lambda **kw: ops.multigrid_poisson_preconditioner(
        15, coarsest=7, smoother="rbgs", **kw),
    "dst": lambda **kw: ops.poisson_dst_solver(15, **kw),
    "ssor": lambda **kw: ops.ssor_poisson_preconditioner(15, **kw),
    "poisson_1d": lambda **kw: ops.poisson_1d(15, **kw),
    "readme_diag": lambda **kw: ops.readme_diag(15, **kw),
}


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_constructors_default_to_cuda(name):
    """An operator is built on the CUDA device unless the caller asks
    for the CPU: where torch sees no CUDA device the default raises
    (it does not quietly build CPU tensors); where it sees one, the
    operator's tensors lie there."""
    make = _CONSTRUCTORS[name]
    assert make(device="cpu").shape[0] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        return
    op = make()
    x = torch.ones(op.shape[0], dtype=torch.float64, device="cuda")
    assert op(x).device.type == "cuda"


@pytest.mark.parametrize("name", ["poisson_2d", "convection_diffusion_2d",
                                  "shifted_laplacian_2d"])
def test_constructors_take_the_jax_positional_order(name):
    """``(nx, ny, [wind, eps | sigma,] impl, mesh, pad_cols)`` as in the
    JAX package, ``device`` keyword-only: a positional ``mesh`` (None
    here) lands in ``mesh``, and the positional call builds the keyword
    call's operator."""
    extra = {"poisson_2d": (), "convection_diffusion_2d": ((1.0, 0.5), 1.0),
             "shifted_laplacian_2d": (5.0,)}[name]
    make = getattr(ops, name)
    jmake = getattr(jops, name)
    x = np.random.default_rng(13).standard_normal(15 * 9)
    keys = ["impl", "mesh", "pad_cols"][:3 if name != "shifted_laplacian_2d"
                                        else 2]
    vals = ["torch", None, False][:len(keys)]
    pos = make(15, 9, *extra, *vals, device="cpu")
    kw = make(15, 9, *extra, device="cpu", **dict(zip(keys, vals)))
    want = np.asarray(jmake(15, 9, *extra, "jnp", None, *vals[2:])(
        jnp.asarray(x)))
    for op in (pos, kw):
        _close64(interop.to_numpy(op(interop.from_numpy(x, "cpu"))), want)
    with pytest.raises(TypeError):
        make(15, 9, *extra, *vals, "cpu")


def test_jacobi_preconditioner_takes_a_diagonal_tensor():
    """From a diagonal tensor (a tensor's own ``.diag`` is a method), as
    the JAX package takes an array."""
    d = np.linspace(1.0, 3.0, 12)
    x = np.random.default_rng(14).standard_normal(12)
    got = ops.jacobi_preconditioner(interop.from_numpy(d, "cpu"))(
        interop.from_numpy(x, "cpu"))
    np.testing.assert_array_equal(
        interop.to_numpy(got),
        np.asarray(jops.jacobi_preconditioner(jnp.asarray(d))(
            jnp.asarray(x))))


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_multigrid_applies_on_its_device_only(device):
    M = ops.multigrid_poisson_preconditioner(15, coarsest=7, pad_cols=True,
                                             device=device)
    x = torch.ones(M.shape[0], dtype=torch.float64)
    assert M(x).device == x.device
    with pytest.raises(ValueError):
        M(x.to("meta"))


def test_config_full_float32_and_thresholds():
    from krypy_tpu import config as jconfig
    from krypy_tpu_torch import config
    from krypy_tpu_torch.functional.common import breakdown_threshold

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert config.default_float() == torch.float64
    for dt, npdt in ((torch.float32, np.float32), (torch.float64,
                                                    np.float64)):
        assert config.invariance_threshold(dt) == \
            jconfig.invariance_threshold(npdt)
        assert breakdown_threshold(dt) == jconfig.invariance_threshold(npdt)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_interop_roundtrip_keeps_dtype(dtype):
    a = np.arange(12, dtype=dtype).reshape(3, 4)[:, ::2]
    t = interop.from_numpy(a, "cpu")
    assert t.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    a[0, 0] = 7  # the tensor owns its memory
    back = interop.to_numpy(t)
    assert back.dtype == dtype and back[0, 0] == 0
    np.testing.assert_array_equal(back[1:], a[1:])
