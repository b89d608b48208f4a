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


@pytest.mark.parametrize("nrows,ncols,nx,ny", [
    (9, 120, 16, 128), (8, 128, 8, 128), (7, 127, 8, 128),
    (63, 255, 64, 256), (65, 129, 72, 256), (9, 121, 9, 122),
    (511, 511, 512, 512), (1023, 1023, 1024, 1024), (2047, 2047, 2048, 2048),
    (4095, 4095, 4096, 4096), (1, 1, 1, 1), (3000, 5, 3000, 5),
    (4095, 4095, 4095, 4095), (2047, 2047, 2047, 2047), (511, 511, 511, 511),
    (1021, 1000, 1021, 1000), (31, 31, 31, 31), (7, 7, 7, 7), (3, 3, 3, 3)])
def test_jacobi2_grid_covers_every_output_once(nrows, ncols, nx, ny):
    """K1's and K2's grid (``jacobi2_grid``, a function of the buffer's
    shape alone; K1 also on the unpadded odd widths) tiles the ``(nx,
    ny)`` buffer: each block's strip of columns
    and run of rows, clipped to the buffer, as the kernel computes them,
    cover every output exactly once and no block is empty; runs are whole
    steps, shortened only while the grid is below its block target."""
    strips, runs, steps = tst.jacobi2_grid(nx, ny)
    assert tst.jacobi2_grid(nx, ny) == (strips, runs, steps)
    assert 1 <= steps <= tst.JACOBI2_MAX_STEPS
    h, wd = steps * tst.JACOBI2_STEP_ROWS, tst.JACOBI2_STRIP
    count = np.zeros((nx, ny), dtype=np.int64)
    for by in range(runs):
        for bx in range(strips):
            i0, j0 = by * h, bx * wd
            assert i0 < nx and j0 < ny
            count[i0:min(nx, i0 + h), j0:min(ny, j0 + wd)] += 1
    assert (count == 1).all()
    if steps < tst.JACOBI2_MAX_STEPS:
        longer = -(-nx // (2 * h))
        assert strips * longer < tst.JACOBI2_MIN_BLOCKS


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


def test_coarse_form_size_limit(monkeypatch):
    """The coarse form's dispatch by size: ``coarse_fits`` takes every
    region whose two bordered planes of ``u`` and ``r`` fit one block's
    shared memory (the largest square 137^2 in, 138^2 out; of the
    V-cycle's levels 127^2 in, 255^2 out), and the ``impl="cuda"``
    V-cycle calls the coarse form at a coarsest level that fits and the
    per-sweep stencil at one that does not."""
    assert tst.coarse_smem(137, 137) <= tst.COARSE_MAX_SMEM \
        < tst.coarse_smem(138, 138)
    assert tst.coarse_fits(137, 137) and not tst.coarse_fits(138, 138)
    assert tst.coarse_fits(127, 127) and not tst.coarse_fits(255, 255)
    assert tst.coarse_fits(31, 31) and tst.coarse_fits(1, 1)
    calls = []
    real = tst.stencil5_coarse
    monkeypatch.setattr(ops.kernels, "stencil5_coarse",
                        lambda *a, **k: calls.append(k["nx"]) or real(*a, **k))
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        255 * 255).astype(np.float32))
    for coarsest, want in ((127, [127]), (255, [])):
        calls.clear()
        for impl in ("cuda", "torch"):
            ops.multigrid_poisson_preconditioner(
                255, coarsest=coarsest, coarse_sweeps=3, impl=impl,
                device="cpu")(r)
        assert calls == want
    calls.clear()
    ops.multigrid_poisson_preconditioner(
        255, coarsest=127, coarse_sweeps=3, impl="cuda", pad_cols=True,
        device="cpu")(ops.pad_grid_vec(r, 255, 255))
    assert calls == [ops.pad_rows_width(127)]


@pytest.mark.parametrize("sweeps", [0, 1, 5])
def test_coarse_form_wrapper_on_the_cpu(sweeps):
    """On a CPU tensor the coarse form runs its plain version, reading only
    the logical region (noise in the pads of ``r``) and writing exact
    zeros elsewhere, counts no launch, and equals ``sweeps`` chained K1
    steps from zero."""
    nx, ny, R, P = 9, 20, 16, 24
    rng = np.random.default_rng(sweeps)
    r = torch.from_numpy(rng.standard_normal(R * P))
    w = 0.2
    tst.reset_launch_counts()
    got = tst.stencil5_coarse(r, nx=R, ny=P, coeffs=COEFFS, w=w,
                              sweeps=sweeps, ncols=ny, nrows=nx)
    assert tst.launch_counts() == {k: 0 for k in tst.LAUNCHES}
    out = got.reshape(R, P)
    assert torch.all(out[nx:] == 0) and torch.all(out[:, ny:] == 0)
    rz = torch.zeros(R, P, dtype=r.dtype)
    rz[:nx, :ny] = r.reshape(R, P)[:nx, :ny]
    u = torch.zeros(R * P, dtype=r.dtype)
    step = tuple(-w * c for c in COEFFS)
    for _ in range(sweeps):
        u = tst.stencil5_affine(u, rz.reshape(-1), nx=R, ny=P, coeffs=step,
                                ncols=ny, nrows=nx, alpha=1.0, beta=w)
    np.testing.assert_allclose(got.numpy(), u.numpy(), rtol=1e-13,
                               atol=1e-13 * max(1.0, float(u.abs().max())))


@pytest.mark.parametrize("nx,ny", [(4095, 4095), (4096, 4096), (2047, 2047),
                                   (1021, 1000), (7, 7), (1, 1), (13, 130),
                                   (300, 257)])
def test_affine_grid_covers_every_output_once(nx, ny):
    """K1's grid (``affine_grid``) in each row's aligned frame, as
    ``csrc/stencil5.cu`` walks it: strip x computes the row's columns
    ``[128 x - o, 128 x - o + 128)`` (o the output row's distance from a
    16-byte boundary, ``i ny mod 4`` for the wrapper's aligned output),
    lane l the four at ``128 x - o + 4 l``; clipped to the buffer every
    column of a row is computed exactly once, a lane's whole group is
    stored as one aligned 16-byte store wherever it lies inside the row,
    and the runs cover every row once."""
    aligned = ny % 4 == 0
    strips, runs, steps = tst.affine_grid(nx, ny, aligned)
    assert (runs, steps) == tst.jacobi2_grid(nx, ny)[1:]
    h = steps * tst.JACOBI2_STEP_ROWS
    assert (runs - 1) * h < nx <= runs * h
    lanes = np.arange(32)
    # a row's frame depends on i ny mod 4 alone: the first rows of each
    # residue and the last ones
    for i in sorted(set(range(min(nx, 8))) | set(range(max(0, nx - 4), nx))):
        o = (i * ny) % 4
        cover = np.zeros(ny, dtype=np.int64)
        for x in range(strips):
            j = x * tst.JACOBI2_STRIP - o + 4 * lanes
            whole = (j >= 0) & (j + 3 < ny)
            assert np.all((i * ny + j[whole]) % 4 == 0)
            for q in range(4):
                col = j + q
                inside = (col >= 0) & (col < ny)
                cover[col[inside]] += 1
        assert np.all(cover == 1)


#: K8's kernel on one row block: (rows, width) and which halo rows exist
HALO_SHAPES = [(8, 16), (5, 13), (1, 7), (32, 130)]
HALOS = {"both": (True, True), "top": (True, False),
         "bottom": (False, True)}


@pytest.mark.parametrize("halos", sorted(HALOS))
@pytest.mark.parametrize("nx,ny", HALO_SHAPES)
def test_halo_form_matches_jax_composition(nx, ny, halos):
    """K8's kernel (its plain version, :func:`stencil5_halo_torch`) on one
    row block with seeded random halo rows, against the JAX package's K8
    composition on that block: ``stencil5_pipelined`` interpreted, then
    ``cu * top`` added to the first row and ``cd * bot`` to the last
    (krypy_tpu/kernels/stencil.py:597-604); float64 to 1e-11.  A missing
    halo row is the Dirichlet zero (None here, no addition there)."""
    rng = np.random.default_rng(nx * ny + len(halos))
    u = rng.standard_normal((nx, ny))
    top, bot = (rng.standard_normal(ny) if has else None
                for has in HALOS[halos])
    _, cu, cd, _, _ = COEFFS
    want = jst.stencil5_pipelined(jnp.asarray(u.reshape(-1)), nx=nx, ny=ny,
                                  coeffs=COEFFS, interpret=True
                                  ).reshape(nx, ny)
    if top is not None:
        want = want.at[0].add(cu * jnp.asarray(top))
    if bot is not None:
        want = want.at[-1].add(cd * jnp.asarray(bot))
    rows = [None if t is None else torch.from_numpy(t) for t in (top, bot)]
    got = tst.stencil5_halo_torch(torch.from_numpy(u), *rows, COEFFS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11,
                               atol=1e-11)
    # the wrapper on a CPU tensor is the plain version, no launch counted
    tst.reset_launch_counts()
    flat = tst.stencil5_halo(torch.from_numpy(u.reshape(-1)), *rows, nx=nx,
                             ny=ny, coeffs=COEFFS)
    assert torch.equal(flat, got.reshape(-1))
    assert tst.launch_counts() == {k: 0 for k in tst.LAUNCHES}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nx,ny", HALO_SHAPES)
def test_halo_form_without_halos_is_k1(nx, ny, dt):
    """With both halo rows None, K8's kernel is K1's matvec of the block:
    its plain version gives the bits of K1's plain version; and K8's
    halo rows enter exactly as a block's own rows do: the rows ``[a, b)``
    of a grid with rows ``a - 1`` and ``b`` as halos give the grid's
    stencil on those rows, bit for bit."""
    rng = np.random.default_rng(7 * nx + ny)
    grid = torch.from_numpy(rng.standard_normal((nx + 2, ny)).astype(
        DTYPES[dt]))
    u = grid[1:-1]
    want = tst.stencil5_affine_torch(u, None, COEFFS, nx, ny)
    assert torch.equal(tst.stencil5_halo_torch(u, None, None, COEFFS), want)
    whole = tst.stencil5_affine_torch(grid, None, COEFFS, nx + 2, ny)
    for a, b in ((1, nx + 1), (2, nx), (1, 2)):
        if a < b:
            got = tst.stencil5_halo_torch(grid[a:b], grid[a - 1], grid[b],
                                          COEFFS)
            assert torch.equal(got, whole[a:b])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("nrows", [1, 2, 3, 8, 1024, 1025])
def test_halo_segments_cover_every_row_once(nrows, overlap):
    """K8's launches (``halo_segments``): every row of the block in
    exactly one segment of one launch; with ``overlap`` and more than two
    rows the first launch reads no halo row (rows 1 .. nrows-2, whose
    neighbours are the block's own) and the second holds rows 0 and
    nrows-1; at most two segments a launch, the one or two launches as
    the C entry takes them (each segment non-empty)."""
    launches = tst.halo_segments(nrows, overlap)
    cover = np.zeros(nrows, dtype=np.int64)
    for segments in launches:
        assert 1 <= len(segments) <= 2
        for b, e in segments:
            assert 0 <= b < e <= nrows
            cover[b:e] += 1
    assert np.all(cover == 1)
    if overlap and nrows > 2:
        assert launches == [((1, nrows - 1),), ((0, 1), (nrows - 1, nrows))]
    else:
        assert launches == [((0, nrows),)]


def test_halo_wrapper_rejects_bad_rows():
    """The halo rows are checked before a launch: the plain version on the
    CPU takes any row of the width, and the kernel's address check
    refuses a row of another width, dtype or device."""
    x = torch.zeros(4 * 8, dtype=torch.float32)
    good, short = torch.ones(8), torch.ones(7)
    assert tst._halo_ptr(None, x, 8) is None
    assert tst._halo_ptr(good, x, 8) == good.data_ptr()
    for bad in (short, good.double(), torch.ones(16)[::2]):
        with pytest.raises(ValueError):
            tst._halo_ptr(bad, x, 8)
    with pytest.raises(ValueError):
        tst._halo_ptr(good, torch.zeros(32, device="meta"), 8)
    with pytest.raises(RuntimeError):
        tst.stencil5_halo(x, short, None, nx=4, ny=8, coeffs=COEFFS)
