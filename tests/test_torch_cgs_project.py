"""The port's projection pass K7 (krypy_tpu_torch.kernels.orthogonalize.
cgs_project) and its Laplacian entry K10 (kernels.stencil.
laplacian_2d_kernel) against the JAX package's Pallas kernels, run in
interpret mode, on the same numpy inputs.

On CPU tensors the port's wrappers run their plain versions, so this holds
the arithmetic the CUDA kernels are checked against on the card.

Tolerances.  K7 in float64: ``atol=1e-13`` on inputs of order 1 (two sums
of at most 8192 and 26 terms, rounded in another order).  K7 in float32:
``4 eps32 sum|terms|`` of each output: a coefficient's terms are ``|V_r| .
|w|``, an element of ``w'`` has ``|w| + |c| . |B|``, and ``w'`` also
carries the two sides' coefficient difference through ``|B|``.  K10:
``4 eps32 sum|terms|`` with the stencil's terms ``(4 |u| + sum of the
neighbours' |u|) / h^2``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu.kernels import orthogonalize as jorth
from krypy_tpu.kernels import stencil as jst
from krypy_tpu_torch import interop, kernels, ops
from krypy_tpu_torch.kernels import orthogonalize as orth
from krypy_tpu_torch.kernels.parity import ProjectCheck

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
# (m, N, k): the shapes of tests/test_kernels.py and the basis of a
# GMRES(25) cycle at its first, middle and last prefix; rows past k carry
# a zero mask (and are zero, as in the solver's buffer)
SHAPES = [(9, 256, 5), (17, 1024, 11), (26, 8192, 0), (26, 8192, 12),
          (26, 8192, 25)]


def _inputs(m, N, k, dtype, seed):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((m, N)).astype(dtype)
    B = rng.standard_normal((m, N)).astype(dtype)
    V[k + 1:] = 0
    B[k + 1:] = 0
    w = rng.standard_normal(N).astype(dtype)
    mask = (np.arange(m) <= k).astype(dtype)
    return V, B, w, mask


def _t(a):
    return interop.from_numpy(a, "cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dual", [False, True], ids=["basis=V", "basis=B"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cgs_project_matches_pallas(shape, dual, dtype):
    """The prefix form (``rows = k + 1``) against the Pallas kernel's
    full-height masked sweep."""
    m, N, k = shape
    V, B, w, mask = _inputs(m, N, k, dtype, m + N + k)
    wj, cj = jorth.cgs_project(
        jnp.asarray(V), jnp.asarray(w), jnp.asarray(mask),
        basis=jnp.asarray(B) if dual else None, interpret=True)
    wt, ct = orth.cgs_project(_t(V), _t(w), _t(mask),
                              _t(B) if dual else None, rows=k + 1)
    wj, cj = np.asarray(wj), np.asarray(cj)
    wt, ct = interop.to_numpy(wt), interop.to_numpy(ct)
    assert wt.dtype == ct.dtype == dtype and ct.shape == (m,)
    assert np.all(ct[k + 1:] == 0)
    if dtype == np.float64:
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-13 * np.sqrt(N))
        np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-13 * np.sqrt(N))
        return
    Bb = np.abs(B if dual else V).astype(np.float64)
    tol_c = 4 * EPS32 * (np.abs(V).astype(np.float64) @ np.abs(w))
    assert np.all(np.abs(ct.astype(np.float64) - cj) <= tol_c)
    tol_w = 4 * EPS32 * (np.abs(w) + np.abs(cj).astype(np.float64) @ Bb) \
        + np.abs(ct.astype(np.float64) - cj) @ Bb
    assert np.all(np.abs(wt.astype(np.float64) - wj) <= tol_w)


def test_cgs_project_partial_mask_inside_the_prefix():
    """A mask with zeros INSIDE the swept rows: those coefficients are
    exactly zero and their rows are not subtracted."""
    m, N = 8, 512
    V, B, w, _ = _inputs(m, N, m - 1, np.float64, 3)
    mask = np.array([1, 0, 1, 1, 0, 1, 0, 1], np.float64)
    wj, cj = jorth.cgs_project(jnp.asarray(V), jnp.asarray(w),
                               jnp.asarray(mask), basis=jnp.asarray(B),
                               interpret=True)
    wt, ct = orth.cgs_project(_t(V), _t(w), _t(mask), _t(B))
    assert np.all(interop.to_numpy(ct)[mask == 0] == 0)
    np.testing.assert_allclose(interop.to_numpy(ct), np.asarray(cj),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(interop.to_numpy(wt), np.asarray(wj),
                               rtol=0, atol=1e-12)


def test_cgs_project_default_rows_and_plain_version():
    """``rows=None`` sweeps all m rows; the plain version is what a CPU
    tensor takes, bit for bit."""
    V, B, w, mask = (_t(a) for a in _inputs(9, 300, 8, np.float64, 5))
    got = orth.cgs_project(V, w, mask, B)
    want = orth.cgs_project_torch(V, w, mask, B, 9)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = orth.cgs_project(V, w, mask, rows=4)
    want = orth.cgs_project_torch(V, w, mask, V, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.launch_counts()["cgs_project"] == 0


@pytest.mark.parametrize("bad", ["rows", "basis_shape", "basis_dtype",
                                 "w_shape", "strided"])
def test_cgs_project_rejects_bad_operands(bad):
    V, B, w, mask = (_t(a) for a in _inputs(6, 64, 5, np.float64, 1))
    kw = dict(rows=3)
    if bad == "rows":
        kw["rows"] = 7
    elif bad == "basis_shape":
        B = B[:5].contiguous()
    elif bad == "basis_dtype":
        B = B.float()
    elif bad == "w_shape":
        w = w[:-1]
    else:
        V = V.T.contiguous().T
    with pytest.raises(ValueError):
        orth.cgs_project(V, w, mask, B, **kw)


def test_cgs_project_row_limits():
    """K7's phase 1 (its coefficients in shared memory) binds at 58112
    float32 / 29056 float64 rows, above the 7264 / 3632 its phase 0 took
    before K4's redesign; the three prefix sweeps keep their lower limit.
    Phase 0 runs on K4's grid."""
    assert orth.max_rows(4, "cgs_project") == 58112
    assert orth.max_rows(8, "cgs_project") == 29056
    assert orth.max_rows(4) == 1709 and orth.max_rows(8) == 854
    assert orth.launch_config(4096 ** 2, 26, 4, "cgs_project") == \
        orth.launch_config(4096 ** 2, 26, 4, "project_prefix") == (1024, 256)
    with pytest.raises(ValueError, match="58112"):
        orth.launch_config(1000, 58113, 4, "cgs_project")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dual", [False, True], ids=["basis=V", "basis=B"])
def test_project_check_rejects_planted_faults(dual, dtype):
    """The tolerance the card holds K7 to passes the plain version's own
    outputs and rejects each planted fault (3, one more with a second
    basis, one more in float64)."""
    m, N, rows = 26, 50001, 13
    V, B, w, _ = (_t(a).to(dtype) / (N ** 0.5 if i < 2 else 1.0)
                  for i, a in enumerate(_inputs(m, N, m - 1, np.float64, 9)))
    mask = (torch.arange(m) < rows - 2).to(dtype)
    basis = B if dual else None
    got = orth.cgs_project(V, w, mask, basis, rows=rows)
    check = ProjectCheck(V, w, mask, rows, got, basis)
    assert check.failures(got) == []
    assert check.assert_faults_caught(got) == 3 + dual + (
        dtype == torch.float64)


@pytest.mark.parametrize("nx,ny", [(16, 24), (40, 40), (13, 10)],
                         ids=["16x24", "40x40", "13x10"])
def test_laplacian_2d_kernel_matches_pallas(nx, ny):
    """K10 against the JAX kernel interpreted (float32) where that kernel
    runs (``nx % 8 == 0``), and against the port's plain Poisson operator
    in float64 everywhere, also at a row count the TPU tiling refuses."""
    rng = np.random.default_rng(nx * ny)
    x = rng.standard_normal(nx * ny)
    got64 = interop.to_numpy(kernels.laplacian_2d_kernel(_t(x), nx=nx,
                                                         ny=ny))
    want64 = interop.to_numpy(ops.poisson_2d(nx, ny, device="cpu")(_t(x)))
    np.testing.assert_allclose(got64, want64, rtol=1e-12,
                               atol=1e-12 * np.abs(want64).max())
    if nx % 8:
        with pytest.raises(ValueError):
            jst.laplacian_2d_kernel(jnp.asarray(x, jnp.float32), nx=nx,
                                    ny=ny, interpret=True)
        return
    x32 = x.astype(np.float32)
    want = np.asarray(jst.laplacian_2d_kernel(jnp.asarray(x32), nx=nx, ny=ny,
                                              interpret=True))
    got = interop.to_numpy(kernels.laplacian_2d_kernel(_t(x32), nx=nx,
                                                       ny=ny))
    assert got.dtype == np.float32
    u = np.abs(x).reshape(nx, ny)
    nb = np.zeros_like(u)
    nb[1:] += u[:-1]
    nb[:-1] += u[1:]
    nb[:, 1:] += u[:, :-1]
    nb[:, :-1] += u[:, 1:]
    terms = (4 * u + nb) * max((nx + 1) ** 2, (ny + 1) ** 2)
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= 4 * EPS32 * terms.reshape(-1))


def test_laplacian_2d_kernel_takes_explicit_spacings():
    """``hx2`` scales the row differences and ``hy2`` the column ones, as
    in the JAX kernel."""
    nx, ny = 16, 24
    x = np.random.default_rng(2).standard_normal(nx * ny)
    kw = dict(nx=nx, ny=ny, hx2=0.25, hy2=4.0)
    want = np.asarray(jst.laplacian_2d_kernel(jnp.asarray(x), interpret=True,
                                              **kw))
    got = interop.to_numpy(kernels.laplacian_2d_kernel(_t(x), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_laplacian_2d_operator():
    """The constructor's closure: ``.shape``, ``.diag`` and the matvec of
    the JAX one."""
    nx, ny = 16, 12
    op = kernels.laplacian_2d(nx, ny, device="cpu")
    jop = jst.laplacian_2d(nx, ny, interpret=True)
    assert op.shape == tuple(jop.shape) == (nx * ny, nx * ny)
    np.testing.assert_allclose(interop.to_numpy(op.diag),
                               np.asarray(jop.diag), rtol=1e-15)
    x = np.random.default_rng(0).standard_normal(nx * ny)
    np.testing.assert_allclose(interop.to_numpy(op(_t(x))),
                               np.asarray(jop(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-9)
    with pytest.raises((RuntimeError, AssertionError)):
        kernels.laplacian_2d(nx)  # the default device is the card


#: (N, itemsize, start): N of every residue mod 4 in float32 and odd N in
#: float64, each over several blocks with a ragged last one, a basis
#: whose first element lies ``start`` elements past a 16-byte boundary,
#: and N below one block's range
K7_COLUMNS = [(3 * 16384 + k, 4, 0) for k in range(4)] + [
    (3 * 16384 + 1, 4, 3), (3 * 16384 + 2, 4, 1), (3 * 8192 + 1, 8, 0),
    (3 * 8192 + 1, 8, 1), (4095, 4, 2), (37, 8, 1)]


@pytest.mark.parametrize("N,itemsize,start", K7_COLUMNS, ids=str)
def test_k7_grid_and_row_offsets_cover_every_column_once(N, itemsize,
                                                         start):
    """K7's shifted phase 1 (N not a multiple of the 16-byte group, so
    that rows start at differing offsets; else phase 1 is K6's update) as
    ``csrc/orthogonalize.cu`` walks it: blocks of ``launch_config(...,
    "cgs_project")`` own contiguous, non-empty ranges of 16-byte column
    groups; each warp steps 31 groups at a time (the block's warps
    interleaved), its 32 lanes loading 32 consecutive aligned groups
    ``A_g = row - o + g VW`` of the row's aligned superset (row r starts
    ``o = (start + r N) mod (16 / itemsize)`` elements past a 16-byte
    boundary) where one holds an element of the row, and lanes 0..30
    producing group g from their own ``A_g`` and the next lane's
    ``A_{g+1}``.  Every column of every row is produced exactly once,
    from the loaded group that holds its address, and each 16-byte load
    holds at least one element of the row (so it never leaves the
    tensor)."""
    VW, step = 16 // itemsize, 31
    rows = 6
    blocks, threads = orth.launch_config(N, rows, itemsize, "cgs_project")
    assert threads % 32 == 0
    nwarps = threads // 32
    ngroups = -(-N // VW)
    span = -(-ngroups // blocks)
    lanes = np.arange(32)
    for r in range(rows):
        row = start + r * N  # the row's first element, past a boundary
        o = row % VW
        cover = np.zeros(N, dtype=np.int64)
        for b in range(blocks):
            g_lo, g_hi = b * span, min(ngroups, (b + 1) * span)
            assert g_lo < g_hi
            for wp in range(nwarps):
                for g0 in range(g_lo + wp * step, g_hi, nwarps * step):
                    g = g0 + lanes
                    addr = row - o + g * VW
                    loaded = g * VW - o < N
                    assert np.all(addr % VW == 0)
                    assert np.all((addr + VW > row)[loaded]
                                  & (addr < row + N)[loaded])
                    mine = (lanes < step) & (g < g_hi)
                    for k in range(VW):
                        col = g * VW + k
                        use = mine & (col < N)
                        # element o + k of (A_g, A_{g+1}): the lane's own
                        # load or, past VW, the next lane's
                        src = np.where(o + k < VW, g, g + 1)
                        assert np.all(np.isin(src[use], g[loaded]))
                        off = (o + k) % VW
                        assert np.all((row - o + src * VW + off)[use]
                                      == row + col[use])
                        cover[col[use]] += 1
        assert np.all(cover == 1)
