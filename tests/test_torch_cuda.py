"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the multigrid-CG, north-star and deflated solves
through the kernels.

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

The sharded kernels K8 and K9 run on rank processes that share the card
(a one-rank NCCL world and a two-rank gloo world; NCCL takes no two
ranks on one device), against their plain versions in float64 and
against the single-device K1 and K4 -> K5 -> K6: K8 within the stencil
tolerance and, in each order against the exchange and each route of the
received rows, bit for bit K1's matvec (every row in K1's per-point
arithmetic), K9 within
:func:`krypy_tpu_torch.kernels.parity.cgs2_tolerances`.

The prefix-sweep kernels K4-K6 sum in another order than their plain
versions (cuBLAS): each output is held to its float64 value by
:class:`krypy_tpu_torch.kernels.parity.PrefixCheck` (its docstring
derives the tolerances), and each test also plants faults (a zeroed or
dropped coefficient or update, a float32 sum of float64 inputs) that the
check must reject.  The projection pass K7 is held likewise by
:class:`krypy_tpu_torch.kernels.parity.ProjectCheck`.
"""

import math

import numpy as np
import pytest
import torch

from krypy_tpu_torch import (
    functional as F,
    interop,
    kernels,
    ops,
    parallel,
    suite,
)
from krypy_tpu_torch.kernels import orthogonalize as korth
from krypy_tpu_torch.kernels import stencil as kst
from krypy_tpu_torch.kernels.parity import (
    PrefixCheck,
    ProjectCheck,
    cgs2_tolerances,
    fma_atol,
)
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
    """At ``max_rows`` (1709 float32, 854 float64 rows) K5 runs one warp
    per block and opts in to more than the default 48 KB of shared
    memory: it launches; one row more raises before launch, where K4,
    which keeps no per-row shared memory, still runs."""
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


#: K4's prefixes: one row, each row chunk's size and one more, two chunks
#: and one more, and the main path's 26 rows
K4_ROWS = [1, 8, 9, 16, 17, 26, 32, 33, 65]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", K4_ROWS)
def test_project_prefix_row_chunks(cuda_device, rows, dtype):
    """K4 (with K5 and K6) at prefixes that fill a register chunk, run one
    row past it or end in a ragged chunk, held to float64; a repeated
    call gives the same bits."""
    m, N = rows + 3, 20011
    V, w, c, mask = _random_prefix_inputs(m, N, rows - 1, dtype,
                                          cuda_device, rows)
    got, plain = _prefix_sweeps(V, w, c, mask, rows)
    assert PrefixCheck(V, w, c, mask, rows, plain).failures(got) == []
    again = korth.project_prefix(V, w, mask, rows=rows)
    assert torch.equal(again, got["project_prefix"][0])


#: N of every residue mod 4, one below one block's column range (8192
#: float32 / 4096 float64 columns), a few columns, and the basis offset
#: by one element so that its rows and ``w`` start unaligned: (N, offset)
K4_COLUMNS = [(20000, 0), (20001, 0), (20002, 0), (20003, 0), (4095, 0),
              (37, 0), (20000, 1), (20003, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,offset", K4_COLUMNS, ids=str)
def test_project_prefix_ragged_columns(cuda_device, N, offset, dtype):
    """K4 where the rows do not start on 16-byte boundaries (N % 4 != 0,
    or an offset basis and ``w``), where N ends inside a 16-byte group,
    and where the whole of N is less than one block's range: held to
    float64 at 13 of 26 rows; a repeated call gives the same bits."""
    m, rows = 26, 13
    rng = np.random.default_rng(N + offset)
    flat = torch.tensor(rng.standard_normal(m * N + offset), dtype=dtype,
                        device=cuda_device)
    V = flat[offset:].view(m, N)
    w = torch.tensor(rng.standard_normal(N + offset), dtype=dtype,
                     device=cuda_device)[offset:]
    c = torch.tensor(rng.standard_normal(m), dtype=dtype, device=cuda_device)
    mask = (torch.arange(m, device=cuda_device) < rows - 2).to(dtype)
    got, plain = _prefix_sweeps(V, w, c, mask, rows)
    check = PrefixCheck(V, w, c, mask, rows, plain)
    assert check.failures(got) == []
    assert check.assert_faults_caught(got) == (
        8 if dtype == torch.float64 else 6)
    again = korth.project_prefix(V, w, mask, rows=rows)
    assert torch.equal(again, got["project_prefix"][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_project_sweep_at_the_cgs_project_limit(cuda_device, dtype):
    """K7 at its row limit (``max_rows(..., "cgs_project")``, where its
    phase 1's coefficients fill a block's shared memory) held to float64,
    and K4 at the same prefix: the same sweep on the same grid, so the
    same coefficient bits."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    rows, N = korth.max_rows(itemsize, "cgs_project"), 3001
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    V = torch.randn(rows, N, generator=gen, device=cuda_device,
                    dtype=dtype) / N ** 0.5
    w = torch.randn(N, generator=gen, device=cuda_device, dtype=dtype)
    mask = torch.ones(rows, device=cuda_device, dtype=dtype)
    got = korth.cgs_project(V, w, mask, rows=rows)
    plain = korth.cgs_project_torch(V, w, mask, V, rows)
    assert ProjectCheck(V, w, mask, rows, plain).failures(got) == []
    assert torch.equal(korth.project_prefix(V, w, mask, rows=rows), got[1])


def test_prefix_kernels_raise_on_other_dtypes(cuda_device):
    for dtype in (torch.complex64, torch.float16):
        V = torch.zeros(4, 64, dtype=dtype, device=cuda_device)
        w = torch.zeros(64, dtype=dtype, device=cuda_device)
        with pytest.raises(TypeError):
            korth.project_prefix(V, w, torch.ones(4), rows=2)
        with pytest.raises(TypeError):
            korth.update_prefix(V, w, torch.zeros(4, dtype=dtype,
                                                  device=cuda_device))


# (m, N, rows, k): small, ragged, past the 1024-block cap, a tall prefix
# (over 48 KB of shared memory in phase 0), and config 4's basis
PROJECT_SHAPES = [(9, 256, 8, 5), (5, 1000, 5, 2), (26, 4097, 13, 10),
                  (8, 600001, 8, 6), (2000, 3001, 2000, 1990),
                  (26, 4096 ** 2, 13, 10), (26, 4096 ** 2, 26, 23)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dual", [False, True], ids=["basis=V", "basis=B"])
@pytest.mark.parametrize("shape", PROJECT_SHAPES, ids=str)
def test_cgs_project_matches_plain(cuda_device, shape, dual, dtype):
    """K7 held to float64 (coefficients and ``w'``), its coefficients
    zero past ``rows`` and where the mask is zero, each planted fault
    rejected, one launch counted."""
    m, N, rows, k = shape
    gen = torch.Generator(device=cuda_device).manual_seed(m + N + rows)
    V, B = (torch.randn(m, N, generator=gen, device=cuda_device,
                        dtype=dtype) / N ** 0.5 for _ in range(2))
    w = torch.randn(N, generator=gen, device=cuda_device, dtype=dtype)
    mask = (torch.arange(m, device=cuda_device) <= k).to(dtype)
    basis = B if dual else None
    before = kernels.launch_counts()
    got = korth.cgs_project(V, w, mask, basis, rows=rows)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["cgs_project"] == before["cgs_project"] + 1
    assert all(after[n] == before[n] for n in after if n != "cgs_project")
    plain = korth.cgs_project_torch(V, w, mask, B if dual else V, rows)
    check = ProjectCheck(V, w, mask, rows, plain, basis)
    assert check.failures(got) == []
    assert torch.all(got[1][mask == 0] == 0) and got[1].shape == (m,)
    assert check.assert_faults_caught(got) == 3 + dual + (
        dtype == torch.float64)


def test_cgs_project_is_deterministic(cuda_device):
    """No float atomics: the same call gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    V, B = (torch.randn(26, 1 << 20, generator=gen, device=cuda_device)
            for _ in range(2))
    w = torch.randn(1 << 20, generator=gen, device=cuda_device)
    mask = torch.ones(26, device=cuda_device)
    for basis in (None, B):
        a = korth.cgs_project(V, w, mask, basis, rows=13)
        b = korth.cgs_project(V, w, mask, basis, rows=13)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cgs_project_phases_are_k4_and_k6(cuda_device):
    """K7's phase 0 is K4's sweep, so its coefficients are K4's bit for
    bit; where N is a multiple of 4 its phase 1 is K6's update, so ``w'``
    is K6's with them, also for a basis and ``w`` one element off
    alignment; one column more takes the shifted update, held to
    float64."""
    for N, off in ((1 << 20, 0), (1 << 20, 1), ((1 << 20) + 1, 0)):
        gen = torch.Generator(device=cuda_device).manual_seed(N + off)
        V = (torch.randn(26 * N + off, generator=gen, device=cuda_device)
             / N ** 0.5)[off:].view(26, N)
        w = torch.randn(N + off, generator=gen, device=cuda_device)[off:]
        mask = torch.ones(26, device=cuda_device)
        w_out, c = korth.cgs_project(V, w, mask, rows=13)
        assert torch.equal(c, korth.project_prefix(V, w, mask, rows=13))
        if N % 4 == 0:
            assert torch.equal(w_out, korth.update_prefix(V, w, c, rows=13))
        else:
            plain = korth.cgs_project_torch(V, w, mask, V, 13)
            assert ProjectCheck(V, w, mask, 13, plain).failures(
                (w_out, c)) == []


def test_cgs_project_raises_on_bad_operands(cuda_device):
    for dtype in (torch.complex64, torch.float16):
        V = torch.zeros(4, 64, dtype=dtype, device=cuda_device)
        w = torch.zeros(64, dtype=dtype, device=cuda_device)
        with pytest.raises(TypeError):
            korth.cgs_project(V, w, torch.ones(4), rows=2)
    V = torch.zeros(4, 64, device=cuda_device)
    w = torch.zeros(64, device=cuda_device)
    with pytest.raises(ValueError):
        korth.cgs_project(V, w, torch.ones(4), rows=5)
    with pytest.raises(ValueError):
        korth.cgs_project(V, w, torch.ones(4), V.double())
    with pytest.raises(ValueError):
        korth.cgs_project(V, w, torch.ones(4), V.cpu())
    top = korth.max_rows(4, "cgs_project")
    tall = torch.zeros(top + 1, 64, device=cuda_device)
    korth.cgs_project(tall, w, torch.ones(top + 1), rows=top)
    with pytest.raises(ValueError, match="shared memory"):
        korth.cgs_project(tall, w, torch.ones(top + 1), rows=top + 1)


#: K7 as config 3 runs it: a 31-row float32 basis of 4095^2 columns (N = 1
#: mod 4), and of one and two columns more (2 and 3 mod 4), projected along
#: a second basis (the dual basis P) at its first prefixes, the middle
#: one and the last two
C3_PROJECT_ROWS = [1, 2, 3, 4, 5, 16, 30, 31]


@pytest.mark.parametrize("extra", [0, 1, 2],
                         ids=["N=1mod4", "N=2mod4", "N=3mod4"])
def test_cgs_project_at_config3_shape(cuda_device, extra):
    """K7 where three rows in four start off a 16-byte boundary: at every
    prefix of ``C3_PROJECT_ROWS`` held to float64 by ``ProjectCheck``,
    each planted fault caught, a repeated call bit-identical."""
    m, N = 31, 4095 ** 2 + extra
    gen = torch.Generator(device=cuda_device).manual_seed(extra)
    V, P = (torch.randn(m, N, generator=gen, device=cuda_device) / N ** 0.5
            for _ in range(2))
    w = torch.randn(N, generator=gen, device=cuda_device)
    for rows in C3_PROJECT_ROWS:
        mask = (torch.arange(m, device=cuda_device) < rows).float()
        got = korth.cgs_project(V, w, mask, P, rows=rows)
        again = korth.cgs_project(V, w, mask, P, rows=rows)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])
        plain = korth.cgs_project_torch(V, w, mask, P, rows)
        check = ProjectCheck(V, w, mask, rows, plain, P)
        assert check.failures(got) == [], rows
        assert check.assert_faults_caught(got) == 4
        del check, got, again, plain


#: K1's row-ring tiles: (nrows, ncols, R, P, offset) with the operands
#: starting ``offset`` floats past a 16-byte boundary: the padded and
#: unpadded finest buffers, the odd widths of the unpadded V-cycle, a
#: ragged grid, the smallest levels, and row starts of every alignment
K1_SHAPES = [(4095, 4095, 4096, 4096, 0), (4096, 4096, 4096, 4096, 0),
             (4095, 4095, 4095, 4095, 0), (2047, 2047, 2047, 2047, 0),
             (511, 511, 511, 511, 0), (1021, 1000, 1021, 1000, 0),
             (1, 1, 1, 1, 0), (3, 3, 3, 3, 0), (7, 7, 7, 7, 0),
             (13, 130, 13, 130, 1), (9, 121, 9, 122, 3),
             (300, 257, 300, 257, 2)]


@pytest.mark.parametrize("kind", ["lap", "cd"])
@pytest.mark.parametrize("shape", K1_SHAPES, ids=str)
def test_k1_tiles_match_plain(cuda_device, shape, kind):
    """K1's four uses against the plain version (the stencil tolerance),
    with the V-cycle's Laplacian and the north star's nonsymmetric
    coefficients; noise in the pads must not reach the output; a repeated
    call gives the same bits."""
    nrows, ncols, R, P, off = shape
    rng = np.random.default_rng(R * P + off + (kind == "cd"))
    u, g = (interop.from_numpy(rng.standard_normal(R * P + off).astype(
        np.float32), cuda_device)[off:] for _ in range(2))
    A = cd_coeffs(nrows) if kind == "cd" else _operator_lap(nrows)
    for co, has_g, al, be in _affine_uses(A, 0.8 / A[0]):
        kw = dict(nx=R, ny=P, coeffs=co, ncols=ncols, nrows=nrows, alpha=al,
                  beta=be)
        got = kst.stencil5_affine(u, g if has_g else None, **kw)
        again = kst.stencil5_affine(u, g if has_g else None, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)

        def plain(a, b):
            return kst.stencil5_affine_torch(
                a.view(R, P), b.view(R, P) if has_g else None, co, nrows,
                ncols, al, be).view(-1)

        want, want64 = plain(u, g), plain(u.double(), g.double())
        np.testing.assert_allclose(interop.to_numpy(got),
                                   interop.to_numpy(want), rtol=2e-6,
                                   atol=fma_atol(want, want64))


#: the coarse form: (nrows, ncols, R, P) of the unpadded and the padded
#: coarsest level, the largest V-cycle level it takes, and a ragged region
COARSE_SHAPES = [(31, 31, 31, 31), (31, 31, 32, 128), (127, 127, 127, 127),
                 (9, 121, 16, 128)]


@pytest.mark.parametrize("sweeps", [1, 2, 60])
@pytest.mark.parametrize("shape", COARSE_SHAPES, ids=str)
def test_coarse_form_matches_plain(cuda_device, shape, sweeps):
    """K1's coarse form against its plain version (the stencil
    tolerance), noise in the pads of ``r`` never read, exact zeros off
    the region, one launch counted as ``stencil5_affine`` and
    ``stencil5_coarse``, a repeated call bit-identical."""
    nrows, ncols, R, P = shape
    rng = np.random.default_rng(R * P + sweeps)
    r = interop.from_numpy(rng.standard_normal(R * P).astype(np.float32),
                           cuda_device)
    A = _operator_lap(nrows)
    w = 0.8 / A[0]
    kw = dict(nx=R, ny=P, coeffs=A, w=w, sweeps=sweeps, ncols=ncols,
              nrows=nrows)
    before = kernels.launch_counts()
    got = kst.stencil5_coarse(r, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["stencil5_affine"] == before["stencil5_affine"] + 1
    assert after["stencil5_coarse"] == before["stencil5_coarse"] + 1
    assert torch.equal(got, kst.stencil5_coarse(r, **kw))
    out = got.view(R, P)
    assert bool(torch.all(out[nrows:] == 0)) and bool(torch.all(
        out[:, ncols:] == 0))

    def plain(v):
        return kst.stencil5_coarse_torch(v.view(R, P), A, w, sweeps, nrows,
                                         ncols).view(-1)

    want, want64 = plain(r), plain(r.double())
    np.testing.assert_allclose(interop.to_numpy(got), interop.to_numpy(want),
                               rtol=2e-6, atol=fma_atol(want, want64))


def test_coarse_form_size_limit(cuda_device):
    """The dispatch by size on the card: the coarse form takes the
    largest region that fits one block's shared memory and refuses the
    next one; the V-cycle runs its coarsest level as one coarse launch at
    127^2 and as per-sweep K1 launches at 255^2."""
    n = 1
    while kst.coarse_fits(n + 1, n + 1):
        n += 1
    for m, fits in ((n, True), (n + 1, False)):
        r = torch.randn(m * m, device=cuda_device)
        kw = dict(nx=m, ny=m, coeffs=_operator_lap(m), w=0.1, sweeps=2)
        if fits:
            kst.stencil5_coarse(r, **kw)
            torch.cuda.synchronize()
        else:
            with pytest.raises(ValueError, match="shared memory"):
                kst.stencil5_coarse(r, **kw)
    for coarsest, coarse, per_sweep in ((127, 1, 0), (255, 0, 3)):
        M = ops.multigrid_poisson_preconditioner(
            255, coarsest=coarsest, coarse_sweeps=3, impl="cuda",
            device=cuda_device)
        r = torch.randn(255 * 255, device=cuda_device)
        kernels.reset_launch_counts()
        got = M(r)
        counts = kernels.launch_counts()
        plain = ops.multigrid_poisson_preconditioner(
            255, coarsest=coarsest, coarse_sweeps=3, impl="torch",
            device=cuda_device)(r)
        assert counts["stencil5_coarse"] == coarse
        # above the coarse level: 4 K1 launches per level
        levels = 1 if coarsest == 127 else 0
        assert counts["stencil5_affine"] == 4 * levels + coarse + per_sweep
        scale = max(1.0, float(plain.abs().max()))
        assert float((got - plain).abs().max()) <= 5e-6 * scale


#: K2 beyond CASES: the north star's two finest V-cycle buffers, a buffer
#: of one strip and one step, logical regions one column or row short of
#: a strip or step edge, a region that spills one row and one column into
#: a second step and strip, and buffers whose rows do not start on
#: 16-byte boundaries (ny % 4 != 0, or the operands offset by one
#: element): (nrows, ncols, R, P, offset)
JACOBI2_SHAPES = [(4095, 4095, 4096, 4096, 0), (2047, 2047, 2048, 2048, 0),
                  (8, 128, 8, 128, 0), (7, 127, 8, 128, 0),
                  (63, 255, 64, 256, 0), (65, 129, 72, 256, 0),
                  (9, 121, 9, 122, 0), (13, 130, 13, 130, 1)]


@pytest.mark.parametrize("kind", ["lap", "cd"])
@pytest.mark.parametrize("shape", JACOBI2_SHAPES, ids=str)
def test_jacobi2_matches_plain(cuda_device, shape, kind):
    """K2 against its plain version (the stencil tolerance), with the
    V-cycle's Laplacian and with the north star's nonsymmetric
    coefficients (a swapped neighbour shows only there), both damping
    scales; noise in the pads must not reach the output; a repeated call
    gives the same bits."""
    nrows, ncols, R, P, off = shape
    rng = np.random.default_rng(R * P + off)
    u, g = (interop.from_numpy(rng.standard_normal(R * P + off).astype(
        np.float32), cuda_device)[off:] for _ in range(2))
    A = cd_coeffs(nrows) if kind == "cd" else _operator_lap(nrows)
    w = 0.8 / A[0]
    for s in (1.0, 3.25):
        before = kst.launch_counts()["stencil5_jacobi2"]
        kw = dict(nx=R, ny=P, coeffs=A, w=w, s=s, ncols=ncols, nrows=nrows)
        got = kst.stencil5_jacobi2(u, g, **kw)
        again = kst.stencil5_jacobi2(u, g, **kw)
        torch.cuda.synchronize()
        assert kst.launch_counts()["stencil5_jacobi2"] == before + 2
        assert torch.equal(got, again)

        def plain(a, b):
            return kst.stencil5_jacobi2_torch(a.view(R, P), b.view(R, P), A,
                                              w, s, nrows, ncols).view(-1)

        want, want64 = plain(u, g), plain(u.double(), g.double())
        np.testing.assert_allclose(interop.to_numpy(got),
                                   interop.to_numpy(want), rtol=2e-6,
                                   atol=fma_atol(want, want64))


@pytest.mark.parametrize("attr", ["JACOBI2_STRIP", "JACOBI2_STEP_ROWS"])
def test_jacobi2_entry_refuses_another_geometry(cuda_device, monkeypatch,
                                                attr):
    """The wrapper passes its copy of K2's geometry to the C entry, which
    refuses any other than the kernel's own: the launch raises and is not
    counted."""
    monkeypatch.setattr(kst, attr, getattr(kst, attr) // 2)
    u = torch.zeros(16 * 128, device=cuda_device)
    before = kst.launch_counts()["stencil5_jacobi2"]
    with pytest.raises(RuntimeError, match="launch failed"):
        kst.stencil5_jacobi2(u, u, nx=16, ny=128, coeffs=_operator_lap(15),
                             w=0.1, ncols=15, nrows=15)
    assert kst.launch_counts()["stencil5_jacobi2"] == before


def _operator_lap(n):
    h2 = (1.0 / (n + 1)) ** 2
    return (4.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2, -1.0 / h2)


@pytest.mark.parametrize("nx,ny", [(1024, 1024), (1021, 1000), (13, 10)])
def test_laplacian_2d_kernel_matches_plain(cuda_device, nx, ny):
    """K10, the entry over K1, against the plain Poisson operator, also
    where the row count is no multiple of 8."""
    gen = torch.Generator(device=cuda_device).manual_seed(nx)
    x = torch.randn(nx * ny, generator=gen, device=cuda_device)
    plain = ops.poisson_2d(nx, ny, impl="torch", device=cuda_device)
    before = kernels.launch_counts()["stencil5_affine"]
    got = kernels.laplacian_2d_kernel(x, nx=nx, ny=ny)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["stencil5_affine"] == before + 1
    want, want64 = plain(x), plain(x.double())
    np.testing.assert_allclose(interop.to_numpy(got), interop.to_numpy(want),
                               rtol=2e-6, atol=fma_atol(want, want64))
    op = kernels.laplacian_2d(nx, ny)
    assert op.shape == (nx * ny, nx * ny) and op.diag.is_cuda
    assert torch.equal(op(x), got)


def test_deflated_gmres_through_k7_matches_plain_lane(cuda_device):
    """Config 4 at nx=511: the harvest, six Ritz vectors and the refined
    deflated solve on the kernel lane (K1-K3 and K7, twice per GMRES
    iteration, no prefix sweep) against the plain lane (cgs2) on the
    card."""
    nx = 511
    b = torch.ones(nx * nx, dtype=torch.float64, device=cuda_device)
    out = {}
    for impl, ortho in (("cuda", "cgs2_pallas"), ("torch", "cgs2")):
        harvest, make_solve, A64 = suite.make_config4(nx, impl, ortho,
                                                      cuda_device)
        kernels.reset_launch_counts()
        res0, U, theta = harvest()
        counts = kernels.launch_counts()
        assert U.shape == (res0.x.shape[0], suite.N_VECTORS)
        assert counts["cgs_project"] == (
            2 * int(res0.niter) if impl == "cuda" else 0)
        solve = make_solve(U)
        solve(b)  # the hidden warm-up solve runs here
        kernels.reset_launch_counts()
        res, info = solve(b)
        counts = kernels.launch_counts()
        rel = torch.linalg.vector_norm(b - A64(res.x)) / \
            torch.linalg.vector_norm(b)
        assert float(rel) <= suite.TOL
        if impl == "cuda":
            assert counts["cgs_project"] == 2 * info["inner_iters"]
            assert counts["stencil5_affine"] > 0
            assert counts["project_prefix"] == counts["apply_project"] \
                == counts["update_prefix"] == 0
        else:
            assert all(c == 0 for c in counts.values())
        out[impl] = (res, info, int(res0.niter), theta)
    (rc, ic, n0c, thc), (rt, it, n0t, tht) = out["cuda"], out["torch"]
    assert abs(n0c - n0t) <= 1
    np.testing.assert_allclose(np.sort(np.real(thc[:5])),
                               np.sort(np.real(tht[:5])), atol=1e-2)
    assert ic["cycles"] == it["cycles"]
    assert abs(ic["inner_iters"] - it["inner_iters"]) <= 3
    dx = torch.linalg.vector_norm(rc.x - rt.x) / torch.linalg.vector_norm(
        rt.x)
    assert float(dx) <= 1e-6


def test_recycling_sequence_through_k7(cuda_device):
    """The four-system sequence at nx=511: every solve converges, the
    recycled ones in fewer iterations, K7 twice per iteration."""
    kernels.reset_launch_counts()
    runs = suite.recycling_sequence(511, "cuda", "cgs2_pallas", cuda_device)
    counts = kernels.launch_counts()
    plain = suite.recycling_sequence(511, "cuda", "cgs2_pallas",
                                     cuda_device, recycle=False)
    assert all(r["status"] == 0 for r in runs + plain)
    assert counts["cgs_project"] == 2 * sum(r["niter"] for r in runs)
    assert all(r["niter"] < p["niter"] for r, p in zip(runs[1:], plain[1:]))


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
    # K1-K6 run; K7 belongs to the cgs*_pallas schemes, K8 and K9 to a
    # mesh
    idle = ("cgs_project", "stencil5_sharded", "cgs2_fused_sharded")
    assert all((c > 0) == (k not in idle)
               for k, c in out["cuda_launches"].items())
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


def sharded_kernel_cases(mesh):
    """Rank side of :func:`test_sharded_kernels_match_one_device`: K8 on
    the north star's nonsymmetric stencil at 256^2 and K9 at 13 of 26
    rows, gathered, against their plain versions in float64 and the
    single-device K1 and K4 -> K5 -> K6 on the same inputs (drawn from
    one seed on the card by every rank)."""
    device, nx, rows = mesh.device, 256, 13
    N = nx * nx
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(N, generator=gen, device=device)
    V = torch.randn(26, N, generator=gen, device=device) / math.sqrt(N)
    w = torch.randn(N, generator=gen, device=device)
    mask = (torch.arange(26, device=device) < rows - 2).float()
    blk = parallel.block_of(N, mesh)
    co = cd_coeffs(nx)
    kernels.reset_launch_counts()
    y = parallel.gather_vector(kernels.stencil5_sharded(
        x[blk].contiguous(), nx=nx, ny=nx, coeffs=co, mesh=mesh), mesh)
    w2, c = korth.cgs2_fused_sharded(V[:, blk].contiguous(),
                                     w[blk].contiguous(), mask, mesh=mesh,
                                     rows=rows, n=N)
    w2 = parallel.gather_vector(w2, mesh)
    launches = kernels.launch_counts()
    # K8 against the plain stencil in float64, at the bound the plain
    # float32 stencil's own error sets, and against the single-device K1
    want64 = kst.stencil5_affine_torch(x.double().view(nx, nx), None, co,
                                       nx, nx).view(-1)
    atol = fma_atol(kst.stencil5_affine_torch(x.view(nx, nx), None, co, nx,
                                              nx).view(-1), want64)
    want = kst.stencil5_pipelined(x, nx=nx, ny=nx, coeffs=co)
    err = (y.double() - want64).abs()
    k8_ok = (torch.all(err <= atol + 2e-6 * want64.abs())
             and torch.all((y - want).abs() <= atol + 2e-6 * want.abs()))
    # K9 against the plain K4 -> K5 -> K6 in float64 and the single-device
    # kernels
    V64, w64, mask64 = V.double(), w.double(), mask.double()
    c1 = korth.project_prefix_torch(V64, w64, mask64, rows)
    w1, c2 = korth.apply_project_torch(V64, w64, c1, mask64, rows)
    k9_ok = bool(torch.all(c[rows:] == 0))
    for ref_w2, ref_c in ((korth.update_prefix_torch(V64, w1, c2, rows),
                           c1 + c2),
                          korth.cgs2_fused(V, w, mask, rows=rows)):
        t_c, t_w = cgs2_tolerances(V, w, ref_c, mask, rows)
        k9_ok = k9_ok and bool(
            torch.all((c[:rows] - ref_c[:rows]).double().abs() <= t_c)
            and torch.all((w2 - ref_w2).double().abs() <= t_w))
    # K8 in both orders against the exchange and both routes of the rows
    # gloo receives: the single-device K1 matvec bit for bit
    k8_bitwise = [
        bool(torch.equal(parallel.gather_vector(kernels.stencil5_sharded(
            x[blk].contiguous(), nx=nx, ny=nx, coeffs=co, mesh=mesh,
            overlap=overlap, mapped=mapped), mesh), want))
        for overlap in (False, True) for mapped in (False, True)]
    # GMRES with ortho="cgs2_fused" where N does not divide over the mesh:
    # K9 on blocks of unequal length, once per iteration, against the
    # two-pass ortho="cgs2" (the JAX package's fused_force_jnp there)
    n_odd = 64 * mesh.size + 1
    n_loc = len(range(n_odd)[parallel.block_of(n_odd, mesh)])
    d = parallel.shard_vector(1.0 + np.arange(n_odd) / n_odd, mesh).float()
    b = torch.ones(n_loc, device=device)
    with mesh:
        kernels.reset_launch_counts()
        fused = F.gmres(lambda v: d * v, b, tol=1e-6, maxiter=20,
                        ortho="cgs2_fused")
        uneven_k9 = kernels.launch_counts()["cgs2_fused_sharded"]
        two_pass = F.gmres(lambda v: d * v, b, tol=1e-6, maxiter=20,
                           ortho="cgs2")
    uneven_same = int(fused.niter) == int(two_pass.niter) and bool(
        torch.all((fused.x - two_pass.x).abs() <= 1e-5))
    return {"k8_ok": np.bool_(bool(k8_ok)), "k9_ok": np.bool_(k9_ok),
            "k8_bitwise": np.array(k8_bitwise),
            "k8_err": np.float64(err.max()),
            "launches": np.array([launches["stencil5_sharded"],
                                  launches["stencil5_affine"],
                                  launches["cgs2_fused_sharded"],
                                  launches["apply_project"]]),
            "c": interop.to_numpy(c),
            "uneven": np.array([uneven_k9, uneven_same,
                                int(fused.status), int(fused.niter)])}


@pytest.mark.parametrize("backend,P", [("nccl", 1), ("gloo", 2)])
def test_sharded_kernels_match_one_device(cuda_device, tmp_path, backend,
                                          P):
    """K8 and K9 on ranks that share the card, against the single-device
    kernels; each launched once per call (K8 over one K1, K9 over one of
    each prefix sweep), and K9's coefficients the same bits on every
    rank."""
    from test_torch_parallel import run_ranks

    ranks = run_ranks(__file__, "sharded_kernel_cases", P, tmp_path,
                      device=str(cuda_device), backend=backend)
    for r in ranks:
        assert r["k8_ok"] and r["k9_ok"], (r["k8_err"], backend, P)
        assert r["k8_bitwise"].all(), r["k8_bitwise"]
        assert list(r["launches"]) == [1, 1, 1, 1]
        assert r["c"].tobytes() == ranks[0]["c"].tobytes()
        # where N does not divide over the mesh, K9 runs on the unequal
        # blocks and agrees with the two-pass scheme
        k9, same, status, niter = r["uneven"]
        assert status == F.CONVERGED and same
        assert k9 == niter > 0


#: K8's kernel on one row block (rows, width, operand offset in floats):
#: a 4-rank block of the mesh phase's 4096^2, an odd width, rows that
#: start off 16-byte alignment, one and two rows
HALO_SHAPES = [(1024, 4096, 0), (4096, 4096, 0), (1023, 4095, 0),
               (64, 4095, 1), (9, 121, 3), (1, 130, 0), (2, 7, 2)]


def _halo_rows(rng, ny, where, device):
    """Two random halo rows of width ``ny``: on the card (``"device"``),
    at an odd offset there (``"offset"``: each row 1 float past a 16-byte
    boundary), or in pinned host memory (``"pinned"``, read in place)."""
    vals = rng.standard_normal((2, ny), dtype=np.float32)
    if where == "pinned":
        rows = torch.from_numpy(vals).pin_memory()
        return rows[0], rows[1]
    if where == "offset":
        buf = torch.zeros(2 * ny + 8, device=device)
        top, bot = buf[1:1 + ny], buf[ny + 5:2 * ny + 5]
        top.copy_(torch.from_numpy(vals[0]))
        bot.copy_(torch.from_numpy(vals[1]))
        return top, bot
    return tuple(torch.from_numpy(v).to(device) for v in vals)


@pytest.mark.parametrize("where", ["device", "offset", "pinned"])
@pytest.mark.parametrize("halos", ["both", "top", "bottom"])
@pytest.mark.parametrize("shape", HALO_SHAPES, ids=str)
def test_halo_form_matches_plain(cuda_device, shape, halos, where):
    """K8's kernel (``stencil5_halo``) with random halo rows against its
    plain version, float32, the stencil tolerance; one launch counted as
    ``stencil5_affine``; a repeated call the same bits; and split as K8
    splits it with its exchange in flight (the interior rows, then rows 0
    and nx-1 as two segments of one launch) the same bits again."""
    nx, ny, off = shape
    rng = np.random.default_rng(nx * ny + off + len(halos) + len(where))
    x = interop.from_numpy(rng.standard_normal(nx * ny + off).astype(
        np.float32), cuda_device)[off:]
    top, bot = _halo_rows(rng, ny, where, cuda_device)
    top = top if halos != "bottom" else None
    bot = bot if halos != "top" else None
    co = cd_coeffs(nx)
    before = kernels.launch_counts()["stencil5_affine"]
    got = kst.stencil5_halo(x, top, bot, nx=nx, ny=ny, coeffs=co)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["stencil5_affine"] == before + 1
    assert torch.equal(got, kst.stencil5_halo(x, top, bot, nx=nx, ny=ny,
                                              coeffs=co))
    split = torch.empty_like(x)
    for k, segments in enumerate(kst.halo_segments(nx, True)):
        kst._halo_launch(x, *((None, None) if k == 0 and nx > 2 else
                              (top, bot)), split, nx, ny, co, segments)
    torch.cuda.synchronize()
    assert torch.equal(split, got)

    def plain(v, dtype):
        return kst.stencil5_halo_torch(
            v.view(nx, ny).to(dtype),
            *(None if t is None else t.to(cuda_device, dtype)
              for t in (top, bot)), co).reshape(-1)

    want, want64 = plain(x, torch.float32), plain(x, torch.float64)
    np.testing.assert_allclose(interop.to_numpy(got), interop.to_numpy(want),
                               rtol=2e-6, atol=fma_atol(want, want64))


@pytest.mark.parametrize("shape", HALO_SHAPES, ids=str)
def test_halo_form_without_halos_is_k1(cuda_device, shape):
    """With null halo rows K8's kernel is K1's matvec of the block, the
    same bits; and the rows [a, b) of a grid with its rows a-1 and b as
    halo rows are the single-device K1 matvec's rows there, bit for bit
    (every row in the same per-point arithmetic)."""
    nx, ny, off = shape
    rng = np.random.default_rng(nx + ny + off)
    x = interop.from_numpy(rng.standard_normal(nx * ny + off).astype(
        np.float32), cuda_device)[off:]
    co = cd_coeffs(nx)
    k1 = kst.stencil5_affine(x, nx=nx, ny=ny, coeffs=co)
    assert torch.equal(kst.stencil5_halo(x, nx=nx, ny=ny, coeffs=co), k1)
    if nx > 2:
        u = x.view(nx, ny)
        a, b = 1, nx - 1
        block = u[a:b].contiguous().view(-1)
        got = kst.stencil5_halo(block, u[a - 1].clone(), u[b].clone(),
                                nx=b - a, ny=ny, coeffs=co)
        assert torch.equal(got.view(b - a, ny), k1.view(nx, ny)[a:b])


def test_shape_vecs_puts_numpy_on_the_card(cuda_device):
    """``shape_vecs`` puts a numpy argument on the card by default, as the
    JAX package's puts it on the default device; a tensor keeps its
    device, and ``device="cpu"`` keeps numpy on the CPU."""
    from krypy_tpu_torch.core import dtypes

    t = torch.ones(3)
    flat, (a, b) = dtypes.shape_vecs(np.arange(3.0), t)
    assert flat and a.is_cuda and tuple(a.shape) == (3, 1)
    assert b.device.type == "cpu"
    _, (c,) = dtypes.shape_vecs(np.arange(3.0), device="cpu")
    assert c.device.type == "cpu"


def test_sharded_kernels_on_cuda_raise_without_the_library(
        cuda_device, tmp_path, monkeypatch):
    """On a CUDA tensor K8 and K9 launch their kernels or raise: with the
    kernel library failing to load they raise, and the plain versions are
    never called."""
    from krypy_tpu_torch.kernels import _build

    def refuse(*args, **kwargs):
        raise RuntimeError("kernel library refused to load")

    def plain(*args, **kwargs):
        pytest.fail("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(_build, "load", refuse)
    for mod, name in ((kst, "stencil5_affine_torch"),
                      (korth, "project_prefix_torch"),
                      (korth, "apply_project_torch"),
                      (korth, "update_prefix_torch")):
        monkeypatch.setattr(mod, name, plain)
    parallel.init_distributed(parallel.file_rendezvous(tmp_path), 1, 0,
                              "gloo", timeout=60)
    try:
        mesh = parallel.make_mesh(1, device=cuda_device)
        x = torch.ones(64 * 64, device=cuda_device)
        with pytest.raises(RuntimeError, match="refused"):
            kst.stencil5_sharded(x, nx=64, ny=64, coeffs=cd_coeffs(64),
                                 mesh=mesh)
        V = torch.ones(4, 64, device=cuda_device)
        with pytest.raises(RuntimeError, match="refused"):
            korth.cgs2_fused_sharded(V, x[:64], torch.ones(4), mesh=mesh,
                                     n=64)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the unpadded V-cycle, MINRES, configs 2 and 3, K7 on a mesh
# ---------------------------------------------------------------------------


def test_unpadded_vcycle_kernel_lane_matches_plain(cuda_device):
    """The unpadded V-cycle at 1023^2 (coarsest 31, 60 coarse sweeps)
    through K1 at every level against its plain lane on the card, float32,
    within the bound of the padded V-cycle's lanes (``5e-6 * max|want|``);
    K1 once per level Laplacian: 4 per level above the coarse one (the
    collapsed presmooth, the residual, two post-sweeps), and its coarse
    form once for the 60 sweeps there."""
    nx = 1023
    kw = dict(coarsest=31, coarse_sweeps=60, device=cuda_device)
    r = torch.randn(nx * nx, generator=torch.Generator(
        device=cuda_device).manual_seed(5), device=cuda_device)
    plain = ops.multigrid_poisson_preconditioner(nx, impl="torch", **kw)(r)
    kernels.reset_launch_counts()
    got = ops.multigrid_poisson_preconditioner(nx, impl="cuda", **kw)(r)
    counts = kernels.launch_counts()
    assert counts["stencil5_affine"] == 4 * 5 + 1
    assert counts["stencil5_coarse"] == 1
    assert sum(counts.values()) == counts["stencil5_affine"] + 1
    scale = max(1.0, float(plain.abs().max()))
    assert float((got - plain).abs().max()) <= 5e-6 * scale
    # float64 never reaches K1
    kernels.reset_launch_counts()
    ops.multigrid_poisson_preconditioner(nx, impl="cuda", **kw)(r.double())
    assert kernels.launch_counts()["stencil5_affine"] == 0


def test_minres_on_the_card(cuda_device):
    """MINRES on the card: float64 with Jacobi against the same solve on
    the CPU (equal counts, histories to the CPU tests' 1e-9), and config
    2's float32 solve at 255^2 through K1 against its plain lane."""
    nx = 31
    b = np.random.default_rng(0).standard_normal(nx * nx)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        A = ops.poisson_2d(nx, device=dev)
        runs.append(F.minres(A, interop.from_numpy(b, dev),
                             M=ops.jacobi_preconditioner(A), tol=1e-10,
                             maxiter=300))
    (rc, rh) = runs
    assert int(rc.niter) == int(rh.niter) and int(rc.status) == F.CONVERGED
    np.testing.assert_allclose(interop.to_numpy(rc.resnorms),
                               interop.to_numpy(rh.resnorms), rtol=1e-9,
                               atol=1e-13)
    out = {}
    for impl in ("cuda", "torch"):
        _, A64, _, _, b2, solves = suite.make_config2(255, impl,
                                                      cuda_device)
        kernels.reset_launch_counts()
        res, info = solves["minres"](b2)
        out[impl] = (info, kernels.launch_counts())
        assert float(res.resnorms.min()) <= 1e-8
    (ic, cc), (it, ct) = out["cuda"], out["torch"]
    assert ic["cycles"] == it["cycles"]
    assert abs(ic["inner_iters"] - it["inner_iters"]) <= 3
    assert cc["stencil5_affine"] > 0 and not any(ct.values())


def test_config3_k7_along_p_matches_cgs2(cuda_device):
    """Config 3's restarted GMRES(30) with ``Ml``, ``M`` and ``Mr`` at
    127^2 in float64 on the card: ``cgs2_pallas`` (K7 twice per iteration
    along the dual basis P) against ``cgs2`` (plain products), the same
    iterations and the correction to 1e-9."""
    nx = 127
    b = torch.ones(nx * nx, dtype=torch.float64, device=cuda_device)
    out = {}
    for ortho in ("cgs2_pallas", "cgs2"):
        solve, _ = suite.make_config3(nx, "torch", ortho, cuda_device,
                                      dtype=torch.float64)
        kernels.reset_launch_counts()
        out[ortho] = (solve.inner(b), kernels.launch_counts())
    (rk, ck), (rp, cp) = out["cgs2_pallas"], out["cgs2"]
    assert int(rk.niter) == int(rp.niter) > 0
    assert int(rk.status) == int(rp.status) == F.CONVERGED
    assert ck["cgs_project"] == 2 * int(rk.niter) and not any(cp.values())
    dx = torch.linalg.vector_norm(rk.x - rp.x) / torch.linalg.vector_norm(
        rp.x)
    assert float(dx) <= 1e-9


def k7_mesh_cases(mesh):
    """Rank side of :func:`test_gmres_cgs2_pallas_on_mesh`: GMRES with
    ``ortho="cgs2_pallas"`` on the mesh (K7's sharded form: K4, an
    all-reduce, K6 per pass), float64, against the single-device solve
    with the same scheme (K7) on the whole vector."""
    nx = 32
    A = ops.convection_diffusion_2d(nx, mesh=mesh, device=mesh.device)
    b_all = np.random.RandomState(5).randn(nx * nx)
    kw = dict(tol=1e-10, maxiter=200, ortho="cgs2_pallas")
    with mesh:
        kernels.reset_launch_counts()
        res = F.gmres(A, parallel.shard_vector(b_all, mesh),
                      Ml=ops.jacobi_preconditioner(A), **kw)
        counts = kernels.launch_counts()
    A1 = ops.convection_diffusion_2d(nx, device=mesh.device)
    one = F.gmres(A1, interop.from_numpy(b_all, mesh.device),
                  Ml=ops.jacobi_preconditioner(A1), **kw)
    x = parallel.gather_vector(res.x, mesh)
    return {"niter": np.array([int(res.niter), int(one.niter)]),
            "status": np.int64(int(res.status)),
            "dx": np.float64(float(torch.linalg.vector_norm(x - one.x)
                                   / torch.linalg.vector_norm(one.x))),
            "launches": np.array([counts["project_prefix"],
                                  counts["update_prefix"],
                                  counts["cgs_project"]]),
            "resnorms": interop.to_numpy(res.resnorms)}


def test_gmres_cgs2_pallas_on_mesh(cuda_device, tmp_path):
    """``gmres(ortho="cgs2_pallas")`` on 2 gloo ranks that share the card:
    the single-device iterations, the iterate to 1e-9, K4 and K6 twice per
    iteration on every rank and K7 itself never; the residual history the
    same bits on every rank."""
    from test_torch_parallel import run_ranks

    ranks = run_ranks(__file__, "k7_mesh_cases", 2, tmp_path,
                      device=str(cuda_device), backend="gloo")
    for r in ranks:
        n, n_one = r["niter"]
        assert n == n_one > 0 and int(r["status"]) == F.CONVERGED
        assert float(r["dx"]) <= 1e-9
        assert list(r["launches"]) == [2 * n, 2 * n, 0]
        assert r["resnorms"].tobytes() == ranks[0]["resnorms"].tobytes()


@pytest.mark.parametrize("nx,ny", [(96, 96), (1021, 1000)])
def test_k1_jvp_matches_plain(cuda_device, nx, ny):
    """K1's forward-mode rule on the card: ``torch.func.jvp`` through the
    kernel (two launches: the primal and the tangent, the second counted
    in ``kernels.tangent_counts()`` too) against ``torch.func.jvp`` of
    the plain version, at the stencil tolerance; and through the nls
    residual of config 5 on the kernel lane."""
    gen = torch.Generator(device=cuda_device).manual_seed(nx)
    x, v, g, gt = (torch.randn(nx * ny, generator=gen, device=cuda_device)
                   for _ in range(4))
    # a nonsymmetric stencil (upwind-like up/left coefficients)
    co = (5.5, -2.0, -1.0, -1.5, -1.0)

    def k1(u, gg):
        return kst.stencil5_affine(u, gg, nx=nx, ny=ny, coeffs=co,
                                   alpha=0.5, beta=-1.5)

    def plain(u, gg):
        return kst.stencil5_affine_torch(u.reshape(nx, ny),
                                         gg.reshape(nx, ny), co, nx, ny,
                                         0.5, -1.5).reshape(-1)

    before = kernels.launch_counts()
    tangents = kernels.tangent_counts()["stencil5_affine"]
    pk, tk = torch.func.jvp(k1, (x, g), (v, gt))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["stencil5_affine"] == before["stencil5_affine"] + 2
    assert kernels.tangent_counts()["stencil5_affine"] == tangents + 1
    for got, (a, b) in ((pk, (x, g)), (tk, (v, gt))):
        want, want64 = plain(a, b), plain(a.double(), b.double())
        np.testing.assert_allclose(interop.to_numpy(got),
                                   interop.to_numpy(want), rtol=2e-6,
                                   atol=fma_atol(want, want64))
    Fk, uk = ops.nls_residual_2d(nx, amplitude=3.0, impl="cuda",
                                 device=cuda_device)
    Fp, _ = ops.nls_residual_2d(nx, amplitude=3.0, device=cuda_device)
    if nx == ny:
        _, jk = torch.func.jvp(Fk, (uk,), (v,))
        _, jp = torch.func.jvp(Fp, (uk,), (v,))
        _, jp64 = torch.func.jvp(Fp, (uk.double(),), (v.double(),))
        np.testing.assert_allclose(interop.to_numpy(jk),
                                   interop.to_numpy(jp), rtol=2e-6,
                                   atol=fma_atol(jp, jp64))


def test_config5_newton_step_on_kernel_lane(cuda_device):
    """One Newton step of config 5 at 96^2 with recycled Jacobian solves,
    kernel lane against plain lane: the same inner iterations within 3,
    the residuals within 1e-2 relative, and K1 launched once per call of
    F and once more per Jacobian action's tangent, nothing else.  The
    step's ``||F||`` is the float32 GMRES residual at the forcing term
    0.1 after ~34 iterations, which K1's rounding (FMA) moves: 467.30
    against 468.26 on the H100 (0.2%)."""
    out = {}
    for impl in ("cuda", "torch"):
        func, _ = ops.nls_residual_2d(96, amplitude=3.0, impl=impl,
                                      device=cuda_device)
        calls = {"F": 0}

        def counted(u, func=func, calls=calls):
            calls["F"] += 1
            return func(u)

        rec = suite._counting(F.RecyclingGmres)(3, "sm", hermitian=True)
        kernels.reset_launch_counts()
        res = F.newton_krylov(counted, torch.zeros(96 * 96,
                                                   device=cuda_device),
                              tol=1e-5, maxiter=1, inner_maxiter=250,
                              recycling_solver=rec, warmup=True)
        torch.cuda.synchronize()
        out[impl] = (res, calls["F"], rec.jvp_calls,
                     kernels.launch_counts(),
                     kernels.tangent_counts()["stencil5_affine"])
    (rk, fk, jk, ck, tk), (rp, _, _, cp, tp) = out["cuda"], out["torch"]
    assert rk.niter == rp.niter == 1
    assert abs(int(rk.inner_history[0]) - int(rp.inner_history[0])) <= 3
    np.testing.assert_allclose(rk.resnorms, rp.resnorms, rtol=1e-2)
    assert ck["stencil5_affine"] == fk + jk
    assert tk == jk > int(rk.inner_history[0])
    assert all(v == 0 for k, v in ck.items() if k != "stencil5_affine")
    assert all(v == 0 for v in cp.values()) and tp == 0


@pytest.mark.parametrize("lane", ["cg_1r", "gmres_cgs2_1r",
                                  "gmres_cgs2_1r_M", "gmres_bmgs2"])
def test_one_reduce_lane_on_the_card(cuda_device, lane):
    """The one-reduce lane in float64 on the card against the same solve
    on the CPU: equal counts and status, residual histories and iterates
    to 1e-12 relative (the final explicit residual, at the round-off
    floor, to 1e-13 absolute)."""
    nx = 31
    b = np.random.default_rng(0).standard_normal(nx * nx)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        A = ops.poisson_2d(nx, device=dev)
        bb = interop.from_numpy(b, dev)
        if lane == "cg_1r":
            res = F.cg(A, bb, M=ops.jacobi_preconditioner(A), tol=1e-8,
                       maxiter=300, variant="1r")
        else:
            kw = dict(M=ops.jacobi_preconditioner(A)) \
                if lane.endswith("_M") else {}
            res = F.gmres(A, bb, tol=1e-8, maxiter=60,
                          ortho=lane.split("_", 1)[1].removesuffix("_M"),
                          **kw)
        runs.append(res)
    rc, rh = runs
    assert int(rc.niter) == int(rh.niter) and int(rc.status) == \
        int(rh.status)
    np.testing.assert_allclose(interop.to_numpy(rc.resnorms),
                               interop.to_numpy(rh.resnorms), rtol=1e-12,
                               atol=1e-13)
    xc, xh = interop.to_numpy(rc.x), interop.to_numpy(rh.x)
    assert np.linalg.norm(xc - xh) <= 1e-12 * np.linalg.norm(xh)


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_1r"])
def test_bf16_basis_on_the_card(cuda_device, ortho):
    """A bfloat16 basis on the card (its products upcast to float32, no
    reduced-precision bfloat16 reduction) against the CPU port on
    tests/test_bf16_basis.py's kappa = 50 system: all 40 iterations, the
    true residual below 5e-2 on both, within a factor 2 of each other,
    the float32 basis strictly better on the card."""
    d = np.linspace(1.0, 50.0, 512)
    b = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    assert not torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction

    def true_rel(x):
        x = interop.to_numpy(x).astype(np.float64)
        return np.linalg.norm(b - d * x) / np.linalg.norm(b)

    rels = []
    for dev in (cuda_device, torch.device("cpu")):
        D = torch.tensor(d, dtype=torch.float32, device=dev)
        res, ints = F.gmres(lambda v: D * v, interop.from_numpy(b, dev),
                            tol=0.0, maxiter=40, ortho=ortho,
                            basis_dtype=torch.bfloat16, return_internal=True)
        assert ints["V"].dtype == torch.bfloat16 and int(res.niter) == 40
        rels.append(true_rel(res.x))
    D = torch.tensor(d, dtype=torch.float32, device=cuda_device)
    full = F.gmres(lambda v: D * v, interop.from_numpy(b, cuda_device),
                   tol=0.0, maxiter=40, ortho=ortho)
    assert max(rels) < 5e-2 and 0.5 < rels[0] / rels[1] < 2.0
    assert true_rel(full.x) < rels[0]


# ---------------------------------------------------------------------------
# the reference-compatible lane (linsys, deflation, the one-call functions)
# and the JAX package's keywords
# ---------------------------------------------------------------------------

_COMPAT_GOLDEN = {
    "cg": (1004.1873775173957, 1000.0003174916551, 999.9999999997555),
    "gmres": (1004.1873724888546, 1000.0003124630923, 999.999994971191),
    "minres": (1004.187372488912, 1000.0003124632159, 999.9999949713145),
}


@pytest.mark.parametrize("method", sorted(_COMPAT_GOLDEN))
def test_compat_goldens_on_the_card(cuda_device, method):
    """The one-call functions on the README system, numpy in: the
    solution is a CUDA tensor of b's shape with BASELINE.md's goldens to
    1e-11."""
    import krypy_tpu_torch

    A = np.diag([1.0e-3] + list(range(2, 101)))
    b = np.ones(100)
    sol, _ = getattr(krypy_tpu_torch, method)(A, b,
                                              inner_product=torch.dot)
    assert sol.is_cuda and tuple(sol.shape) == b.shape
    x = interop.to_numpy(sol)
    got = (np.sum(np.abs(x)), np.sqrt(x @ x), np.max(np.abs(x)))
    for g, r in zip(got, _COMPAT_GOLDEN[method]):
        assert abs(g - r) < 1e-11 * r


def _compat_run(cls, ls, **kw):
    from krypy_tpu_torch.errors import ConvergenceError

    try:
        return cls(ls, **kw)
    except ConvergenceError as exc:
        return exc.solver


@pytest.mark.parametrize("name", ["Cg", "Gmres"])
def test_compat_lane_through_k1_matches_plain(cuda_device, name):
    """``linsys.Cg`` and ``linsys.Gmres`` on a 255^2 Laplacian with the
    unpadded V-cycle, float32: through K1 (``impl="cuda"``) and on the
    plain operators, equal iterations to 1e-4; at a fixed count of
    steps the kernel lane's x within the FMA rule of the plain lane's
    (against the plain lane in float64)."""
    from krypy_tpu_torch import linsys

    nx = 255
    cls = getattr(linsys, name)
    flags = dict(self_adjoint=True, positive_definite=True)
    slot = "M" if name == "Cg" else "Ml"
    runs = {}
    for impl in ("cuda", "torch"):
        A = ops.poisson_2d(nx, impl=impl, device=cuda_device)
        P = ops.multigrid_poisson_preconditioner(nx, coarsest=31,
                                                 impl=impl,
                                                 device=cuda_device)
        P.shape = A.shape
        for dt in (torch.float32, torch.float64):
            b = torch.ones(nx * nx, dtype=dt, device=cuda_device)
            ls = linsys.LinearSystem(A, b, **{slot: P}, **flags)
            kernels.reset_launch_counts()
            conv = _compat_run(cls, ls, tol=1e-4, maxiter=50)
            fixed = _compat_run(cls, ls, tol=0.0, maxiter=6)
            runs[impl, dt] = (len(conv.resnorms) - 1,
                              fixed.xk[:, 0].double(),
                              kernels.launch_counts())
    (kc, xk, lk), (pc, xp, lp) = runs["cuda", torch.float32], \
        runs["torch", torch.float32]
    assert kc == pc and lk["stencil5_affine"] > 0
    assert not any(lp.values())
    want64 = runs["torch", torch.float64][1]
    torch.testing.assert_close(xk, xp, rtol=2e-6,
                               atol=fma_atol(xp, want64))


def test_compat_deflated_cg_on_the_card(cuda_device):
    """``deflation.DeflatedCg`` with U through K1 against its plain lane:
    equal iterations, the same iterate to 1e-5, E and C on the card."""
    from krypy_tpu_torch import deflation, linsys

    nx = 63
    rng = np.random.default_rng(3)
    U = rng.standard_normal((nx * nx, 2)).astype(np.float32)
    out = {}
    for impl in ("cuda", "torch"):
        A = ops.poisson_2d(nx, impl=impl, device=cuda_device)
        d = A.diag.float()
        ls = linsys.LinearSystem(
            A, torch.ones(nx * nx, device=cuda_device),
            M=ops.diagonal(1.0 / d), Minv=ops.diagonal(d),
            self_adjoint=True, positive_definite=True)
        kernels.reset_launch_counts()
        sol = _compat_run(deflation.DeflatedCg, ls, U=U, tol=1e-4,
                          maxiter=300, store_arnoldi=True)
        out[impl] = (sol, kernels.launch_counts())
    (sk, lk), (sp, lp) = out["cuda"], out["torch"]
    assert len(sk.resnorms) == len(sp.resnorms)
    assert sk.xk.is_cuda and sk.E.is_cuda and sk.C.is_cuda
    assert lk["stencil5_affine"] > 0 and not any(lp.values())
    assert float(torch.linalg.vector_norm(sk.xk - sp.xk)) <= \
        1e-5 * float(torch.linalg.vector_norm(sp.xk))


def test_numpy_operands_land_on_the_card(cuda_device):
    """The functional solvers with numpy ``A``, ``M``, ``ip``, ``b`` and
    ``x0``: ``b`` goes to the card, the rest to ``b``'s device."""
    d = np.linspace(1.0, 8.0, 8)
    kw = dict(M=np.diag(1.0 / np.sqrt(d)), ip=np.diag(np.linspace(1, 2, 8)),
              x0=np.zeros(8), tol=1e-10)
    for solver in (F.cg, F.minres, F.gmres):
        res = solver(np.diag(d), np.ones(8), **kw)
        assert res.x.is_cuda and int(res.status) == F.CONVERGED
        np.testing.assert_allclose(interop.to_numpy(res.x), 1.0 / d,
                                   rtol=1e-9)


def test_jax_tile_keywords_launch_the_kernels(cuda_device):
    """The entries take the JAX package's tile keywords (ignored) and
    launch their kernels; ``interpret=True`` runs the plain version and
    launches nothing."""
    rng = np.random.default_rng(9)
    x, R, P = _padded_noise(rng, 9, 120, cuda_device)
    kw = dict(nx=R, ny=P, coeffs=(4.0, -1.0, -1.0, -1.0, -1.0), ncols=120,
              nrows=9)
    kernels.reset_launch_counts()
    y = kernels.stencil5_affine(x, block_rows=64, interpret=False, **kw)
    assert kernels.launch_counts()["stencil5_affine"] == 1
    kernels.reset_launch_counts()
    yp = kernels.stencil5_affine(x, block_rows=64, interpret=True, **kw)
    assert not any(kernels.launch_counts().values())
    torch.testing.assert_close(y, yp, rtol=2e-6, atol=fma_atol(
        yp, kst.stencil5_affine_torch(x.double().view(R, P), None,
                                      kw["coeffs"], 9, 120).reshape(-1)))
    V = torch.randn(8, 4096, device=cuda_device)
    w = torch.randn(4096, device=cuda_device)
    kernels.reset_launch_counts()
    korth.project_prefix(V, w, torch.ones(8, device=cuda_device), rows=4,
                         block_n=512)
    korth.cgs_project(V, w, torch.ones(8, device=cuda_device),
                      block_n=512)
    lap = kernels.laplacian_2d(64, 64, 256, False, device=cuda_device)
    lap(torch.ones(64 * 64, device=cuda_device))
    counts = kernels.launch_counts()
    assert counts["project_prefix"] == 1 and counts["cgs_project"] == 1
    assert counts["stencil5_affine"] == 1


def test_init_distributed_jax_keywords_on_nccl(cuda_device):
    """A one-rank NCCL world joined with the JAX package's keywords
    (``coordinator_address="host:port"``, ``num_processes``,
    ``process_id``), and an all-reduce on the card."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    parallel.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                              num_processes=1, process_id=0,
                              backend="nccl", timeout=60)
    try:
        mesh = parallel.make_mesh(1, device=cuda_device)
        s = parallel.all_reduce_sum(torch.ones(3, device=cuda_device), mesh)
        assert s.is_cuda and s.tolist() == [1.0, 1.0, 1.0]
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the recycling lane (KryPy's recycling API) on the card
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py, whose recycle phase runs the same battery: one copy
    of its sequences and gates."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("which", ["lm", "sm", "lr", "sr", "li", "si",
                                   "smallest_res"])
@pytest.mark.parametrize("solver", ["RecyclingCg", "RecyclingMinres",
                                    "RecyclingGmres"])
def test_recycling_battery_on_the_card(cuda_device, solver, which):
    """The battery of the recycle phase (a), through chip_smoke.py's
    ``_rc_battery_case``: tests/test_recycling.py's sequence from numpy
    on the card, every recomputed final residual finite and at most tol,
    no later solve longer than the first, the iterations per solve
    within 1 of the port's CPU run of the same sequence."""
    import warnings

    cs = _chip_smoke()
    case = next(c for c in cs._rc_battery_cases()
                if c[0] == f"{solver} {which}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        record = cs._rc_battery_case(case, None)
    assert record["card"]["xk_device"] == ["cuda"] * 3


def test_k1_transpose_against_plain_reverse_mode(cuda_device):
    """``northstar.cd_transpose`` (K1 on the swapped coefficients, float32)
    against the float64 reverse-mode transpose of the plain padded
    operator on the logical grid, within the stencil tolerance; K1
    itself has no reverse mode."""
    from krypy_tpu_torch.northstar import cd_transpose

    nx = 255
    h2 = (1.0 / (nx + 1)) ** 2
    plain = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                        pad_cols=True, impl="torch",
                                        device=cuda_device)
    x = ops.pad_grid_vec(torch.randn(nx * nx, dtype=torch.float64,
                                     device=cuda_device), nx, nx)
    want = F.transpose_matvec(plain, x.shape[0], torch.float64,
                              device=cuda_device)(x)
    kernels.reset_launch_counts()
    got = cd_transpose(nx, "cuda")(x.float())
    assert kernels.launch_counts()["stencil5_affine"] == 1
    g, w = (ops.unpad_grid_vec(v, nx, nx).double() for v in (got, want))
    assert float(torch.max(torch.abs(g - w))) <= 1e-5 * float(
        torch.max(torch.abs(w)))
    k1 = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                     pad_cols=True, impl="cuda",
                                     device=cuda_device)
    with pytest.raises(NotImplementedError, match="AT="):
        F.transpose_matvec(k1, x.shape[0], torch.float32,
                           device=cuda_device)(x.float())


@pytest.mark.parametrize("label", ["bicgstab", "tfqmr", "idrs", "fgmres",
                                   "qmr"])
def test_nonsym_north_star_on_the_card(cuda_device, label):
    """``northstar.make_nonsym`` at 511^2 through K1-K3 against its plain
    lane: both to 1e-8, the same refinement cycles, K2 and K3 launched
    and none on the plain lane."""
    from krypy_tpu_torch.northstar import make_nonsym

    nx = 511
    b = torch.ones(nx * nx, dtype=torch.float64, device=cuda_device)
    runs = {}
    for impl in ("cuda", "torch"):
        solve, cd64 = make_nonsym(nx, impl, label, cuda_device)
        kernels.reset_launch_counts()
        res, info = solve(b, warm=False)
        rel = float(torch.linalg.vector_norm(b - cd64(res.x))
                    / torch.linalg.vector_norm(b))
        runs[impl] = (info, rel, kernels.launch_counts())
    (ik, rk, lk), (it, rt, lt) = runs["cuda"], runs["torch"]
    assert rk <= 1e-8 and rt <= 1e-8
    assert ik["cycles"] == it["cycles"]
    assert lk["stencil5_jacobi2"] > 0 and lk["stencil5_resrestrict_rows"] > 0
    assert not any(lt.values())


def _eigen_lanes(run):
    """``run(impl) -> result`` on both lanes with the launches counted;
    returns ``{impl: (result, launches)}`` (the plain lane launches
    nothing)."""
    out = {}
    for impl in ("cuda", "torch"):
        kernels.reset_launch_counts()
        res = run(impl)
        torch.cuda.synchronize()
        out[impl] = (res, {k: c for k, c in kernels.launch_counts().items()
                           if c})
    assert not out["torch"][1]
    return out


@pytest.mark.parametrize("entry", ["eigsh", "lobpcg", "eigs"])
def test_numpy_matrix_solves_on_the_card(cuda_device, entry):
    """A numpy ``A`` with no start: the solve runs on the current CUDA
    device, as a numpy right-hand side does."""
    A = np.diag(np.arange(1.0, 41.0))
    r = getattr(F, entry)(A, 2, tol=1e-9)
    assert r.U.device == cuda_device
    assert int(r.status) == 0
    np.testing.assert_allclose(np.sort(np.real(r.theta.cpu().numpy())),
                               [39.0, 40.0] if entry == "eigs" else
                               [1.0, 2.0], rtol=1e-8)


def test_eigsh_shift_invert_on_the_card(cuda_device):
    """eigsh's shift-invert block Lanczos at 255^2 through
    ``eigen.poisson_inverse`` (K1-K3, the coarse form): the 6 smallest
    pairs to the closed form on both lanes; on the kernel lane the coarse
    form once per V-cycle and K1 at least once per float32 operator
    application and V-cycle (the chip smoke's eigen phase holds every
    kernel to its exact count)."""
    from krypy_tpu_torch import eigen

    nx = 255
    counts = {}

    def run(impl):
        inv, A, c = eigen.poisson_inverse(nx, impl, cuda_device)
        counts[impl] = c
        return F.eigsh(A, 6, sigma=0.0, inv=inv, block_size=2, tol=1e-8)

    out = _eigen_lanes(run)
    want = [v for v, _, _ in eigen.poisson_eigenvalues(nx, 6)]
    for impl, (r, launches) in out.items():
        assert r.converged
        np.testing.assert_allclose(np.sort(r.theta.cpu().numpy()), want,
                                   rtol=1e-8)
    c, launches = counts["cuda"], out["cuda"][1]
    assert launches["stencil5_coarse"] == c["M"]
    assert launches["stencil5_affine"] >= c["A"] + c["M"]


def test_lobpcg_vcycle_on_the_card(cuda_device):
    """LOBPCG with ``eigen.poisson_vcycle`` at 255^2: the closed form on
    both lanes, the coarse form launched once per V-cycle."""
    from krypy_tpu_torch import eigen

    nx = 255
    counts = {}

    def run(impl):
        M, c = eigen.poisson_vcycle(nx, impl, cuda_device)
        counts[impl] = c
        return F.lobpcg(ops.poisson_2d(nx, device=cuda_device), 6, M=M,
                        tol=1e-7)

    out = _eigen_lanes(run)
    want = [v for v, _, _ in eigen.poisson_eigenvalues(nx, 6)]
    for impl, (r, _) in out.items():
        assert r.converged
        np.testing.assert_allclose(r.theta.cpu().numpy(), want, rtol=1e-8)
    assert out["cuda"][1]["stencil5_coarse"] == counts["cuda"]["M"]


def test_eigs_northstar_inverse_on_the_card(cuda_device):
    """Krylov-Schur with ``eigen.northstar_inverse`` at 127^2 (K1-K6): the
    4 eigenvalues nearest 0 of the north star's operator to the closed
    form on both lanes; K4, K5 and K6 one each per GMRES iteration."""
    from krypy_tpu_torch import eigen

    nx = 127
    counts = {}

    def run(impl):
        inv, A, c = eigen.northstar_inverse(nx, impl, cuda_device)
        counts[impl] = c
        return F.eigs(A, 4, sigma=0.0, inv=inv, tol=1e-8)

    out = _eigen_lanes(run)
    want = [v for v, _, _ in eigen.cd_eigenvalues(nx, 4)]
    for impl, (r, _) in out.items():
        assert r.status == 0
        th = r.theta.cpu().numpy()
        np.testing.assert_allclose(np.sort(th.real), want, rtol=1e-7)
    iters = sum(n for cyc in counts["cuda"]["gmres_niters"] for n in cyc)
    for name in ("project_prefix", "apply_project", "update_prefix"):
        assert out["cuda"][1][name] == iters


def test_filtered_lane_on_the_card(cuda_device):
    """eigsh_window, window_count (a CUDA generator) and kpm_dos on the
    card at 63^2 in float64 (the plain stencil: no kernel launches)."""
    from krypy_tpu_torch import eigen

    nx = 63
    A = ops.poisson_2d(nx, impl="cuda", device=cuda_device)
    window, inside, bounds = eigen.poisson_window(nx)
    kernels.reset_launch_counts()
    r = F.eigsh_window(A, window, block=8, degree=200, bounds=bounds,
                       tol=1e-10, maxiter=40)
    assert r.converged and int(r.n_inside) == 3
    np.testing.assert_allclose(np.sort(r.theta[:3].cpu().numpy()),
                               np.sort(inside), rtol=1e-10)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    cnt, se = F.window_count(A, window, gen, bounds=bounds, degree=200,
                             n_probes=24)
    assert abs(cnt - 3) <= max(4 * se, 0.36)
    grid, dens = F.kpm_dos(A, 5, bounds=bounds)
    assert abs(np.trapezoid(dens, grid) / (nx * nx) - 1) <= 0.05
    assert not any(kernels.launch_counts().values())


def complex_fused_mesh_cases(mesh):
    """Rank side of :func:`test_complex_cgs2_fused_on_mesh`: a complex
    rank-local block system solved with ``ortho="cgs2_fused"`` under the
    mesh, against the one-device solve with the same two plain passes
    (``ortho="cgs2"``; the one-device ``cgs2_fused`` raises on a complex
    basis, as K4 takes float32 and float64 only); then a real float32
    ``cgs2_fused`` solve on the mesh, whose iterations launch K9's K4-K6."""
    N, P = 64, mesh.size
    step = N // P
    rng = np.random.RandomState(6)
    M = np.diag(1.0 + 3.0 * rng.rand(N)).astype(complex)
    for i in range(N - 1):
        if i // step == (i + 1) // step:
            M[i, i + 1] = 0.5 + 0.25j
    b_all = rng.randn(N) + 1j * rng.randn(N)
    blk = parallel.block_of(N, mesh)
    A_blk = torch.tensor(M[blk, blk], device=mesh.device)
    kw = dict(tol=1e-10, maxiter=N)
    with mesh:
        kernels.reset_launch_counts()
        res = F.gmres(lambda v: A_blk @ v, parallel.shard_vector(b_all, mesh),
                      ortho="cgs2_fused", **kw)
        complex_launches = sum(kernels.launch_counts().values())
    one = F.gmres(torch.tensor(M, device=mesh.device),
                  interop.from_numpy(b_all, mesh.device), ortho="cgs2", **kw)
    x = parallel.gather_vector(res.x, mesh)
    A = ops.poisson_2d(32, impl="cuda", mesh=mesh, device=mesh.device)
    b32 = parallel.shard_vector(np.ones(32 * 32, dtype=np.float32), mesh)
    with mesh:
        kernels.reset_launch_counts()
        real = F.gmres(A, b32, tol=1e-4, maxiter=40, ortho="cgs2_fused")
        counts = kernels.launch_counts()
    return {"niter": np.array([int(res.niter), int(one.niter)]),
            "status": np.int64(int(res.status)),
            "dx": np.float64(float(torch.linalg.vector_norm(x - one.x)
                                   / torch.linalg.vector_norm(one.x))),
            "complex_launches": np.int64(complex_launches),
            "real_niter": np.int64(int(real.niter)),
            "real_k9": np.array([counts["project_prefix"],
                                 counts["apply_project"],
                                 counts["update_prefix"]]),
            "resnorms": interop.to_numpy(res.resnorms)}


def test_complex_cgs2_fused_on_mesh(cuda_device, tmp_path):
    """``gmres(ortho="cgs2_fused")`` on a complex system on 2 gloo ranks
    that share the card: it solves (two plain passes over the active rows,
    the JAX package's jnp sweep, where K9 takes real bases only) with the
    one-device iterations and the iterate to 1e-9, launching no kernel; a
    real float32 ``cgs2_fused`` solve on the same mesh still launches
    K4, K5 and K6 once per iteration."""
    from test_torch_parallel import run_ranks

    ranks = run_ranks(__file__, "complex_fused_mesh_cases", 2, tmp_path,
                      device=str(cuda_device), backend="gloo")
    for r in ranks:
        n, n_one = r["niter"]
        assert n == n_one > 0 and int(r["status"]) == F.CONVERGED
        assert float(r["dx"]) <= 1e-9
        assert int(r["complex_launches"]) == 0
        assert list(r["real_k9"]) == [int(r["real_niter"])] * 3
        assert r["resnorms"].tobytes() == ranks[0]["resnorms"].tobytes()


def test_complex_cgs2_fused_on_one_card_raises(cuda_device):
    """On one device the JAX package sends a complex ``cgs2_fused`` basis
    to its kernels too (no other route than its VMEM fit check); the port's
    K4 takes float32 and float64 only, and raises rather than giving
    way."""
    A = torch.eye(8, dtype=torch.complex128, device=cuda_device)
    b = torch.ones(8, dtype=torch.complex128, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or"):
        F.gmres(A, b, ortho="cgs2_fused", maxiter=4)


def _lane_pair(run):
    """``run(impl)`` on the kernel and the plain lane, launches counted."""
    out = {}
    for impl in ("cuda", "torch"):
        kernels.reset_launch_counts()
        res = run(impl)
        torch.cuda.synchronize()
        out[impl] = (res, dict(kernels.launch_counts()))
    assert not any(out["torch"][1].values())
    return out


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_lsq_north_star_on_the_card(cuda_device, solver):
    """``lsqr``/``lsmr`` on the north star's float32 operator at 255^2
    through K1 with ``Ah = northstar.cd_transpose`` (K1 on the swapped
    coefficients): both lanes converge, within 3 iterations of each other,
    two K1 launches per iteration and per start and check."""
    from krypy_tpu_torch.northstar import cd_transpose

    nx, damp = 255, 0.1
    h2 = (1.0 / (nx + 1)) ** 2
    b = ops.pad_grid_vec(torch.ones(nx * nx, device=cuda_device), nx, nx)

    def run(impl):
        A = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                        pad_cols=True, impl=impl,
                                        device=cuda_device)
        return getattr(F, solver)(A, b, Ah=cd_transpose(nx, impl),
                                  damp=damp, tol=1e-5, maxiter=2000)

    out = _lane_pair(run)
    (rk, lk), (rt, _) = out["cuda"], out["torch"]
    assert int(rk.status) == int(rt.status) == F.CONVERGED
    assert abs(int(rk.niter) - int(rt.niter)) <= 3
    assert lk["stencil5_affine"] >= 2 * int(rk.niter) + 2
    assert rk.x.device == cuda_device


def test_randomized_lane_on_the_card(cuda_device):
    """rsvd, svds, hutchpp and the Nystrom preconditioner on bench.py's
    float32 Poisson operator at 31^2 through K1, draws from a CUDA
    generator: svds on the closed form of the largest eigenvalues, rsvd
    by interlacing, hutchpp within 5 standard errors of the exact trace,
    and the Nystrom-preconditioned CG converged."""
    from krypy_tpu_torch import eigen

    nx, k = 31, 6
    N = nx * nx
    A = ops.poisson_2d(nx, impl="cuda", device=cuda_device)
    want = np.array([v for v, _, _ in
                     eigen.poisson_eigenvalues(nx, k, largest=True)])
    kernels.reset_launch_counts()
    r = F.svds(A, k=k, Ah=A, tol=1e-4, maxiter=2000)
    assert r.converged and r.U.device == cuda_device
    np.testing.assert_allclose(r.s.cpu().numpy(), want, rtol=1e-5)
    q = F.rsvd(A, k, Ah=A, n=N, seed=0)
    assert np.all(q.s.cpu().numpy() <= want * (1 + 1e-5))
    est, se = F.hutchpp(A, 0, n=N, k=16, n_probes=32)
    assert abs(float(est) - N * 4.0 * (nx + 1) ** 2) <= 5 * float(se)
    # mu = 1e-2 lambda_max and tol 1e-4, as the card's lsq phase: below
    # the float32 floor the preconditioned CG ends in NaN (ROADMAP.md C)
    mu = 1e-2 * 8.0 * (nx + 1) ** 2
    P = F.nystrom_preconditioner(A, 20, N, mu=mu, seed=0)
    b = torch.ones(N, dtype=torch.float32, device=cuda_device)
    res = F.cg(lambda v: A(v) + mu * v, b, M=P, tol=1e-4, maxiter=2000)
    assert res.converged
    assert kernels.launch_counts()["stencil5_affine"] > 0


def test_shifted_lane_on_the_card(cuda_device):
    """arnoldi (cgs2, cgs2_1r), shifted_cg (classic, 1r) and shifted_gmres
    on float32 operators through K1 at 255^2: the relation's residual, every
    member's true residual recomputed in float64."""
    nx = 255
    N = nx * nx
    A = ops.poisson_2d(nx, impl="cuda", device=cuda_device)
    A64 = ops.poisson_2d(nx, device=cuda_device)
    b = torch.ones(N, dtype=torch.float32, device=cuda_device)
    for ortho in ("cgs2", "cgs2_1r"):
        rel = F.arnoldi(A, b, maxiter=20, ortho=ortho)
        n = int(rel.niter)
        V = rel.V[: n + 1].double()
        AV = torch.stack([A64(v) for v in V[:n]])
        err = torch.linalg.matrix_norm(AV - rel.H[: n + 1, :n].double().T @ V)
        assert float(err) <= 1e-5 * 8 * (nx + 1) ** 2 * math.sqrt(n)
    # the shifted phase's shifts and tol: each member's kappa <= ~100,
    # whose float32 floor lies below tol
    shifts = 8.0 * (nx + 1) ** 2 * np.geomspace(1e-2, 1e-1, 8)
    for variant in ("classic", "1r"):
        r = F.shifted_cg(A, b, shifts, tol=1e-4, maxiter=3000,
                         variant=variant)
        assert bool((r.status == F.CONVERGED).all())
        for i, s in enumerate(shifts):
            x = r.X[i].double()
            res = b.double() - A64(x) - s * x
            assert float(torch.linalg.vector_norm(res)
                         / torch.linalg.vector_norm(b.double())) <= 2e-4
    kernels.reset_launch_counts()
    g = F.shifted_gmres(A, b, shifts, maxiter=60, tol=1e-4)
    assert kernels.launch_counts()["stencil5_affine"] == int(g.niter)
    assert bool((g.status == F.CONVERGED).all())


def test_chebyshev_lane_on_the_card(cuda_device):
    """``chebyshev`` with the padded V-cycle on bench.py's float32 Poisson
    at 255^2 through K1-K3 (bounds from ``spectral_bounds``), and
    ``ops.chebyshev_preconditioner`` as CG's ``M``: the true residual
    recomputed in float64, one V-cycle per step, fewer CG iterations than
    plain CG, one K1 per operator application."""
    from krypy_tpu_torch import eigen

    nx = 255
    A = ops.poisson_2d(nx, pad_cols=True, impl="cuda", device=cuda_device)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        device=cuda_device)
    A64 = ops.poisson_2d(nx, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        nx * nx)).to(cuda_device)
    b = ops.pad_grid_vec(A64(x), nx, nx).float()
    lo, hi = F.spectral_bounds(A, b, M=M)
    kernels.reset_launch_counts()
    r = F.chebyshev(A, b, M=M, lmin=lo, lmax=hi, tol=1e-5, check_every=8)
    assert r.converged and r.x.device == cuda_device
    assert kernels.launch_counts()["stencil5_coarse"] == 1 + int(r.niter)
    xs = ops.unpad_grid_vec(r.x, nx, nx).double()
    bs = ops.unpad_grid_vec(b, nx, nx).double()
    assert float(torch.linalg.vector_norm(bs - A64(xs))
                 / torch.linalg.vector_norm(bs)) <= 1e-5
    lmin = eigen.poisson_eigenvalues(nx, 1)[0][0]
    P = ops.chebyshev_preconditioner(A, degree=8, lmin=lmin)
    rhs = ops.pad_grid_vec(torch.randn(nx * nx, device=cuda_device), nx, nx)
    plain = F.cg(A, rhs, tol=1e-3, maxiter=3000)
    kernels.reset_launch_counts()
    pre = F.cg(A, rhs, M=P, tol=1e-3, maxiter=3000)
    assert pre.converged and int(pre.niter) < int(plain.niter)
    assert kernels.launch_counts()["stencil5_affine"] >= 7 * int(pre.niter)


def test_funm_lane_on_the_card(cuda_device):
    """``expm_multiply`` and ``inv_sqrt_multiply`` of the float32 Poisson
    operator at 127^2 through K1 against their DST closed forms,
    ``slq_logdet`` within 5 standard errors of the exact sum, the Arnoldi
    ``expm_multiply`` of the north star's operator against its float64
    run."""
    import scipy.fft

    from krypy_tpu_torch import eigen

    nx = 127
    A = ops.poisson_2d(nx, impl="cuda", device=cuda_device)
    h = 1.0 / (nx + 1)
    lam1 = 4.0 / h ** 2 * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
    lam = lam1[:, None] + lam1[None, :]
    bh = np.random.default_rng(17).standard_normal(nx * nx).astype(
        np.float32)
    B = scipy.fft.dstn(bh.reshape(nx, nx).astype(np.float64), type=1,
                       norm="ortho")
    b = torch.from_numpy(bh).to(cuda_device)
    t = 20.0 / lam.max()

    def err(x, hat):
        want = scipy.fft.idstn(hat, type=1, norm="ortho").reshape(-1)
        return np.linalg.norm(x.double().cpu().numpy() - want) / \
            np.linalg.norm(want)

    kernels.reset_launch_counts()
    r = F.expm_multiply(A, b, -t, maxdim=30)
    assert kernels.launch_counts()["stencil5_affine"] == 30
    assert err(r.x, np.exp(-t * lam) * B) <= 1e-4
    x, _ = F.inv_sqrt_multiply(A, b, lmin=float(lam.min()),
                               lmax=float(lam.max()), tol=1e-4)
    assert err(x, B / np.sqrt(lam)) <= 1e-3
    est, se = F.slq_logdet(A, 17, n_probes=16, maxdim=30)
    assert abs(float(est) - np.sum(np.log(lam))) <= 5 * float(se)
    h2 = h * h
    kw = dict(wind=(h2, 0.5 * h2), eps=h2, pad_cols=True, device=cuda_device)
    cd = ops.convection_diffusion_2d(nx, impl="cuda", **kw)
    cd64 = ops.convection_diffusion_2d(nx, **kw)
    v = ops.pad_grid_vec(b, nx, nx)
    got = F.expm_multiply(cd, v, -1.0, hermitian=False, maxdim=30).x
    want = F.expm_multiply(cd64, v.double(), -1.0, hermitian=False,
                           maxdim=30).x
    assert float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want)) <= 1e-4


def test_block_lane_on_the_card(cuda_device):
    """``block_cg`` with the padded V-cycle on bench.py's Poisson and
    ``block_gmres`` (V-cycle as ``Ml``) on the north star's operator at
    255^2, float32 through K1-K3: per-column backward errors in float64,
    k K1 launches per step."""
    nx = 255
    N = nx * nx
    A = ops.poisson_2d(nx, pad_cols=True, impl="cuda", device=cuda_device)
    A64 = ops.poisson_2d(nx, device=cuda_device)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        device=cuda_device)
    cols = [torch.ones(N), torch.linspace(0.0, 1.0, N)]
    B = torch.stack([ops.pad_grid_vec(c.to(cuda_device), nx, nx)
                     for c in cols], 1)
    r = F.block_cg(A, B, M=M, tol=1e-5, maxiter=100)
    assert r.converged and r.x.shape == B.shape
    for j in range(2):
        xj = ops.unpad_grid_vec(r.x[:, j], nx, nx).double()
        bj = cols[j].double().to(cuda_device)
        eta = torch.linalg.vector_norm(bj - A64(xj)) / (
            8.0 * (nx + 1) ** 2 * torch.linalg.vector_norm(xj)
            + torch.linalg.vector_norm(bj))
        assert float(eta) <= 1e-5
    h2 = 1.0 / (nx + 1) ** 2
    kw = dict(wind=(h2, 0.5 * h2), eps=h2, pad_cols=True, device=cuda_device)
    cd = ops.convection_diffusion_2d(nx, impl="cuda", **kw)
    Ml = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        scale=1.0 / h2, device=cuda_device)
    kernels.reset_launch_counts()
    g = F.block_gmres(cd, B, Ml=Ml, tol=1e-5, maxiter=40)
    assert g.converged
    assert kernels.launch_counts()["stencil5_coarse"] == 2 * (
        int(g.niter) + 1)


def test_sketch_lane_on_the_card(cuda_device):
    """``sketched_gmres``/``restarted_sketched_gmres`` (V-cycle as ``M``)
    and ``sketched_eigs`` on the north star's operator at 255^2 through
    K1-K3, the sketch drawn on the card: the float64 true residual of
    ``b = A x*``, the distortion certificate, the pairs' residuals
    recomputed in float64 against the reported ones."""
    nx = 255
    h2 = 1.0 / (nx + 1) ** 2
    kw = dict(wind=(h2, 0.5 * h2), eps=h2, pad_cols=True, device=cuda_device)
    A = ops.convection_diffusion_2d(nx, impl="cuda", **kw)
    A64 = ops.convection_diffusion_2d(nx, **kw)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        scale=1.0 / h2, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        nx * nx)).to(cuda_device)
    b = A64(ops.pad_grid_vec(x, nx, nx)).float()
    S = F.kron_sketch(A.shape[0], 8 * 41, seed=torch.Generator(
        device=cuda_device).manual_seed(17))
    assert S.S1.device == cuda_device
    for r in (F.sketched_gmres(A, b, M=M, tol=1e-4, maxiter=40, sketch=S),
              F.restarted_sketched_gmres(A, b, M=M, tol=1e-4, maxiter=2,
                                         max_restarts=8, sketch=S)):
        assert r.converged and float(r.distortion) < 4.0
        rel = torch.linalg.vector_norm(b.double() - A64(r.x.double())) / \
            torch.linalg.vector_norm(b.double())
        assert float(rel) <= 1e-4
    v0 = ops.pad_grid_vec(torch.cos(torch.arange(
        nx * nx, dtype=torch.float64, device=cuda_device) * 0.7391) + 0.01,
        nx, nx).float()
    e = F.sketched_eigs(A, k=4, v0=v0, maxiter=80, seed=torch.Generator(
        device=cuda_device).manual_seed(17))
    for j in range(4):
        u = e.U[:, j].to(torch.complex128)
        u = u / torch.linalg.vector_norm(u)
        Au = torch.complex(A64(u.real.contiguous()),
                           A64(u.imag.contiguous()))
        res = float(torch.linalg.vector_norm(Au - e.theta[j].item() * u)) \
            / abs(e.theta[j].item())
        assert abs(res - float(e.pair_resnorms[j])) <= 1e-2 * res


def _sstep_cases(device):
    """The s-step lane's solves on ``device`` (float64 on a dense
    nonsymmetric matrix and the 63^2 Poisson with its V-cycle), keyed by
    name: each returns its result."""
    r = np.random.RandomState(0)
    A = np.diag(np.linspace(1, 10, 80)) + 0.1 * r.randn(80, 80)
    Q, _ = np.linalg.qr(r.randn(80, 80))
    S = Q @ np.diag(np.linspace(1, 50, 80)) @ Q.T
    b = r.randn(80)
    At, St, bt = (torch.tensor(v, device=device) for v in (A, S, b))
    lap = ops.poisson_2d(63, device=device)
    Mg = ops.multigrid_poisson_preconditioner(63, coarsest=7, device=device)
    ones = torch.ones(63 * 63, dtype=torch.float64, device=device)
    ev = np.linalg.eigvals(A)
    return {
        "ca_cg": lambda: F.ca_cg(St, bt, s=4, tol=1e-10, maxiter=400),
        "ca_cg_vcycle": lambda: F.ca_cg(lap, ones, s=4, M=Mg, tol=1e-10,
                                        maxiter=64),
        "monomial": lambda: F.ca_gmres(At, bt, s=4, tol=1e-12, maxiter=60),
        "newton": lambda: F.ca_gmres(At, bt, s=4, basis="newton", tol=1e-12,
                                     maxiter=60),
        "chebyshev": lambda: F.ca_gmres(At, bt, s=8, basis="chebyshev",
                                        shifts=ev, tol=1e-12, maxiter=60),
        "vcycle": lambda: F.ca_gmres(lap, ones, s=4, Ml=Mg, tol=1e-10,
                                     maxiter=64),
        "restarted": lambda: F.restarted_ca_gmres(
            At, bt, s=4, maxiter=12, max_restarts=10, tol=1e-10),
    }


@pytest.mark.parametrize("name", ["ca_cg", "ca_cg_vcycle", "monomial",
                                  "newton", "chebyshev", "vcycle",
                                  "restarted"])
def test_sstep_lane_on_the_card_matches_its_cpu_run(cuda_device, name):
    """Each s-step solve on CUDA tensors against the same solve on the
    CPU, float64: counts and statuses equal, iterates to ``1e-9`` of
    their largest entry, histories to ``1e-9`` absolute (cuBLAS and the
    CPU's BLAS sum in other orders; the s-step blocks carry a few hundred
    ulps each), the result on the card."""
    got = _sstep_cases(cuda_device)[name]()
    want = _sstep_cases("cpu")[name]()
    assert got.x.device == cuda_device
    assert int(got.niter) == int(want.niter)
    assert int(got.status) == int(want.status) == F.CONVERGED
    xw = want.x.numpy()
    np.testing.assert_allclose(got.x.cpu().numpy(), xw, rtol=0,
                               atol=1e-9 * np.abs(xw).max())
    np.testing.assert_allclose(got.resnorms.cpu().numpy(),
                               want.resnorms.numpy(), rtol=0, atol=1e-9)


def test_newton_shifts_on_the_card(cuda_device):
    r = np.random.RandomState(11)
    A = np.diag(np.linspace(1, 10, 80)) + 0.05 * r.randn(80, 80)
    b = r.randn(80)
    got = F.newton_shifts(torch.tensor(A, device=cuda_device),
                          torch.tensor(b, device=cuda_device), 4)
    want = F.newton_shifts(torch.tensor(A), torch.tensor(b), 4)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    # a numpy right-hand side goes to the card
    res = F.ca_gmres(torch.tensor(A, device=cuda_device), b, s=4,
                     maxiter=8)
    assert res.x.device.type == "cuda"


def test_sstep_on_the_card_through_the_kernels(cuda_device):
    """``ca_cg`` with the padded V-cycle and ``ca_gmres`` (Newton) on the
    north star's operator at 255^2 through K1-K3, float32: one K1 per
    operator application and per V-cycle level, converged to the float32
    tolerance in float64."""
    nx = 255
    A = ops.poisson_2d(nx, pad_cols=True, impl="cuda", device=cuda_device)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        device=cuda_device)
    A64 = ops.poisson_2d(nx, device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        nx * nx)).to(cuda_device)
    b = ops.pad_grid_vec(A64(x), nx, nx).float()
    calls = {"A": 0, "M": 0}

    def Ac(v):
        calls["A"] += 1
        return A(v)

    def Mc(v):
        calls["M"] += 1
        return M(v)

    kernels.reset_launch_counts()
    r = F.ca_cg(Ac, b, s=4, M=Mc, tol=1e-5, maxiter=40)
    launches = kernels.launch_counts()
    assert r.converged and r.x.dtype == torch.float32
    # 255^2 has one kernel level of the padded V-cycle above its coarse
    # form: K1 twice, K2 and K3 once, the coarse form once per V-cycle
    assert launches["stencil5_coarse"] == calls["M"]
    assert launches["stencil5_affine"] >= calls["A"]
    xs = ops.unpad_grid_vec(r.x, nx, nx).double()
    bs = ops.unpad_grid_vec(b, nx, nx).double()
    assert float(torch.linalg.vector_norm(bs - A64(xs))
                 / torch.linalg.vector_norm(bs)) <= 1e-4
    h2 = 1.0 / (nx + 1) ** 2
    cd = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                     pad_cols=True, impl="cuda",
                                     device=cuda_device)
    Ml = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl="cuda",
        scale=1.0 / h2, device=cuda_device)
    rhs = ops.pad_grid_vec(torch.ones(nx * nx, device=cuda_device), nx, nx)
    g = F.ca_gmres(cd, rhs, s=8, basis="newton", Ml=Ml, tol=1e-4, maxiter=48)
    assert g.converged and bool(torch.isfinite(g.x).all())


def test_gallery_on_the_card_matches_its_cpu_build(cuda_device):
    """The five constructors on the card against their CPU builds: the
    polynomial preconditioner's roots (float64 Arnoldi on cuBLAS) and
    action, the CSR and DIA products (DIA bit for bit: scipy's sums in
    its order), the block-Jacobi and SPAI applications."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n = 300
    Am = np.diag(np.linspace(1.0, 50.0, n)) + 0.3 * rng.standard_normal(
        (n, n)) / np.sqrt(n)
    seed = rng.standard_normal(n)
    Pg = ops.gmres_polynomial_preconditioner(
        torch.tensor(Am, device=cuda_device), 8,
        seed=torch.tensor(seed, device=cuda_device))
    Pc = ops.gmres_polynomial_preconditioner(torch.tensor(Am), 8,
                                             seed=torch.tensor(seed))
    np.testing.assert_allclose(Pg.roots, Pc.roots, rtol=1e-9,
                               atol=1e-9 * np.abs(Pc.roots).max())
    v = rng.standard_normal(n)
    np.testing.assert_allclose(
        Pg(torch.tensor(v, device=cuda_device)).cpu().numpy(),
        Pc(torch.tensor(v)).numpy(), rtol=1e-10, atol=1e-12)
    N = 4096
    rows = np.repeat(np.arange(N), 6)
    cols = (rows + rng.integers(1, 24, rows.size)) % N
    W = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)),
                      shape=(N, N))
    A = (sp.diags(np.asarray(W.sum(axis=1)).ravel() + 1.0) - W).tocsr()
    x = rng.standard_normal(N)
    xg = torch.tensor(x, device=cuda_device)
    dia = ops.dia_from_scipy(A, device=cuda_device)
    assert dia(xg).cpu().numpy().tobytes() == (A @ x).tobytes()
    csr = ops.sparse_from_scipy(A, device=cuda_device)
    np.testing.assert_allclose(csr(xg).cpu().numpy(), A @ x, rtol=0,
                               atol=1e-13 * np.abs(A @ x).max())
    for build in (lambda dev: ops.block_jacobi_preconditioner(A, 32,
                                                              device=dev),
                  lambda dev: ops.spai_preconditioner(A, device=dev)):
        g, c = build(cuda_device), build("cpu")
        np.testing.assert_allclose(g(xg).cpu().numpy(),
                                   c(torch.tensor(x)).numpy(), rtol=1e-12,
                                   atol=1e-14)
    # from scipy with no device given: on the card
    assert ops.block_jacobi_preconditioner(A, 32).blocks.is_cuda
    assert ops.spai_preconditioner(A).dia_data.is_cuda


def test_new_entry_points_raise_where_the_operator_cannot_run(cuda_device):
    """A CUDA call whose operator lives on the CPU raises (a device
    mismatch) instead of falling back to the CPU."""
    import scipy.sparse as sp

    A = sp.diags([np.full(64, 4.0), -np.ones(63), -np.ones(63)],
                 [0, 1, -1]).tocsr()
    b = torch.ones(64, dtype=torch.float64, device=cuda_device)
    cpu_ops = {"dia": ops.dia_from_scipy(A, device="cpu"),
               "csr": ops.sparse_from_scipy(A, device="cpu")}
    for op in cpu_ops.values():
        for call in (lambda: F.ca_cg(op, b, maxiter=8),
                     lambda: F.ca_gmres(op, b, maxiter=8),
                     lambda: F.restarted_ca_gmres(op, b, maxiter=8),
                     lambda: F.newton_shifts(op, b, 2)):
            with pytest.raises(RuntimeError):
                call()
        with pytest.raises(RuntimeError):
            ops.gmres_polynomial_preconditioner(op, 4, seed=b)
    M = ops.block_jacobi_preconditioner(A, 16, device="cpu")
    with pytest.raises(RuntimeError):
        M(b)
    S = ops.spai_preconditioner(A, device="cpu")
    with pytest.raises(RuntimeError):
        S(b)
