"""The port's prefix-sweep CGS2 kernels (krypy_tpu_torch.kernels.
orthogonalize) against the JAX package's Pallas kernels, run in interpret
mode, on the same numpy inputs.

On CPU tensors the port's wrappers run their plain versions, so this holds
the arithmetic the CUDA kernels are checked against on the card.

Tolerances.  float64: ``atol=1e-10``, as tests/test_kernels.py holds the
Pallas kernels.  float32: the first-order worst-case rounding bound of
each output, doubled because both sides round: a length-n sum is off by
at most ``n * eps * sum|terms|``, so a projection over N columns gets
``2 N eps (|V| @ |x|)`` and an update over ``rows`` basis rows gets
``2 (rows + 1) eps (|w| + |c| @ |V|)``; an input that already differs
(the second pass reads the first pass's output) carries its own bound
through ``|V|``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu.kernels import orthogonalize as jorth
from krypy_tpu_torch import interop
from krypy_tpu_torch.kernels import orthogonalize as orth

torch.set_num_threads(1)

# (m, N, rows, k): the two shapes of tests/test_kernels.py, a ragged N,
# and the basis of a GMRES(25) cycle (26 rows) at its first, middle and
# last prefix; rows past k carry a zero mask
SHAPES = [
    (9, 256, 8, 5),
    (17, 1024, 16, 11),
    (5, 1000, 5, 2),
    (26, 8192, 1, 0),
    (26, 8192, 13, 10),
    (26, 8192, 26, 23),
]
DTYPES = [np.float64, np.float32]


def _inputs(m, N, k, dtype, seed):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((m, N)).astype(dtype)
    w = rng.standard_normal(N).astype(dtype)
    c = rng.standard_normal(m).astype(dtype)
    mask = (np.arange(m) <= k).astype(dtype)
    return V, w, c, mask


def _t(a):
    return interop.from_numpy(a, "cpu")


def _proj_tol(V, x, dx, eps):
    """Bound on |conj(V) x| computed by both sides, x known to +-dx."""
    A = np.abs(V).astype(np.float64)
    dx = np.broadcast_to(np.asarray(dx, np.float64), (V.shape[1],))
    return A @ dx + 2 * V.shape[1] * eps * (A @ np.abs(x))


def _upd_tol(V, w, dw, c, dc, eps):
    """Bound on w - c^T V computed by both sides (rows = len(c))."""
    A = np.abs(V).astype(np.float64)
    dc = np.broadcast_to(np.asarray(dc, np.float64), (len(c),))
    return (dw + dc @ A
            + 2 * (len(c) + 1) * eps * (np.abs(w) + np.abs(c) @ A))


def _close(got, want, tol, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    else:
        assert np.all(np.abs(got - want) <= tol), \
            float(np.max(np.abs(got - want) - tol))


def _case(shape, dtype):
    m, N, rows, k = shape
    V, w, c, mask = _inputs(m, N, k, dtype, seed=m * N + rows)
    eps = float(np.finfo(np.float32).eps)
    return m, N, rows, V, w, c, mask, eps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_project_prefix_matches_jax(shape, dtype):
    m, N, rows, V, w, c, mask, eps = _case(shape, dtype)
    want = np.asarray(jorth.project_prefix(
        jnp.asarray(V), jnp.asarray(w), jnp.asarray(mask), rows=rows,
        interpret=True))
    got = interop.to_numpy(orth.project_prefix(_t(V), _t(w), _t(mask),
                                               rows=rows))
    assert got.dtype == dtype and got.shape == (m,)
    # the contract of tests/test_kernels.py: exact zeros past rows, and
    # at every masked row
    assert np.all(got[rows:] == 0.0) and np.all(want[rows:] == 0.0)
    assert np.all(got[mask == 0] == 0.0)
    tol = _proj_tol(V[:rows], w, 0.0, eps)
    _close(got[:rows], want[:rows], tol, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_project_matches_jax(shape, dtype):
    m, N, rows, V, w, c, mask, eps = _case(shape, dtype)
    w1j, c2j = jorth.apply_project(
        jnp.asarray(V), jnp.asarray(w), jnp.asarray(c), jnp.asarray(mask),
        rows=rows, interpret=True)
    w1, c2 = orth.apply_project(_t(V), _t(w), _t(c), _t(mask), rows=rows)
    w1, c2 = interop.to_numpy(w1), interop.to_numpy(c2)
    assert w1.dtype == dtype and c2.shape == (m,)
    assert np.all(c2[rows:] == 0.0) and np.all(c2[mask == 0] == 0.0)
    tol_w1 = _upd_tol(V[:rows], w, 0.0, c[:rows], 0.0, eps)
    _close(w1, w1j, tol_w1, dtype)
    tol_c2 = _proj_tol(V[:rows], w1.astype(np.float64), tol_w1, eps)
    _close(c2[:rows], np.asarray(c2j)[:rows], tol_c2, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_update_prefix_matches_jax(shape, dtype):
    m, N, rows, V, w, c, mask, eps = _case(shape, dtype)
    want = jorth.update_prefix(jnp.asarray(V), jnp.asarray(w),
                               jnp.asarray(c), rows=rows, interpret=True)
    got = interop.to_numpy(orth.update_prefix(_t(V), _t(w), _t(c),
                                              rows=rows))
    assert got.dtype == dtype
    _close(got, want, _upd_tol(V[:rows], w, 0.0, c[:rows], 0.0, eps), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_cgs2_fused_matches_jax(shape, dtype):
    """The composition K4 -> K5 -> K6 on a GMRES-like basis (orthonormal
    rows), with each stage's bound carried into the next."""
    m, N, rows, V, w, c, mask, eps = _case(shape, dtype)
    V = np.ascontiguousarray(
        np.linalg.qr(V.T.astype(np.float64))[0].T.astype(dtype))
    wj, cj = jorth.cgs2_fused(jnp.asarray(V), jnp.asarray(w),
                              jnp.asarray(mask), rows=rows, interpret=True)
    w2, coeffs = orth.cgs2_fused(_t(V), _t(w), _t(mask), rows=rows)
    w2, coeffs = interop.to_numpy(w2), interop.to_numpy(coeffs)
    assert w2.dtype == dtype and coeffs.shape == (m,)
    assert np.all(coeffs[rows:] == 0.0)
    Vr, mk = V[:rows], mask[:rows]
    c1 = interop.to_numpy(orth.project_prefix(_t(V), _t(w), _t(mask),
                                              rows=rows))[:rows]
    t_c1 = _proj_tol(Vr, w, 0.0, eps) * mk
    w1 = w - c1.astype(np.float64) @ Vr
    t_w1 = _upd_tol(Vr, w, 0.0, c1, t_c1, eps)
    c2 = (Vr.astype(np.float64) @ w1) * mk
    t_c2 = _proj_tol(Vr, w1, t_w1, eps) * mk
    t_w2 = _upd_tol(Vr, w1, t_w1, c2, t_c2, eps)
    _close(w2, wj, t_w2, dtype)
    _close(coeffs[:rows], np.asarray(cj)[:rows], t_c1 + t_c2, dtype)
    if dtype == np.float64:
        # two passes leave w2 orthogonal to the active rows
        assert np.max(np.abs(Vr[mk == 1] @ w2)) <= 1e-12 * np.linalg.norm(w)


def test_wrappers_reject_bad_operands():
    V = torch.zeros(4, 16, dtype=torch.float64)
    w, mask = torch.zeros(16, dtype=torch.float64), torch.ones(4)
    with pytest.raises(ValueError):
        orth.project_prefix(V, w, mask, rows=5)
    with pytest.raises(ValueError):
        orth.project_prefix(V, w, mask, rows=0)
    with pytest.raises(ValueError):
        orth.project_prefix(V, w[:-1], mask)
    with pytest.raises(ValueError):
        orth.update_prefix(V, w.float(), mask.double())
    with pytest.raises(ValueError):
        orth.update_prefix(V.t().contiguous().t(), w, mask.double())
    with pytest.raises(ValueError):
        orth.project_prefix(V[0], w, mask)


def test_cpu_path_counts_no_launch():
    """The plain versions on CPU tensors are not kernel launches."""
    from krypy_tpu_torch import kernels

    kernels.reset_launch_counts()
    V = torch.ones(3, 64, dtype=torch.float32)
    orth.cgs2_fused(V, torch.ones(64), torch.ones(3), rows=2)
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("rows,itemsize,threads",
                         [(26, 4, 256), (26, 8, 256), (200, 8, 64),
                          (800, 8, 32)])
def test_launch_config(rows, itemsize, threads):
    """K4's grid is one block per contiguous range of ``THREADS *
    GROUPS_PER_THREAD`` 16-byte column groups; K6's is capped at a fixed
    block count (so the reduction order depends on N alone); K5 halves
    its threads while its staged column tile exceeds the shared-memory
    budget; a prefix past ``max_rows`` raises."""
    N = 4096 * 4096
    per_block = orth.THREADS * orth.GROUPS_PER_THREAD * (16 // itemsize)
    assert orth.launch_config(N, rows, itemsize, "project_prefix") == (
        N // per_block, 256)
    assert orth.launch_config(300, rows, itemsize, "project_prefix") == (
        1, 256)
    assert orth.launch_config(N, rows, itemsize, "update_prefix") == (
        orth.MAX_BLOCKS, 256)
    assert orth.launch_config(300, rows, itemsize, "update_prefix") == (
        2, 256)
    assert orth.launch_config(N, rows, itemsize, "apply_project")[1] == \
        threads
    with pytest.raises(ValueError):
        orth.launch_config(N, 1000, 8, "apply_project")
    # every kernel launches at max_rows, and K5 raises one row past it;
    # K4 keeps no per-row shared memory and has no limit
    for isz in (4, 8):
        top = orth.max_rows(isz)
        for kernel in ("project_prefix", "apply_project", "update_prefix"):
            orth.launch_config(N, top, isz, kernel)
        with pytest.raises(ValueError, match="max|rows"):
            orth.launch_config(N, top + 1, isz, "apply_project")
        assert orth.max_rows(isz, "project_prefix") is None
        orth.launch_config(N, 10 ** 6, isz, "project_prefix")


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N", [1, 37, 4095, 4096, 8191, 20003, 600001,
                               4096 ** 2, 4096 ** 2 // 4 + 1])
def test_project_grid_depends_on_the_shape_only(N, itemsize):
    """K4's grid and row chunk are functions of (N, rows, dtype) alone:
    the blocks' equal shares of the 16-byte column groups (as the kernel
    computes them from the grid) are non-empty, contiguous and cover N
    exactly once, each at most ``GROUPS_PER_THREAD`` groups a thread; the
    chunk is the smallest that holds the prefix, else the largest."""
    for rows in (1, 8, 9, 16, 17, 26, 32, 33, 65, 1709):
        blocks, threads = orth.launch_config(N, rows, itemsize,
                                             "project_prefix")
        assert (blocks, threads) == orth.launch_config(
            N, 1, itemsize, "project_prefix")
        assert (blocks, threads) == orth.launch_config(
            N, rows, itemsize, "cgs_project")
        groups = -(-N * itemsize // 16)
        span = -(-groups // blocks)
        ranges = [(b * span, min(groups, (b + 1) * span))
                  for b in range(blocks)]
        assert all(lo < hi for lo, hi in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == groups
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert span <= threads * orth.GROUPS_PER_THREAD
        chunk = orth.row_chunk(rows)
        assert chunk in orth.ROW_CHUNKS
        assert chunk == (min(c for c in orth.ROW_CHUNKS if c >= rows)
                         if rows <= max(orth.ROW_CHUNKS)
                         else max(orth.ROW_CHUNKS))


def test_row_limits_do_not_fall():
    """The tallest prefixes the kernels take are no lower than before the
    redesign of K4: 1709 float32 / 854 float64 rows for the three prefix
    sweeps together, 7264 / 3632 for K7."""
    assert orth.max_rows(4) >= 1709 and orth.max_rows(8) >= 854
    assert orth.max_rows(4, "cgs_project") >= 7264
    assert orth.max_rows(8, "cgs_project") >= 3632
    for isz, kernel in ((4, "apply_project"), (8, "apply_project"),
                        (4, "cgs_project"), (8, "cgs_project")):
        top = orth.max_rows(isz, kernel)
        orth.launch_config(4096 ** 2, top, isz, kernel)
        with pytest.raises(ValueError, match="shared memory"):
            orth.launch_config(4096 ** 2, top + 1, isz, kernel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prefix_check_passes_reordered_sums_and_rejects_faults(dtype):
    """The card's parity check of K4-K6 (``kernels.parity.PrefixCheck``)
    on the CPU: the plain versions summed over reversed columns, a sum
    order as far from the plain one as a kernel's, pass; every planted
    fault (6, and 2 float32 sums in float64) fails."""
    from krypy_tpu_torch.kernels.parity import PrefixCheck

    m, N, rows = 26, 1 << 15, 13
    rng = np.random.default_rng(11)
    V = torch.tensor(rng.standard_normal((m, N)) / np.sqrt(N), dtype=dtype)
    w = torch.tensor(rng.standard_normal(N), dtype=dtype)
    c = torch.tensor(rng.standard_normal(m), dtype=dtype)
    mask = (torch.arange(m) < rows - 2).to(dtype)

    def sweeps(V, w):
        return {"project_prefix": (orth.project_prefix_torch(V, w, mask,
                                                             rows),),
                "apply_project": orth.apply_project_torch(V, w, c, mask,
                                                          rows),
                "update_prefix": (orth.update_prefix_torch(V, w, c, rows),)}

    plain = sweeps(V, w)
    flipped = sweeps(V.flip(1).contiguous(), w.flip(0).contiguous())
    w1, c2 = flipped["apply_project"]
    got = dict(flipped, apply_project=(w1.flip(0), c2),
               update_prefix=(flipped["update_prefix"][0].flip(0),))
    check = PrefixCheck(V, w, c, mask, rows, plain)
    assert check.failures(plain) == [] and check.failures(got) == []
    assert check.assert_faults_caught(got) == (
        8 if dtype == torch.float64 else 6)


@pytest.mark.parametrize("entry", ["project_prefix", "apply_project",
                                   "update_prefix", "cgs2_fused",
                                   "cgs_project"])
def test_entries_take_the_jax_keywords(entry):
    """The prefix entries take the JAX package's ``block_n`` (a TPU tile:
    accepted and ignored) and ``interpret`` (True: the plain version); on
    CPU tensors each mode gives the JAX entry's result, interpreted."""
    rng = np.random.default_rng(5)
    m, N, rows = 6, 512, 4
    V = rng.standard_normal((m, N))
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    w = rng.standard_normal(N)
    c = rng.standard_normal(m)
    mask = (np.arange(m) < rows).astype(np.float64)
    j = jnp.asarray
    jax_args = {
        "project_prefix": ((j(V), j(w), j(mask)), dict(rows=rows)),
        "apply_project": ((j(V), j(w), j(c), j(mask)), dict(rows=rows)),
        "update_prefix": ((j(V), j(w), j(c)), dict(rows=rows)),
        "cgs2_fused": ((j(V), j(w), j(mask)), dict(rows=rows)),
        "cgs_project": ((j(V), j(w), j(mask)), {}),
    }[entry]
    want = getattr(jorth, entry)(*jax_args[0], block_n=128, interpret=True,
                                 **jax_args[1])
    t = [interop.from_numpy(np.asarray(a), "cpu") for a in jax_args[0]]
    for it in (False, True):
        got = getattr(orth, entry)(*t, block_n=128, interpret=it,
                                   **jax_args[1])
        for g, wv in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(interop.to_numpy(g), np.asarray(wv),
                                       rtol=0, atol=1e-12)


def test_sharded_entry_checks_axis_name():
    """K9's entry checks ``axis_name`` as ``make_mesh`` does: ``"n"`` or
    None, else ``ValueError``, before any collective."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(size=1, rank=0, device=torch.device("cpu"))
    V = torch.eye(2, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="axis"):
        orth.cgs2_fused_sharded(V, torch.ones(4, dtype=torch.float64),
                                torch.ones(2), mesh=mesh, n=4,
                                axis_name="x", block_n=128)
