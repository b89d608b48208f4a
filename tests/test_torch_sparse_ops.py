"""The port's unstructured gallery (``krypy_tpu_torch.ops``:
``sparse_from_scipy``, ``dia_from_scipy``, ``spai_preconditioner``,
``block_jacobi_preconditioner``) against the JAX package on the CPU, on
the gallery half of tests/test_preconditioners.py and
tests/test_coercion.py's BCOO solve (their sharded cases run in
tests/test_torch_parallel.py), float64.

Tolerances: the built matrices equal to the bit (the DIA layout, the
block-Jacobi inverses and the SPAI matrix are the same host numpy in
both packages, and cross by ``interop``); the DIA product equal to
scipy's to the bit (ascending-offset accumulation); the CSR product to
``1e-14`` of its largest entry; solves: counts and statuses equal,
iterates to ``1e-10`` of their largest entry; then each reference case's
own assertions on the port's objects.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krypy_tpu_torch import functional as F, interop, ops

jax = pytest.importorskip("jax")
jnp = jax.numpy

X_RTOL = 1e-10


def _J():
    from krypy_tpu import functional as JF, ops as jops

    return JF, jops


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _hold_solve(got, want):
    assert int(got.niter) == int(want.niter)
    assert int(got.status) == int(want.status)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(_np(got.x), xw, rtol=0,
                               atol=X_RTOL * np.abs(xw).max())


def _graph_laplacian(N=2000, band=40, deg=8, seed=11):
    """tests/test_preconditioners.py's irregular SPD graph Laplacian."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N), deg)
    cols = (rows + rng.integers(1, band, size=rows.size)) % N
    W = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)),
                      shape=(N, N))
    W = W + W.T
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    return (L + 1e-2 * sp.eye(N)).tocsr()


def _nonsym_graph_operator(N=2048, seed=3):
    """tests/test_preconditioners.py's convection-dominated graph
    operator."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(N), 6)
    cols = (rows + rng.integers(1, 24, rows.size)) % N
    W = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)),
                      shape=(N, N))
    deg = np.asarray(W.sum(axis=1)).ravel() + np.asarray(
        W.sum(axis=0)).ravel()
    return (sp.diags(deg) - 1.7 * W - 0.3 * W.T + 0.5 * sp.eye(N)).tocsr()


def _poisson_csr(n):
    return sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1]).tocsr()


def test_bcoo_functional_solve_as_jax():
    """tests/test_coercion.py:54: CG on the CSR operator."""
    JF, jops = _J()
    A = _poisson_csr(64)
    want = jax.jit(lambda v: JF.cg(jops.sparse_from_scipy(A), v, tol=1e-10,
                                   maxiter=200))(jnp.ones(64))
    mv = ops.sparse_from_scipy(A, device="cpu")
    res = F.cg(mv, torch.ones(64, dtype=torch.float64), tol=1e-10,
               maxiter=200)
    _hold_solve(res, want)
    assert int(res.status) == F.CONVERGED
    np.testing.assert_allclose(A @ _np(res.x), np.ones(64), atol=1e-8)


def test_sparse_from_scipy_product_diag_and_read_back():
    """The CSR product against scipy and the JAX BCOO product, ``.diag``,
    ``.shape``, the device CSR read back by ``interop.sparse_to_numpy``
    (as the JAX package reads ``.bcoo``), and a float32 vector promoted
    as jnp promotes it."""
    _, jops = _J()
    A = _graph_laplacian(N=333)
    mv = ops.sparse_from_scipy(A, device="cpu")
    x = np.random.default_rng(1).standard_normal(333)
    want = np.asarray(jops.sparse_from_scipy(A)(jnp.asarray(x)))
    got = _np(mv(_t(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())
    np.testing.assert_allclose(got, A @ x, rtol=0,
                               atol=1e-14 * np.abs(want).max())
    np.testing.assert_array_equal(_np(mv.diag), A.diagonal())
    assert mv.shape == (333, 333)
    back = interop.sparse_to_numpy(mv)
    assert (back != A).nnz == 0
    assert mv(_t(x).float()).dtype == torch.float64


def test_block_jacobi_exact_block_solves_as_jax():
    _, jops = _J()
    A = _graph_laplacian(N=333)
    Mj = jops.block_jacobi_preconditioner(A, block_size=40)
    M = ops.block_jacobi_preconditioner(A, block_size=40, device="cpu")
    np.testing.assert_array_equal(interop.block_jacobi_to_numpy(M),
                                  np.asarray(Mj.blocks))
    assert M.block_size == 40 and M.shape == (333, 333)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(333)
    Ad = A.toarray()
    ref = np.zeros(333)
    for i in range(0, 333, 40):
        j = min(i + 40, 333)
        ref[i:j] = np.linalg.solve(Ad[i:j, i:j], x[i:j])
    np.testing.assert_allclose(_np(M(_t(x))), ref, rtol=1e-12)
    np.testing.assert_allclose(_np(M(_t(x))), np.asarray(Mj(jnp.asarray(x))),
                               rtol=1e-13)
    Mx = interop.block_jacobi_from_numpy(Mj.blocks, 333, device="cpu")
    np.testing.assert_array_equal(_np(Mx(_t(x))), _np(M(_t(x))))


def test_block_jacobi_accepts_csr_matvec_and_beats_jacobi_as_jax():
    JF, jops = _J()
    A = _graph_laplacian()
    Aj = jops.sparse_from_scipy(A)
    Mjj = jops.jacobi_preconditioner(Aj)
    Mbj = jops.block_jacobi_preconditioner(Aj, block_size=40)
    bj = jnp.ones(A.shape[0])
    want = {
        "cg_j": jax.jit(lambda v: JF.cg(Aj, v, M=Mjj, tol=1e-8,
                                        maxiter=2000))(bj),
        "cg_bj": jax.jit(lambda v: JF.cg(Aj, v, M=Mbj, tol=1e-8,
                                         maxiter=2000))(bj),
        "gm_bj": jax.jit(lambda v: JF.gmres(Aj, v, Mr=Mbj, tol=1e-8,
                                            maxiter=400))(bj),
        "gm_j": jax.jit(lambda v: JF.gmres(Aj, v, Mr=Mjj, tol=1e-8,
                                           maxiter=400))(bj)}
    Amv = ops.sparse_from_scipy(A, device="cpu")
    Mj = ops.jacobi_preconditioner(Amv)
    Mb = ops.block_jacobi_preconditioner(Amv, block_size=40)
    assert Mb.blocks.device.type == "cpu"
    np.testing.assert_array_equal(_np(Mb.blocks), np.asarray(Mbj.blocks))
    b = torch.ones(A.shape[0], dtype=torch.float64)
    got = {"cg_j": F.cg(Amv, b, M=Mj, tol=1e-8, maxiter=2000),
           "cg_bj": F.cg(Amv, b, M=Mb, tol=1e-8, maxiter=2000),
           "gm_bj": F.gmres(Amv, b, Mr=Mb, tol=1e-8, maxiter=400),
           "gm_j": F.gmres(Amv, b, Mr=Mj, tol=1e-8, maxiter=400)}
    for k in want:
        _hold_solve(got[k], want[k])
    assert got["cg_j"].converged and got["cg_bj"].converged
    assert int(got["cg_bj"].niter) < int(got["cg_j"].niter)
    assert int(got["gm_bj"].niter) < int(got["gm_j"].niter)


def test_block_jacobi_singular_block_shift_as_jax():
    _, jops = _J()
    d = np.r_[np.zeros(4), np.linspace(1, 2, 28)]
    A = sp.diags(d).tocsr()
    Mj = jops.block_jacobi_preconditioner(A, block_size=4, shift=1e-3)
    M = ops.block_jacobi_preconditioner(A, block_size=4, shift=1e-3,
                                        device="cpu")
    y = _np(M(torch.ones(32, dtype=torch.float64)))
    assert np.all(np.isfinite(y))
    np.testing.assert_array_equal(_np(M.blocks), np.asarray(Mj.blocks))
    np.testing.assert_allclose(y, np.asarray(Mj(jnp.ones(32))), rtol=1e-14)


def test_block_jacobi_dense_input_as_jax():
    """A dense operator (numpy array, or a tensor) gives the same blocks
    as the JAX package's dense path."""
    _, jops = _J()
    A = _graph_laplacian(N=100).toarray()
    Mj = jops.block_jacobi_preconditioner(A, block_size=16)
    for src in (A, _t(A)):
        M = ops.block_jacobi_preconditioner(src, block_size=16, device="cpu")
        np.testing.assert_array_equal(_np(M.blocks), np.asarray(Mj.blocks))


def test_dia_from_scipy_exact_as_jax():
    """tests/test_preconditioners.py:274 on one device: the DIA product is
    scipy's to the bit, the layout the JAX package's (and crossing from
    it by ``interop.dia_from_numpy`` gives the same bits), ``.diag``,
    and block-Jacobi CG through ``.scipy_matrix``."""
    JF, jops = _J()
    A = _graph_laplacian(N=4096)
    Aj = jops.dia_from_scipy(A)
    Amv = ops.dia_from_scipy(A, device="cpu")
    np.testing.assert_array_equal(_np(Amv.dia_data), np.asarray(Aj.dia_data))
    np.testing.assert_array_equal(Amv.offsets, Aj.offsets)
    x = np.random.default_rng(3).standard_normal(4096)
    y = _np(Amv(_t(x)))
    assert float(np.abs(y - A @ x).max()) == 0.0
    np.testing.assert_array_equal(y, np.asarray(Aj(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(Amv.diag), A.diagonal())
    assert Amv.shape == (4096, 4096) and Amv.scipy_matrix is A
    Ax = interop.dia_from_numpy(Aj.dia_data, Aj.offsets, device="cpu")
    np.testing.assert_array_equal(_np(Ax(_t(x))), y)
    Mbj = jops.block_jacobi_preconditioner(Aj, block_size=32)
    want = jax.jit(lambda v: JF.cg(Aj, v, M=Mbj, tol=1e-8,
                                   maxiter=500))(jnp.ones(4096))
    M = ops.block_jacobi_preconditioner(Amv, block_size=32)
    r = F.cg(Amv, torch.ones(4096, dtype=torch.float64), M=M, tol=1e-8,
             maxiter=500)
    _hold_solve(r, want)
    assert r.converged


def test_dia_from_scipy_wraparound_and_guard_as_jax():
    _, jops = _J()
    n = 64
    A = sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1),
                  [-1.0], [-1.0]], [0, 1, -1, n - 1, -(n - 1)]).tocsr()
    Amv = ops.dia_from_scipy(A, device="cpu")
    x = np.random.default_rng(0).standard_normal(n)
    y = _np(Amv(_t(x)))
    assert float(np.abs(y - A @ x).max()) < 1e-14
    np.testing.assert_array_equal(y, np.asarray(
        jops.dia_from_scipy(A)(jnp.asarray(x))))
    dense = sp.random(256, 256, 0.4, random_state=0)
    for pkg, kw in ((jops, {}), (ops, {"device": "cpu"})):
        with pytest.raises(ValueError, match="max_diags"):
            pkg.dia_from_scipy(dense, max_diags=32, **kw)


def test_dia_duplicates_and_float32_as_jax():
    """A COO matrix with duplicate entries sums them in the JAX package's
    order; a float32 matrix keeps float32, and a float64 matrix promotes
    a float32 vector as jnp does."""
    _, jops = _J()
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 50, 400)
    cols = np.clip(rows + rng.integers(-3, 4, 400), 0, 49)
    A = sp.coo_matrix((rng.standard_normal(400), (rows, cols)),
                      shape=(50, 50))
    assert not A.has_canonical_format
    Aj, Amv = jops.dia_from_scipy(A), ops.dia_from_scipy(A, device="cpu")
    np.testing.assert_array_equal(_np(Amv.dia_data), np.asarray(Aj.dia_data))
    A32 = A.astype(np.float32)
    x32 = rng.standard_normal(50).astype(np.float32)
    np.testing.assert_array_equal(
        _np(ops.dia_from_scipy(A32, device="cpu")(_t(x32))),
        np.asarray(jops.dia_from_scipy(A32)(jnp.asarray(x32))))
    assert Amv(_t(x32)).dtype == torch.float64


def test_spai_exact_on_representable_inverses_as_jax():
    _, jops = _J()
    d = np.linspace(1.0, 5.0, 50)
    M = ops.spai_preconditioner(sp.diags(d).tocsr(), device="cpu")
    Mj = jops.spai_preconditioner(sp.diags(d).tocsr())
    assert M.spai_residual < 1e-10
    assert M.spai_residual == Mj.spai_residual
    x = np.random.default_rng(0).standard_normal(50)
    np.testing.assert_allclose(_np(M(_t(x))), x / d, rtol=1e-10)
    C = sp.diags(d[:32]).tocsr().astype(np.complex128) + 2j * sp.eye(32)
    Mc = ops.spai_preconditioner(C, device="cpu")
    assert Mc.spai_residual < 1e-10
    assert Mc.spai_residual == jops.spai_preconditioner(C).spai_residual
    z = x[:32] + 1j * x[::-1][:32]
    np.testing.assert_allclose(_np(Mc(_t(z))), z / (d[:32] + 2j),
                               rtol=1e-10)


@pytest.fixture(scope="module")
def spai_case():
    """tests/test_preconditioners.py:373's operator, both packages' SPAI
    (pattern A from the DIA matvec, pattern A2 from the matrix) and the
    JAX package's GMRES solves."""
    JF, jops = _J()
    A = _nonsym_graph_operator()
    Aj = jops.dia_from_scipy(A)
    Msj = jops.spai_preconditioner(Aj)
    M2j = jops.spai_preconditioner(A, pattern="A2")
    bj = jnp.ones(A.shape[0])
    kw = dict(tol=1e-8, maxiter=400)
    want = {
        "j": jax.jit(lambda v: JF.gmres(
            Aj, v, Mr=jops.jacobi_preconditioner(Aj), **kw))(bj),
        "s": jax.jit(lambda v: JF.gmres(Aj, v, Mr=Msj, **kw))(bj),
        "2": jax.jit(lambda v: JF.gmres(Aj, v, Mr=M2j, **kw))(bj)}
    return A, Msj, M2j, want


def test_spai_matrices_match_jax(spai_case):
    A, Msj, M2j, _ = spai_case
    Amv = ops.dia_from_scipy(A, device="cpu")
    Ms = ops.spai_preconditioner(Amv)
    M2 = ops.spai_preconditioner(A, pattern="A2", device="cpu")
    for got, want in ((Ms, Msj), (M2, M2j)):
        g, w = interop.sparse_to_numpy(got), want.scipy_matrix.tocsr()
        assert (g != w).nnz == 0
        assert got.spai_residual == want.spai_residual
        np.testing.assert_array_equal(_np(got.dia_data),
                                      np.asarray(want.dia_data))
    assert 0 < M2.spai_residual < Ms.spai_residual < 1


def test_spai_beats_jacobi_on_nonsymmetric_unstructured_as_jax(spai_case):
    A, _, _, want = spai_case
    Amv = ops.dia_from_scipy(A, device="cpu")
    Ms = ops.spai_preconditioner(Amv)
    M2 = ops.spai_preconditioner(A, pattern="A2", device="cpu")
    b = torch.ones(A.shape[0], dtype=torch.float64)
    kw = dict(tol=1e-8, maxiter=400)
    got = {"j": F.gmres(Amv, b, Mr=ops.jacobi_preconditioner(Amv), **kw),
           "s": F.gmres(Amv, b, Mr=Ms, **kw),
           "2": F.gmres(Amv, b, Mr=M2, **kw)}
    for k in want:
        _hold_solve(got[k], want[k])
    gj, gs, g2 = got["j"], got["s"], got["2"]
    assert gs.converged and g2.converged
    assert int(gs.niter) < 0.7 * int(gj.niter)
    assert int(g2.niter) < int(gs.niter)
    x = _np(gs.x)
    assert np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0]) <= 1e-7


def test_spai_format_and_validation_as_jax():
    _, jops = _J()
    A = _nonsym_graph_operator(N=512)
    Mb = ops.spai_preconditioner(A, format="bcoo", device="cpu")
    Mc = ops.spai_preconditioner(A, format="csr", device="cpu")
    Md = ops.spai_preconditioner(A, format="dia", device="cpu")
    assert hasattr(Mb, "csr") and hasattr(Md, "dia_data")
    x = np.random.default_rng(1).standard_normal(512)
    np.testing.assert_allclose(_np(Mb(_t(x))), _np(Md(_t(x))), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(_np(Mb(_t(x))), _np(Mc(_t(x))))
    np.testing.assert_array_equal(
        _np(Md(_t(x))),
        np.asarray(jops.spai_preconditioner(A, format="dia")(jnp.asarray(x))))
    with pytest.raises(ValueError, match="pattern"):
        ops.spai_preconditioner(A, pattern="bogus", device="cpu")
    with pytest.raises(ValueError, match="format"):
        ops.spai_preconditioner(A, format="bogus", device="cpu")
    Mdense = ops.spai_preconditioner(np.diag(np.arange(1.0, 9.0)),
                                     device="cpu")
    assert Mdense.spai_residual < 1e-10
    assert Mdense.spai_residual == jops.spai_preconditioner(
        np.diag(np.arange(1.0, 9.0))).spai_residual


def test_gallery_constructors_go_to_the_card():
    """From scipy (nothing on a device) the constructors build on
    ``"cuda"``: where torch sees no card they raise, never build on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the operators go there")
    A = _poisson_csr(16)
    for build in (lambda: ops.sparse_from_scipy(A),
                  lambda: ops.dia_from_scipy(A),
                  lambda: ops.spai_preconditioner(A),
                  lambda: ops.block_jacobi_preconditioner(A, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
